"""Synthetic stereo world (twin of legoslam_tpu/pipeline/dataset.py:
`StereoFrame` and `SyntheticPlanesDataset`).

The renderer is NumPy and is the reference's, so a frame renders to the same
bytes in both packages; the rig is the port's `StereoRig` (on the CPU; the
driver moves it to its device).  `KittiDataset` and its native loader are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from legoslam_tpu_torch.geometry.camera import Camera, StereoRig


class StereoFrame(NamedTuple):
    frame_id: int
    left: np.ndarray   # (H, W) float32, 0..255
    right: np.ndarray


def _value_noise(px: np.ndarray, py: np.ndarray, seed: int) -> np.ndarray:
    """Hash-based 2-D value noise with bilinear interpolation, vectorized.

    The lattice hash is the classic fract(sin(dot)) float hash — pure float32
    vector math, ~10x faster in numpy than integer mixing at this call volume.
    """

    def hash01(ix, iy):
        v = np.sin(ix * 12.9898 + iy * 78.233 + seed * 0.6180339887) * 43758.5453
        return v - np.floor(v)

    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = px - x0
    fy = py - y0
    # smoothstep for C1 continuity (KLT needs smooth gradients)
    sx = fx * fx * (3 - 2 * fx)
    sy = fy * fy * (3 - 2 * fy)
    v00 = hash01(x0, y0)
    v10 = hash01(x0 + 1, y0)
    v01 = hash01(x0, y0 + 1)
    v11 = hash01(x0 + 1, y0 + 1)
    return (1 - sx) * (1 - sy) * v00 + sx * (1 - sy) * v10 + (1 - sx) * sy * v01 + sx * sy * v11


def _texture(px: np.ndarray, py: np.ndarray, seed: int) -> np.ndarray:
    """Multi-octave noise texture in [0, 1], sampled at world coordinates."""
    out = np.zeros_like(px, np.float64)
    amp, freq = 0.55, 0.7
    for octave in range(4):
        out += amp * _value_noise(px * freq, py * freq, seed + octave)
        amp *= 0.55
        freq *= 2.7
    return out / 1.0


class SyntheticPlanesDataset:
    """Procedural corridor of textured planes with exact ground truth.

    A ground plane, two side walls, and an end wall, all carrying unique
    multi-octave noise textures parameterized by *world* coordinates — so
    image patches are globally distinctive (no correspondence ambiguity),
    gradients exist everywhere, and every pixel has exact depth.  This is the
    end-to-end regression substrate standing in for KITTI imagery
    (SURVEY section 4: golden-trajectory integration tests).
    """

    def __init__(
        self,
        n_frames: int = 60,
        shape: Tuple[int, int] = (120, 200),
        baseline: float = 0.54,
        focal: float = 180.0,
        speed: float = 0.3,
        curve: float = 0.004,
        seed: int = 0,
        length: float = 120.0,
        half_width: float = 8.0,
        ground_y: float = 1.6,
        z_min: float = -5.0,
        trajectory: Optional[np.ndarray] = None,
        n_occluders: int = 0,
        dynamic_occluders: int = 0,
        photometric_noise: float = 0.0,
        exposure_drift: float = 0.0,
    ):
        """`trajectory`: optional (N, 4, 4) T_wc array overriding the default
        forward-with-yaw path — e.g. an out-and-back loop for loop-closure
        tests (the renderer draws any pose in the corridor world).

        Realism knobs (all default off; KITTI-like nuisance factors the clean
        corridor lacks — VERDICT r3 "validation realism"):
        - `n_occluders`: floating textured rectangles inside the corridor that
          occlude the walls/ground (objects whose depth differs from the
          surface behind them, breaking tracks that slide across edges);
        - `dynamic_occluders`: how many of them additionally MOVE laterally
          over time (independently moving objects violating the static-world
          assumption, like oncoming cars);
        - `photometric_noise`: per-pixel Gaussian intensity noise sigma
          (sensor noise; independent per frame and per camera);
        - `exposure_drift`: sinusoidal per-frame gain amplitude, e.g. 0.15
          for +-15% exposure swings (auto-exposure hunting; the left and
          right camera share each frame's gain, as a real stereo rig does).
        """
        H, W = shape
        self.shape = shape
        if trajectory is not None:
            n_frames = len(trajectory)
        self.n_frames = n_frames
        self.seed = seed
        self.length = length
        self.half_width = half_width
        self.ground_y = ground_y
        # rear extent of the world box: push it far negative for trajectories
        # that look backward (loops); the default matches the forward-driving
        # corridor
        self.z_min = z_min
        self.photometric_noise = photometric_noise
        self.exposure_drift = exposure_drift
        rng_occ = np.random.default_rng(seed * 7919 + 17)
        self.occluders = []
        for k in range(n_occluders):
            # rectangle on a z = const plane facing the camera
            zc = rng_occ.uniform(8.0, max(12.0, length * 0.8))
            xc = rng_occ.uniform(-0.6 * half_width, 0.6 * half_width)
            yc = rng_occ.uniform(-0.5, ground_y - 0.8)
            w = rng_occ.uniform(0.8, 2.5)
            h = rng_occ.uniform(0.8, 2.0)
            vx = rng_occ.uniform(0.02, 0.08) * rng_occ.choice([-1, 1]) \
                if k < dynamic_occluders else 0.0
            self.occluders.append((xc, yc, zc, w, h, vx, 71 + 13 * k))
        right_pose = np.eye(4)
        right_pose[0, 3] = -baseline
        self.rig = StereoRig(
            left=Camera.create(focal, focal, W / 2.0, H / 2.0, baseline),
            right=Camera.create(focal, focal, W / 2.0, H / 2.0, baseline, pose=right_pose),
        )
        if trajectory is not None:
            self.gt_T_wc = np.asarray(trajectory, np.float64)
        else:
            self.gt_T_wc = []
            pos = np.zeros(3)
            yaw = 0.0
            for _ in range(n_frames):
                c, s = np.cos(yaw), np.sin(yaw)
                R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
                T = np.eye(4)
                T[:3, :3] = R
                T[:3, 3] = pos
                self.gt_T_wc.append(T.copy())
                pos = pos + R @ np.array([0.0, 0.0, speed])
                yaw += curve
            self.gt_T_wc = np.stack(self.gt_T_wc)
        self.current_index = 0

    def _render(self, T_wc: np.ndarray, cam, frame_index: int = 0) -> np.ndarray:
        img, _ = self._render_with_depth(T_wc, cam, frame_index)
        return img

    def render_depth(self, frame_index: int, cam=None) -> np.ndarray:
        """Exact per-pixel camera-frame depth (for tests)."""
        cam = cam or self.rig.left
        _, depth = self._render_with_depth(self.gt_T_wc[frame_index], cam, frame_index)
        return depth

    def _render_with_depth(self, T_wc: np.ndarray, cam, frame_index: int = 0):
        H, W = self.shape
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        # Camera center and ray directions in world coordinates.
        T_wcam = T_wc @ np.asarray(
            np.linalg.inv(np.asarray(cam.pose.cpu(), np.float64)), np.float64
        )
        origin = T_wcam[:3, 3]
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], axis=-1)
        d_world = d_cam @ T_wcam[:3, :3].T  # (H, W, 3)

        np.seterr(invalid="ignore")
        best_t = np.full((H, W), np.inf)
        value = np.zeros((H, W))
        # (plane normal axis, plane offset, texture axes, texture seed salt)
        planes = [
            (1, self.ground_y, (0, 2), 11),     # ground y = ground_y
            (0, -self.half_width, (2, 1), 23),  # left wall x = -hw
            (0, self.half_width, (2, 1), 37),   # right wall x = +hw
            (2, self.length, (0, 1), 53),       # end wall z = length
        ]
        for axis, offset, (ta, tb), salt in planes:
            dn = d_world[..., axis]
            safe = np.abs(dn) > 1e-9
            t = np.full_like(dn, np.inf)
            np.divide(offset - origin[axis], dn, out=t, where=safe)
            pts = origin[None, None, :] + t[..., None] * d_world
            ok = (t > 0.05) & (t < best_t)
            # stay within the corridor box
            ok &= (pts[..., 2] > self.z_min) & (pts[..., 2] < self.length + 1e-3)
            ok &= np.abs(pts[..., 0]) <= self.half_width + 1e-3
            ok &= pts[..., 1] <= self.ground_y + 1e-3
            tex = _texture(pts[..., ta] * 3.0, pts[..., tb] * 3.0, self.seed * 101 + salt)
            value = np.where(ok, tex, value)
            best_t = np.where(ok, t, best_t)
        # Floating (possibly moving) rectangles: nearer hits overwrite the
        # walls/ground, exactly like parked / oncoming objects in KITTI.
        for xc, yc, zc, w, h, vx, salt in self.occluders:
            xc = xc + vx * frame_index
            dn = d_world[..., 2]
            safe = np.abs(dn) > 1e-9
            t = np.full_like(dn, np.inf)
            np.divide(zc - origin[2], dn, out=t, where=safe)
            pts = origin[None, None, :] + t[..., None] * d_world
            ok = (t > 0.05) & (t < best_t)
            ok &= np.abs(pts[..., 0] - xc) <= w / 2
            ok &= np.abs(pts[..., 1] - yc) <= h / 2
            tex = _texture(
                (pts[..., 0] - vx * frame_index) * 4.0, pts[..., 1] * 4.0,
                self.seed * 101 + salt,
            )
            value = np.where(ok, tex, value)
            best_t = np.where(ok, t, best_t)
        img = 25.0 + 205.0 * value
        img = np.where(np.isfinite(best_t), img, 12.0).astype(np.float32)
        # t is distance along rays with unit camera-frame z, so it *is* depth.
        return img, best_t

    def init(self) -> bool:
        self.current_index = 0
        return True

    @property
    def ground_truth(self) -> np.ndarray:
        return self.gt_T_wc

    def next_frame(self) -> Optional[StereoFrame]:
        if self.current_index >= self.n_frames:
            return None
        i = self.current_index
        left = self._render(self.gt_T_wc[i], self.rig.left, i)
        right = self._render(self.gt_T_wc[i], self.rig.right, i)
        if self.exposure_drift > 0:
            gain = 1.0 + self.exposure_drift * np.sin(2 * np.pi * i / 47.0)
            left = left * gain
            right = right * gain
        if self.photometric_noise > 0:
            rng = np.random.default_rng(self.seed * 65537 + i)
            left = left + rng.normal(0, self.photometric_noise, left.shape)
            right = right + rng.normal(0, self.photometric_noise, right.shape)
        if self.exposure_drift > 0 or self.photometric_noise > 0:
            left = np.clip(left, 0, 255).astype(np.float32)
            right = np.clip(right, 0, 255).astype(np.float32)
        self.current_index += 1
        return StereoFrame(i, left, right)
