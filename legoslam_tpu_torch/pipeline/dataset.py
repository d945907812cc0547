"""Dataset ingestion (twin of legoslam_tpu/pipeline/dataset.py): the KITTI
odometry reader and the synthetic stereo worlds.

`KittiDataset` re-designs `Dataset` (src/dataset.cpp): parse calib.txt into
the stereo rig with K scaled by 0.5 and baseline = ||K^-1 t|| (:39-42), read
grayscale stereo PNGs by index (:62-63), and halve their resolution with
nearest-neighbour sampling (:76-77).  It decodes with the port's native
prefetching loader (legoslam_tpu_torch/native) where that builds, else with
utils/png.py (zlib and NumPy); both give the same bytes.

The synthetic renderers are NumPy and are the reference's, so a frame
renders to the same bytes in both packages; the rig is the port's
`StereoRig` (on the CPU; the driver moves it to its device).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from legoslam_tpu_torch.geometry.camera import Camera, StereoRig
from legoslam_tpu_torch.native import loader as native_loader
from legoslam_tpu_torch.utils import png
from legoslam_tpu_torch.utils.logging import get_logger

log = get_logger("legoslam.dataset")


class StereoFrame(NamedTuple):
    frame_id: int
    left: np.ndarray   # (H, W) float32, 0..255
    right: np.ndarray


def _nearest_half(img: np.ndarray) -> np.ndarray:
    """cv::resize INTER_NEAREST at exact 0.5: even rows/cols (dataset.cpp:76)."""
    H, W = img.shape
    return img[: 2 * (H // 2) : 2, : 2 * (W // 2) : 2]


class KittiDataset:
    """KITTI odometry sequence reader (`Dataset`, src/dataset.cpp).

    `decoder` is "native" (the prefetching loader: worker threads decode
    and decimate PNG pairs ahead of the consumer) where it builds, which is
    wherever g++ and zlib's header are present (a failed build there
    raises), else "zlib" (utils/png.py, one frame at a time).  Scales other
    than 0.5 and 1.0 keep the full image, as the reference's reader does."""

    def __init__(self, dataset_dir: str, scale: float = 0.5, use_native: bool = True):
        self.dataset_dir = dataset_dir
        self.scale = scale
        self.use_native = use_native
        self._native = None
        self.decoder: Optional[str] = None
        self.rig: Optional[StereoRig] = None
        self.current_index = 0
        self.ground_truth: Optional[np.ndarray] = None  # (N, 4, 4) T_wc if available

    def init(self) -> bool:
        calib = os.path.join(self.dataset_dir, "calib.txt")
        if not os.path.exists(calib):
            log.error("Cannot find file: %s", calib)
            return False
        projections = []
        with open(calib) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 13 and parts[0].startswith("P"):
                    projections.append(np.asarray([float(v) for v in parts[1:]]).reshape(3, 4))
        if len(projections) < 2:
            log.error("calib.txt has fewer than 2 projection rows")
            return False
        self.rig = StereoRig.from_kitti_projections(projections[0], projections[1], scale=self.scale)
        self.current_index = 0
        self._load_ground_truth()
        if self._native is not None:
            self._native.close()
            self._native = None
        self.decoder = "zlib"
        if self.use_native and self.scale in (0.5, 1.0) and native_loader.available():
            self._native = native_loader.PrefetchLoader(self.dataset_dir, half=self.scale == 0.5)
            self.decoder = "native"
        log.info("KITTI sequence %s: decoder %s", self.dataset_dir, self.decoder)
        return True

    def _load_ground_truth(self) -> None:
        # KITTI layout: sequences/<seq>/ with poses at ../../poses/<seq>.txt
        seq = os.path.basename(os.path.normpath(self.dataset_dir))
        for cand in [
            os.path.join(self.dataset_dir, "poses.txt"),
            os.path.join(self.dataset_dir, "..", "..", "poses", seq + ".txt"),
        ]:
            if os.path.exists(cand):
                rows = np.loadtxt(cand)
                gt = np.tile(np.eye(4), (len(rows), 1, 1))
                gt[:, :3, :] = rows.reshape(-1, 3, 4)
                self.ground_truth = gt
                return

    def seek(self, index: int) -> None:
        """Reposition at `index` (checkpoint resume).  The prefetching loader
        streams in order from its opening index, so seeking reopens it there;
        the zlib path just moves the cursor."""
        self.current_index = index
        if self._native is not None:
            self._native.close()
            self._native = native_loader.PrefetchLoader(self.dataset_dir, start=index, half=self.scale == 0.5)

    def next_frame(self) -> Optional["StereoFrame"]:
        """Dataset::NextFrame (dataset.cpp:53-86): None at end of sequence."""
        if self._native is not None:
            out = self._native.next()
            if out is None:
                return None
            idx, left, right = out
            self.current_index = idx + 1
            return StereoFrame(idx, left, right)
        idx = self.current_index
        left, right = (png.read_png_gray(os.path.join(self.dataset_dir, f"image_{c}", f"{idx:06d}.png"))
                       for c in (0, 1))
        if left is None or right is None:
            log.warning("Cannot find images at index: %d", idx)
            return None
        if self.scale == 0.5:
            left, right = _nearest_half(left), _nearest_half(right)
        self.current_index += 1
        return StereoFrame(idx, left.astype(np.float32), right.astype(np.float32))


def write_kitti_sequence(root: str, P0: np.ndarray, P1: np.ndarray, poses_wc: Optional[np.ndarray] = None) -> None:
    """The files of a KITTI-format sequence other than its images:
    calib.txt (P0, P1), image_0/ and image_1/, and poses.txt (T_wc rows)."""
    for c in (0, 1):
        os.makedirs(os.path.join(root, f"image_{c}"), exist_ok=True)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(f"{name}: " + " ".join(repr(float(v)) for v in np.asarray(P).reshape(-1)) + "\n")
    if poses_wc is not None:
        np.savetxt(os.path.join(root, "poses.txt"), np.asarray(poses_wc)[:, :3, :].reshape(len(poses_wc), 12))


def write_kitti_frame(root: str, index: int, left: np.ndarray, right: np.ndarray) -> None:
    """Frame `index` of a KITTI-format sequence, as 8-bit grayscale PNGs."""
    for c, img in ((0, left), (1, right)):
        png.write_png_gray(os.path.join(root, f"image_{c}", f"{index:06d}.png"), img)


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


class SyntheticDataset:
    """Procedural stereo corridor with exact ground truth.

    A cloud of Gaussian blobs along a gently curving forward trajectory; the
    renderer splats each visible point into both cameras with sub-pixel
    placement, giving KLT well-conditioned texture and the evaluator an exact
    trajectory.
    """

    def __init__(
        self,
        n_frames: int = 60,
        shape: Tuple[int, int] = (120, 200),
        n_points: int = 3000,
        baseline: float = 0.54,
        focal: float = 180.0,
        speed: float = 0.35,
        curve: float = 0.004,
        seed: int = 0,
        length: float = 120.0,
    ):
        H, W = shape
        self.shape = shape
        self.n_frames = n_frames
        rng = np.random.default_rng(seed)
        # Depth is log-uniform along the corridor: real scenes are near-dense /
        # far-sparse.  A uniform-in-z cloud leaves a permanent far cluster at
        # the focus of expansion that keeps inlier counts high while the
        # geometry degenerates (no keyframes ever trigger, z drifts away).
        z0 = 2.0
        z = z0 * np.exp(rng.uniform(0.0, np.log(length / z0), n_points))
        self.points = np.stack(
            [
                rng.uniform(-16, 16, n_points),
                rng.uniform(-4.5, 1.8, n_points),
                z,
            ],
            axis=1,
        )
        # Two blob populations: fine corners plus a coarse fraction that stays
        # visible in the pyramid's top levels (without coarse-scale structure
        # the coarse-to-fine tracker has nothing to lock onto at /4 and /8,
        # which real imagery always provides).
        coarse = rng.random(n_points) < 0.2
        # Amplitudes sized so overlapping stamps almost never saturate the
        # 0..255 range: saturated plateaus have zero gradient and are
        # untrackable (and unrealistic).
        self.amps = np.where(coarse, rng.uniform(6, 18, n_points), rng.uniform(25, 75, n_points))
        # Fine blobs stay above ~1.4 px so the rendered texture is comfortably
        # band-limited — near-Nyquist blobs give KLT poor subpixel accuracy.
        self.sigmas = np.where(coarse, rng.uniform(3.0, 7.0, n_points), rng.uniform(1.4, 2.2, n_points))
        # Distinctive per-blob appearance (anisotropy + ripple): identical
        # radially-symmetric blobs alias along epipolar lines and make KLT
        # lock onto the wrong neighbor; real imagery has unique local texture.
        theta = rng.uniform(0, np.pi, n_points)
        aspect = rng.uniform(0.5, 1.0, n_points)
        c, s = np.cos(theta), np.sin(theta)
        self.aniso = np.stack([c, s, -s * aspect, c * aspect], axis=1)  # row-major 2x2
        self.ripple_k = rng.uniform(0.5, 1.4, (n_points, 2)) * np.where(
            rng.random((n_points, 2)) < 0.5, -1, 1
        )
        self.ripple_phase = rng.uniform(0, 2 * np.pi, n_points)
        right_pose = np.eye(4)
        right_pose[0, 3] = -baseline
        self.rig = StereoRig(
            left=Camera.create(focal, focal, W / 2.0, H / 2.0, baseline),
            right=Camera.create(focal, focal, W / 2.0, H / 2.0, baseline, pose=right_pose),
        )
        # Ground truth: forward motion with a slow yaw curve.
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

    def _render(self, T_cw: np.ndarray, cam) -> np.ndarray:
        H, W = self.shape
        img = np.full((H, W), 20.0, np.float32)
        ext = cam.pose.double().cpu().numpy()
        p = (ext @ T_cw)[:3, :3] @ self.points.T + (ext @ T_cw)[:3, 3:]
        z = p[2]
        vis = z > 0.5
        u = float(cam.fx) * p[0] / z + float(cam.cx)
        v = float(cam.fy) * p[1] / z + float(cam.cy)
        vis &= (u > -4) & (u < W + 4) & (v > -4) & (v < H + 4)
        idx = np.nonzero(vis)[0]
        for i in idx:
            r = max(4, int(2.5 * self.sigmas[i]))
            x0, y0 = int(np.floor(u[i])), int(np.floor(v[i]))
            xs = np.arange(max(0, x0 - r), min(W, x0 + r + 1))
            ys = np.arange(max(0, y0 - r), min(H, y0 + r + 1))
            if len(xs) == 0 or len(ys) == 0:
                continue
            dx = (xs - u[i])[None, :]
            dy = (ys - v[i])[:, None]
            a, b, c, d = self.aniso[i]
            rx = a * dx + b * dy
            ry = c * dx + d * dy
            g = np.exp(-(rx**2 + ry**2) / (2 * self.sigmas[i] ** 2))
            ripple = 0.6 + 0.4 * np.cos(
                self.ripple_k[i, 0] * dx + self.ripple_k[i, 1] * dy + self.ripple_phase[i]
            )
            img[np.ix_(ys, xs)] += self.amps[i] * g * ripple
        return np.clip(img, 0, 255)

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
        T_cw = np.linalg.inv(self.gt_T_wc[i])
        left = self._render(T_cw, self.rig.left)
        right = self._render(T_cw, self.rig.right)
        self.current_index += 1
        return StereoFrame(i, left, right)
