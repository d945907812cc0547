"""The VisualOdometry API and the per-frame step (twin of
legoslam_tpu/pipeline/visual_odometry.py, with window BA not yet ported).

`process_frame` is `Frontend::AddFrame` (frontend_g2o.cpp:27-46): the
INITING / TRACKING / LOST state machine.  The reference compiles the whole
frame into one program (`lax.switch`, `lax.cond`) for the TPU; here the
driver branches in Python on the status and the keyframe decision, reading
the inlier count of the frame's pose solve from the device once per
tracking frame.  On CUDA tensors a tracking frame runs the two CUDA kernels
(anchored KLT, pose) between a few PyTorch ops.

Only `ba_mode="off"` runs: window BA is not ported yet, and the other
modes raise instead of quietly running without it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.geometry.camera import StereoRig
from legoslam_tpu_torch.ops import pyramid as pyr_ops
from legoslam_tpu_torch.pipeline import frontend as frontend_mod
from legoslam_tpu_torch.pipeline.dataset import StereoFrame
from legoslam_tpu_torch.pipeline.state import Features, VOCarry, WorldMap
from legoslam_tpu_torch.utils.config import Config
from legoslam_tpu_torch.utils.logging import get_logger
from legoslam_tpu_torch.utils.timer import Timer

log = get_logger("legoslam.vo")


class FrontendStatus(enum.IntEnum):
    """frontend.h:17"""

    INITING = 0
    TRACKING_GOOD = 1
    TRACKING_BAD = 2
    LOST = 3


@dataclass(frozen=True)
class FrameOutput:
    """Per-frame results and the reference's per-frame log counters."""

    T_cw: torch.Tensor
    status: int
    kf_inserted: bool
    n_inliers: int
    n_tracked: Any = 0                           # KLT survivors (tensor)
    n_new_landmarks: Any = 0                     # triangulated this frame (tensor)


def initial_carry(cfg: frontend_mod.FrontendConfig, shape, dtype, device) -> VOCarry:
    H, W = shape
    levels = cfg.klt.levels
    pyr = tuple(torch.zeros((H // (2**i), W // (2**i)), dtype=dtype, device=device) for i in range(levels))
    eye = torch.eye(4, dtype=dtype, device=device)
    return VOCarry(
        status=int(FrontendStatus.INITING),
        feats=Features.empty(cfg.caps, dtype, cfg.klt.levels, 2 * cfg.klt.half_patch + 3, device),
        wmap=WorldMap.empty(cfg.caps, dtype, device),
        T_cur=eye,
        rel_motion=eye.clone(),
        pyr_last=pyr,
        frames_since_kf=0,
    )


def process_frame(
    cfg: frontend_mod.FrontendConfig,
    rig: StereoRig,
    carry: VOCarry,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    frame_id: int,
) -> Tuple[VOCarry, FrameOutput]:
    """One SLAM frame with window BA off."""
    pyr_l = tuple(pyr_ops.build_pyramid(img_l, cfg.klt.levels))
    eye = torch.eye(4, dtype=img_l.dtype, device=img_l.device)
    zero = torch.zeros((), dtype=torch.int32, device=img_l.device)

    if carry.status == FrontendStatus.INITING:
        pyr_r = tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
        success, feats, wmap = frontend_mod.stereo_init(cfg, rig, pyr_l, pyr_r, img_l, carry.wmap, frame_id)
        status = int(FrontendStatus.TRACKING_GOOD if success else FrontendStatus.INITING)
        out = FrameOutput(T_cw=eye, status=status, kf_inserted=success, n_inliers=0,
                          n_tracked=zero, n_new_landmarks=wmap.lm_next - carry.wmap.lm_next)
        return VOCarry(status, feats, wmap, eye, eye.clone(), pyr_l, 0), out

    if carry.status == FrontendStatus.LOST:
        # Reset (frontend_g2o.cpp:351-366): wipe the map, re-init next frame.
        fresh = initial_carry(cfg, tuple(img_l.shape), img_l.dtype, img_l.device)
        out = FrameOutput(T_cw=carry.T_cur, status=fresh.status, kf_inserted=False, n_inliers=0,
                          n_tracked=zero, n_new_landmarks=zero)
        return fresh.replace(pyr_last=pyr_l), out

    # Track (frontend_g2o.cpp:48-75).  The composition is re-projected onto
    # SE(3): float32 pose products shed orthonormality and the rel/T_cur
    # feedback amplifies it (se3.so3_project).
    T_prior = se3.se3_orthonormalize(carry.rel_motion @ carry.T_cur)
    feats = frontend_mod.track_last_frame(
        cfg, rig, pyr_l, carry.feats, carry.wmap.lm_pos, T_prior, rel_motion=carry.rel_motion
    )
    n_tracked = feats.count()
    T_new, feats, n_in_t = frontend_mod.estimate_current_pose(cfg, rig, feats, carry.wmap.lm_pos, T_prior)
    n_in = int(n_in_t)  # the frame's one device read
    if n_in >= cfg.num_features_tracking:
        status = FrontendStatus.TRACKING_GOOD
    elif n_in >= cfg.num_features_tracking_bad:
        status = FrontendStatus.TRACKING_BAD
    else:
        status = FrontendStatus.LOST
    # InsertKeyframe when tracked support is low (frontend_g2o.cpp:77-81) or
    # the max keyframe gap elapsed; a LOST frame does not insert.
    insert = (
        n_in < cfg.num_features_needed_for_keyframe or carry.frames_since_kf + 1 >= cfg.max_keyframe_gap
    ) and n_in >= cfg.num_features_tracking_bad
    wmap = carry.wmap
    if insert:
        pyr_r = tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
        feats, wmap = frontend_mod.insert_keyframe(cfg, rig, pyr_l, pyr_r, img_l, feats, wmap, T_new, frame_id)
    rel = se3.se3_orthonormalize(T_new @ se3.se3_inv(carry.T_cur))
    out = FrameOutput(T_cw=T_new, status=int(status), kf_inserted=insert, n_inliers=n_in,
                      n_tracked=n_tracked, n_new_landmarks=wmap.lm_next - carry.wmap.lm_next)
    since_kf = 0 if insert else carry.frames_since_kf + 1
    return VOCarry(int(status), feats, wmap, T_new, rel, pyr_l, since_kf), out


class VisualOdometry:
    """Host-side frame loop (the reference's `VisualOdometry` API).

    Runs on the CUDA card unless `device` says otherwise; `init()` raises
    where the device is a card and none is present, so the default never
    runs on the CPU.  `device="cpu"` runs the kernels' plain versions."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        config: Optional[Config] = None,
        dataset: Any = None,
        ba_mode: Optional[str] = None,
        device: Any = "cuda",
    ):
        self.config = config or (Config.from_yaml(config_path) if config_path else Config())
        self.dataset = dataset
        ba_mode = ba_mode or self.config["ba_mode"]
        if ba_mode in ("inline", "async"):
            raise NotImplementedError("window BA lands in the next port PR")
        if ba_mode != "off":
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        for key in ("use_loop_closure", "use_marg_prior"):
            if self.config[key]:
                raise NotImplementedError(f"{key} is not ported yet")
        if int(self.config["viewer_every_n"]) > 0:
            raise NotImplementedError("the viewer is not ported yet")
        self.ba_mode = ba_mode
        self.device = torch.device(device)
        self.frontend_cfg: Optional[frontend_mod.FrontendConfig] = None
        self.rig: Optional[StereoRig] = None
        self.carry: Optional[VOCarry] = None
        self.outputs: List[FrameOutput] = []
        self.frame_ids: List[int] = []
        self.log_every = 0

    # --- reference API (visual_odometry.h:27-49) ---
    def init(self) -> bool:
        if self.dataset is None:
            raise NotImplementedError("the KITTI loader is not ported yet; pass a dataset")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VisualOdometry: no CUDA device for device='cuda'; "
                               "pass device='cpu' to run the plain versions on the CPU")
        if not self.dataset.init():
            return False
        self.rig = self.dataset.rig.to(self.device)
        self.frontend_cfg = frontend_mod.FrontendConfig.from_config(self.config)
        self.log_every = int(self.config["log_every_n_frames"])
        self.carry = None
        self.outputs = []
        self.frame_ids = []
        return True

    def step(self) -> bool:
        """Process one frame (visual_odometry.cpp:59-70)."""
        frame = self.dataset.next_frame()
        if frame is None:
            return False
        self.process(frame)
        return True

    def process(self, frame: StereoFrame) -> FrameOutput:
        img_l = torch.as_tensor(np.asarray(frame.left, np.float32)).to(self.device)
        img_r = torch.as_tensor(np.asarray(frame.right, np.float32)).to(self.device)
        if self.carry is None:
            self.carry = initial_carry(self.frontend_cfg, frame.left.shape, torch.float32, self.device)
        self.carry, out = process_frame(self.frontend_cfg, self.rig, self.carry, img_l, img_r, int(frame.frame_id))
        self.outputs.append(out)
        self.frame_ids.append(frame.frame_id)
        if self.log_every > 0 and len(self.outputs) % self.log_every == 0:
            log.info("frame %d: %s tracked=%d inliers=%d%s", frame.frame_id,
                     FrontendStatus(out.status).name, int(out.n_tracked), out.n_inliers,
                     f" KF new_landmarks={int(out.n_new_landmarks)}" if out.kf_inserted else "")
        return out

    def run(self) -> None:
        """Main loop (visual_odometry.cpp:46-57)."""
        t_total = Timer(self.device)
        n = 0
        while self.step():
            n += 1
        total_ms = t_total.toc()
        if n:
            log.info("VO: %d frames in %.1f ms (%.2f ms/frame, %.1f FPS)",
                     n, total_ms, total_ms / n, 1e3 * n / total_ms)

    # --- results ---
    def trajectory_T_cw(self) -> np.ndarray:
        return torch.stack([o.T_cw for o in self.outputs]).cpu().numpy()

    def trajectory_T_wc(self) -> np.ndarray:
        return np.linalg.inv(self.trajectory_T_cw())

    def statuses(self) -> np.ndarray:
        return np.asarray([o.status for o in self.outputs], np.int32)

    def keyframe_flags(self) -> np.ndarray:
        return np.asarray([o.kf_inserted for o in self.outputs], bool)

    def num_keyframes(self) -> int:
        return int(self.carry.wmap.num_keyframes()) if self.carry is not None else 0

    def save_trajectory(self, path: str) -> None:
        from legoslam_tpu_torch.utils import evaluation

        evaluation.save_kitti_trajectory(path, self.trajectory_T_wc())
