"""The VisualOdometry API and the per-frame step (twin of
legoslam_tpu/pipeline/visual_odometry.py).

`process_frame` is `Frontend::AddFrame` (frontend_g2o.cpp:27-46): the
INITING / TRACKING / LOST state machine, with the backend's window BA
(`backend.ba_step`) run inline after a successful stereo init and after
each keyframe insertion, where the reference's `run_ba` sits.  The
reference compiles the whole frame into one program (`lax.switch`,
`lax.cond`) for the TPU; here the driver branches in Python on the status
and the keyframe decision, reading the inlier count of the frame's pose
solve from the device once per tracking frame, and window BA reads one
pair of flags per LM attempt.  On CUDA tensors a tracking frame runs the
two CUDA kernels (anchored KLT, pose) between a few PyTorch ops; window BA
runs as PyTorch ops on the card.

`ba_mode` "inline" (the default) runs BA, "off" runs without it; "async"
(the reference's overlapped backend) is not ported yet and raises.

With `use_loop_closure` the driver feeds a `LoopCloser`
(pipeline/loop_closure.py) from `_loop_hook`.  The reference registers, for
each keyframe, the state of the frame after it (that frame's pose was
estimated against the landmarks BA had just refined, so pose, features and
points agree), drains a trailing keyframe from the final carry at the end
of the stream, and resets the closer when tracking is LOST; the hook keeps
exactly that, with one device-to-host copy per registered keyframe.
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
from legoslam_tpu_torch.pipeline import backend as backend_mod
from legoslam_tpu_torch.pipeline import frontend as frontend_mod
from legoslam_tpu_torch.pipeline.dataset import StereoFrame
from legoslam_tpu_torch.pipeline.state import Features, VOCarry, WorldMap
from legoslam_tpu_torch.solver import schur
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
    """Per-frame results and the reference's per-frame log counters
    (frontend_lego.cpp:87,152,230; problem.cpp:180-184)."""

    T_cw: torch.Tensor
    status: int
    kf_inserted: bool
    n_inliers: int
    ba_chi: torch.Tensor                         # BA's final chi, NaN where BA did not run
    n_tracked: Any = 0                           # KLT survivors (tensor)
    n_new_landmarks: Any = 0                     # triangulated this frame (tensor)
    ba: Optional[backend_mod.BAStats] = None     # NaN/0 where BA did not run (always set)


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
    ba_cfg: backend_mod.BAConfig = backend_mod.BAConfig(),
    inline_ba: bool = True,
) -> Tuple[VOCarry, FrameOutput]:
    """One SLAM frame, with window BA after a keyframe when `inline_ba`."""
    pyr_l = tuple(pyr_ops.build_pyramid(img_l, cfg.klt.levels))
    eye = torch.eye(4, dtype=img_l.dtype, device=img_l.device)
    zero = torch.zeros((), dtype=torch.int32, device=img_l.device)
    no_ba = backend_mod.no_stats(ba_cfg, img_l.dtype, img_l.device)

    def run_ba(wmap):
        if not inline_ba:
            return wmap, no_ba
        return backend_mod.ba_step(cfg, rig, wmap, ba_cfg)

    if carry.status == FrontendStatus.INITING:
        pyr_r = tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
        success, feats, wmap = frontend_mod.stereo_init(cfg, rig, pyr_l, pyr_r, img_l, carry.wmap, frame_id)
        n_new = wmap.lm_next - carry.wmap.lm_next
        wmap, ba = run_ba(wmap) if success else (wmap, no_ba)
        status = int(FrontendStatus.TRACKING_GOOD if success else FrontendStatus.INITING)
        out = FrameOutput(T_cw=eye, status=status, kf_inserted=success, n_inliers=0, ba_chi=ba.chi,
                          n_tracked=zero, n_new_landmarks=n_new, ba=ba)
        return VOCarry(status, feats, wmap, eye, eye.clone(), pyr_l, 0), out

    if carry.status == FrontendStatus.LOST:
        # Reset (frontend_g2o.cpp:351-366): wipe the map, re-init next frame.
        fresh = initial_carry(cfg, tuple(img_l.shape), img_l.dtype, img_l.device)
        out = FrameOutput(T_cw=carry.T_cur, status=fresh.status, kf_inserted=False, n_inliers=0,
                          ba_chi=no_ba.chi, n_tracked=zero, n_new_landmarks=zero, ba=no_ba)
        return fresh.replace(pyr_last=pyr_l), out

    # Track (frontend_g2o.cpp:48-75).  The composition is re-projected onto
    # SE(3): float32 pose products shed orthonormality and the rel/T_cur
    # feedback amplifies it (se3.so3_project).
    T_prior = se3.se3_orthonormalize(carry.rel_motion @ carry.T_cur)
    feats = frontend_mod.track_last_frame(
        cfg, rig, carry.pyr_last, pyr_l, carry.feats, carry.wmap.lm_pos, T_prior, rel_motion=carry.rel_motion
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
    wmap, ba = carry.wmap, no_ba
    if insert:
        pyr_r = tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
        feats, wmap = frontend_mod.insert_keyframe(cfg, rig, pyr_l, pyr_r, img_l, feats, wmap, T_new, frame_id)
        wmap, ba = run_ba(wmap)
    rel = se3.se3_orthonormalize(T_new @ se3.se3_inv(carry.T_cur))
    out = FrameOutput(T_cw=T_new, status=int(status), kf_inserted=insert, n_inliers=n_in, ba_chi=ba.chi,
                      n_tracked=n_tracked, n_new_landmarks=wmap.lm_next - carry.wmap.lm_next, ba=ba)
    since_kf = 0 if insert else carry.frames_since_kf + 1
    return VOCarry(int(status), feats, wmap, T_new, rel, pyr_l, since_kf), out


def _apply_world_correction(carry: VOCarry, G: torch.Tensor) -> VOCarry:
    """Re-anchor the live world after a loop closure (pipeline/loop_closure.py):
    map points p' = G p, camera-from-world poses Q' = Q G^-1; the relative
    motion model and the feature tables are frame-local and unaffected."""
    G_inv = se3.se3_inv(G)
    R, t = G[:3, :3], G[:3, 3]
    wmap = carry.wmap
    lm_pos = torch.where(wmap.lm_alive[:, None], wmap.lm_pos @ R.T + t[None, :], wmap.lm_pos)
    kf_pose = torch.where(wmap.kf_valid[:, None, None], se3.se3_orthonormalize(wmap.kf_pose @ G_inv),
                          wmap.kf_pose)
    marg = wmap.marg.replace(
        prior_T=se3.se3_orthonormalize(wmap.marg.prior_T @ G_inv),
        info_T=se3.se3_orthonormalize(wmap.marg.info_T @ G_inv),
    )
    return carry.replace(
        wmap=wmap.replace(lm_pos=lm_pos, kf_pose=kf_pose, marg=marg),
        T_cur=se3.se3_orthonormalize(carry.T_cur @ G_inv),
    )


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
        if ba_mode == "async":
            raise NotImplementedError("async window BA is not ported yet; use ba_mode 'inline' or 'off'")
        if ba_mode not in ("inline", "off"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        if int(self.config["viewer_every_n"]) > 0:
            raise NotImplementedError("the viewer is not ported yet")
        self.ba_mode = ba_mode
        self.device = torch.device(device)
        self.frontend_cfg: Optional[frontend_mod.FrontendConfig] = None
        self.rig: Optional[StereoRig] = None
        self.ba_cfg: Optional[backend_mod.BAConfig] = None
        self.loop_closer = None
        self._hook_prev: Optional[Tuple[StereoFrame, FrameOutput]] = None
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
        self.ba_cfg = backend_mod.BAConfig(
            iterations=self.config["ba_solver_iterations"],
            chi2_threshold=self.config["chi2_threshold"],
            max_chi2_doublings=self.config["ba_max_chi2_doublings"],
            inlier_ratio=self.config["ba_inlier_ratio"],
            strategy=self.config["lm_strategy"],
            linear_solver=self.config["linear_solver"],
            engine=self.config["lm_engine"],
            trace=bool(self.config["ba_trace"]),
        )
        schur.check_engine(self.ba_cfg.engine)
        self.log_every = int(self.config["log_every_n_frames"])
        self.loop_closer = None
        if bool(self.config["use_loop_closure"]):
            from legoslam_tpu_torch.pipeline.loop_closure import LoopCloser, LoopConfig

            self.loop_closer = LoopCloser(
                self.rig,
                LoopConfig(
                    zncc_min=float(self.config["loop_zncc_min"]),
                    min_gap=int(self.config["loop_min_gap"]),
                    min_inliers=int(self.config["loop_min_inliers"]),
                    loop_weight=float(self.config["loop_edge_weight"]),
                ),
                device=self.device,
            )
        self._hook_prev = None
        self.carry = None
        self.outputs = []
        self.frame_ids = []
        return True

    def step(self) -> bool:
        """Process one frame (visual_odometry.cpp:59-70)."""
        frame = self.dataset.next_frame()
        if frame is None:
            self._drain_hooks()
            return False
        self.process(frame)
        return True

    def process(self, frame: StereoFrame) -> FrameOutput:
        img_l = torch.as_tensor(np.asarray(frame.left, np.float32)).to(self.device)
        img_r = torch.as_tensor(np.asarray(frame.right, np.float32)).to(self.device)
        if self.carry is None:
            self.carry = initial_carry(self.frontend_cfg, frame.left.shape, torch.float32, self.device)
        self.carry, out = process_frame(self.frontend_cfg, self.rig, self.carry, img_l, img_r,
                                        int(frame.frame_id), self.ba_cfg, self.ba_mode == "inline")
        if self.loop_closer is not None:
            self._loop_hook(frame, out)
        self.outputs.append(out)
        self.frame_ids.append(frame.frame_id)
        if self.log_every > 0 and len(self.outputs) % self.log_every == 0:
            self._log_frame(frame.frame_id, out)
        return out

    def _loop_hook(self, frame: StereoFrame, out: FrameOutput) -> None:
        """Feed the loop closer: the frame after each keyframe is the one
        registered (its pose, features and landmark positions describe one
        frame, estimated against the map BA just refined), and a LOST frame
        resets the closer when the next frame arrives."""
        prev = self._hook_prev
        self._hook_prev = (frame, out)
        if prev is not None:
            self._consume_flags(prev[1], frame, out.T_cw)

    def _consume_flags(self, flags: FrameOutput, frame: StereoFrame, T_cw: torch.Tensor) -> None:
        """Act on one frame's `status` and `kf_inserted`: `frame` and `T_cw`
        are what the carry describes now."""
        if flags.status == FrontendStatus.LOST:
            self.loop_closer.reset()
        elif flags.kf_inserted:
            self._register_keyframe(frame, T_cw)

    def _register_keyframe(self, frame: StereoFrame, T_cw: torch.Tensor) -> None:
        """Hand the current carry's landmark-linked features to the loop
        closer as one keyframe record (one device-to-host copy) and, if a
        loop closes, re-anchor the live world."""
        feats, wmap = self.carry.feats, self.carry.wmap
        M = feats.uv.shape[0]
        sel = feats.valid & (feats.lm >= 0)
        pw = wmap.lm_pos[torch.clamp(feats.lm, min=0).long()]
        v = torch.cat([T_cw.reshape(-1), feats.uv.reshape(-1), sel.to(T_cw.dtype), pw.reshape(-1)]).cpu().numpy()
        uv = v[16:16 + 2 * M].reshape(M, 2)
        keep = v[16 + 2 * M:16 + 3 * M] > 0.5
        p_world = v[16 + 3 * M:].reshape(M, 3)
        result = self.loop_closer.add_keyframe(int(frame.frame_id), np.asarray(frame.left),
                                               v[:16].reshape(4, 4), uv[keep], p_world[keep])
        if result is not None:
            G = torch.as_tensor(result[1], dtype=torch.float32).to(self.device)
            self.carry = _apply_world_correction(self.carry, G)

    def _drain_hooks(self) -> None:
        """End of stream: the last frame's flags were never consumed; a
        trailing keyframe (often the one that closes a loop) is registered
        from the final carry, which still describes that frame."""
        prev, self._hook_prev = self._hook_prev, None
        if self.loop_closer is not None and prev is not None:
            frame, out = prev
            self._consume_flags(out, frame, out.T_cw)

    def keyframe_trajectory(self):
        """(frame_ids, T_cw (N, 4, 4)) over the loop closer's keyframe
        records, loop-corrected; empty without loop closure."""
        lc = self.loop_closer
        if lc is None or not lc.records:
            return [], np.zeros((0, 4, 4))
        return [r.frame_id for r in lc.records], np.stack([r.T_cw for r in lc.records])

    def _log_frame(self, frame_id: int, out: FrameOutput) -> None:
        """The reference's per-frame INFO log (frontend_lego.cpp:87,152,230 and
        problem.cpp:180-184).  Reads from the device: gate with log_every."""
        msg = (f"frame {frame_id}: {FrontendStatus(out.status).name} tracked={int(out.n_tracked)} "
               f"inliers={out.n_inliers}")
        if out.kf_inserted:
            msg += f" KF new_landmarks={int(out.n_new_landmarks)}"
            ba = out.ba
            if np.isfinite(float(ba.chi)):
                msg += (f" | BA chi={float(ba.chi):.2f} iters={ba.iterations} lambda={float(ba.lam):.3g}"
                        f" inl/out={int(ba.n_inlier)}/{int(ba.n_outlier)}"
                        f" active_lms={int(ba.n_active_landmarks)}")
                if int(ba.n_dropped_landmarks) > 0:
                    log.warning("frame %d: BA capacity overflow — %d landmarks/edges dropped from the "
                                "problem (raise max_active_landmarks / max_ba_edges)",
                                frame_id, int(ba.n_dropped_landmarks))
                for it, (chi, lam) in enumerate(ba.trace.tolist()):
                    if np.isfinite(chi):
                        log.info("  BA iter %d: chi=%.3f lambda=%.4g", it, chi, lam)
        log.info(msg)

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
            # Capacity audit: a BA solve that quietly truncated its problem is
            # reported even when per-frame logging is off.
            dropped = int(torch.stack([o.ba.n_dropped_landmarks for o in self.outputs]).sum())
            if dropped > 0:
                log.warning("VO: BA dropped %d landmark/edge slots across the run due to capacity "
                            "limits — results may be degraded; raise max_active_landmarks / "
                            "max_ba_edges", dropped)

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
