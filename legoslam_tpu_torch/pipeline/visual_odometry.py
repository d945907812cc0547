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

`ba_mode` "inline" (the default) runs BA, "off" runs without it, and
"async" overlaps it with tracking (pipeline/async_backend.py: a worker
thread, a side CUDA stream on a card), merging each solve into the map at
the first frame after it finishes.  `process_chunk` runs `process_frame`
over F stacked frames and stacks the outputs, the reference's throughput
API.

With `use_loop_closure` the driver feeds a `LoopCloser`
(pipeline/loop_closure.py) from `_loop_hook`.  The reference registers, for
each keyframe, the state of the frame after it (that frame's pose was
estimated against the landmarks BA had just refined, so pose, features and
points agree), drains a trailing keyframe from the final carry at the end
of the stream, and resets the closer when tracking is LOST; the hook keeps
exactly that, with one device-to-host copy per registered keyframe.  A
correction the closer returns is applied when the reference applies it:
held, and applied to the carry after the next frame (the reference reads
its keyframe snapshot one frame late), or at the end of the stream.  Under
a profiler a registration is a `loop` span (`records`, `closed`; the copy
is a `read` of site `loop_register`) and an applied correction a
`loop_apply` span.

Around the frame step: `init()` reads `dataset_dir` as a KITTI sequence
when no dataset is given, `save_checkpoint` / `load_checkpoint` write and
read the JAX package's checkpoint format (utils/checkpoint.py), and
`viewer_every_n > 0` feeds the headless viewer (pipeline/viewer.py) from
the carry, which reads the feature table from the device every N frames and
the landmark table on every keyframe.
"""

from __future__ import annotations

import dataclasses
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
from legoslam_tpu_torch.pipeline.dataset import KittiDataset, StereoFrame
from legoslam_tpu_torch.pipeline.state import Features, VOCarry, WorldMap
from legoslam_tpu_torch.solver import schur
from legoslam_tpu_torch.utils.config import Config
from legoslam_tpu_torch.utils.logging import get_logger
from legoslam_tpu_torch.utils import timer

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


def constant_velocity_prior(rel_motion: torch.Tensor, T_cur: torch.Tensor) -> torch.Tensor:
    """The tracking frame's prior pose, ``rel_motion @ T_cur`` re-projected
    onto SE(3) (frontend_g2o.cpp:48-75): float32 pose products shed
    orthonormality and the rel/T_cur feedback amplifies it (se3.so3_project)."""
    return se3.se3_orthonormalize(se3.compose(rel_motion, T_cur))


def process_frame(
    cfg: frontend_mod.FrontendConfig,
    rig: StereoRig,
    carry: VOCarry,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    frame_id: int,
    ba_cfg: backend_mod.BAConfig = backend_mod.BAConfig(),
    inline_ba: bool = True,
    ba_solve_fn=None,
) -> Tuple[VOCarry, FrameOutput]:
    """One SLAM frame, with window BA after a keyframe when `inline_ba`
    (solved by `ba_solve_fn` where given, as `backend.ba_step` takes it).
    Under a profiler, a `frame` span (utils/timer.py) whose `branch` is
    init, track, keyframe or lost."""
    with timer.span("frame", frame=frame_id) as frame_span:
        with timer.span("pyramid", image="left"):
            pyr_l = tuple(pyr_ops.build_pyramid(img_l, cfg.klt.levels))
        eye = torch.eye(4, dtype=img_l.dtype, device=img_l.device)
        zero = torch.zeros((), dtype=torch.int32, device=img_l.device)
        no_ba = backend_mod.no_stats(ba_cfg, img_l.dtype, img_l.device)

        def run_ba(wmap):
            if not inline_ba:
                return wmap, no_ba
            if ba_solve_fn is None:
                return backend_mod.ba_step(cfg, rig, wmap, ba_cfg)
            return backend_mod.ba_step(cfg, rig, wmap, ba_cfg, solve_fn=ba_solve_fn)

        def pyramid_right():
            with timer.span("pyramid", image="right"):
                return tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))

        if carry.status == FrontendStatus.INITING:
            frame_span.set(branch="init")
            success, feats, wmap = frontend_mod.stereo_init(cfg, rig, pyr_l, pyramid_right(), img_l, carry.wmap,
                                                            frame_id)
            n_new = wmap.lm_next - carry.wmap.lm_next
            wmap, ba = run_ba(wmap) if success else (wmap, no_ba)
            status = int(FrontendStatus.TRACKING_GOOD if success else FrontendStatus.INITING)
            out = FrameOutput(T_cw=eye, status=status, kf_inserted=success, n_inliers=0, ba_chi=ba.chi,
                              n_tracked=zero, n_new_landmarks=n_new, ba=ba)
            return VOCarry(status, feats, wmap, eye, eye.clone(), pyr_l, 0), out

        if carry.status == FrontendStatus.LOST:
            # Reset (frontend_g2o.cpp:351-366): wipe the map, re-init next frame.
            frame_span.set(branch="lost")
            fresh = initial_carry(cfg, tuple(img_l.shape), img_l.dtype, img_l.device)
            out = FrameOutput(T_cw=carry.T_cur, status=fresh.status, kf_inserted=False, n_inliers=0,
                              ba_chi=no_ba.chi, n_tracked=zero, n_new_landmarks=zero, ba=no_ba)
            return fresh.replace(pyr_last=pyr_l), out

        # Track (frontend_g2o.cpp:48-75).
        with timer.span("prior"):
            T_prior = constant_velocity_prior(carry.rel_motion, carry.T_cur)
        with timer.span("track"):
            feats = frontend_mod.track_last_frame(
                cfg, rig, carry.pyr_last, pyr_l, carry.feats, carry.wmap.lm_pos, T_prior, rel_motion=carry.rel_motion
            )
            n_tracked = feats.count()
        with timer.span("pose"):
            T_new, feats, n_in_t = frontend_mod.estimate_current_pose(cfg, rig, feats, carry.wmap.lm_pos, T_prior)
        n_in = timer.read(n_in_t, "inliers")  # the frame's one explicit device read
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
        frame_span.set(branch="keyframe" if insert else "track")
        wmap, ba = carry.wmap, no_ba
        if insert:
            pyr_r = pyramid_right()
            with timer.span("insert"):
                feats, wmap = frontend_mod.insert_keyframe(cfg, rig, pyr_l, pyr_r, img_l, feats, wmap, T_new,
                                                           frame_id)
            wmap, ba = run_ba(wmap)
        with timer.span("motion"):
            rel = se3.se3_orthonormalize(se3.compose(T_new, se3.se3_inv(carry.T_cur)))
        out = FrameOutput(T_cw=T_new, status=int(status), kf_inserted=insert, n_inliers=n_in, ba_chi=ba.chi,
                          n_tracked=n_tracked, n_new_landmarks=wmap.lm_next - carry.wmap.lm_next, ba=ba)
        since_kf = 0 if insert else carry.frames_since_kf + 1
        return VOCarry(int(status), feats, wmap, T_new, rel, pyr_l, since_kf), out


def _stack(values: list, device) -> torch.Tensor:
    if torch.is_tensor(values[0]):
        return torch.stack(values)
    return torch.tensor(values, dtype=torch.bool if isinstance(values[0], bool) else torch.int32, device=device)


def stack_outputs(outs: List[FrameOutput]) -> FrameOutput:
    """F per-frame outputs as one `FrameOutput` whose fields (and `ba`'s)
    carry a leading F axis; host values become tensors on the frames'
    device (no device read)."""
    dev = outs[0].T_cw.device
    ba = backend_mod.BAStats(*(_stack([o.ba[i] for o in outs], dev) for i in range(len(backend_mod.BAStats._fields))))
    return FrameOutput(**{f.name: ba if f.name == "ba" else _stack([getattr(o, f.name) for o in outs], dev)
                          for f in dataclasses.fields(FrameOutput)})


def process_chunk(
    cfg: frontend_mod.FrontendConfig,
    rig: StereoRig,
    carry: VOCarry,
    imgs_l: torch.Tensor,
    imgs_r: torch.Tensor,
    frame_ids,
    ba_cfg: backend_mod.BAConfig = backend_mod.BAConfig(),
    inline_ba: bool = True,
    ba_solve_fn=None,
) -> Tuple[VOCarry, FrameOutput]:
    """Offline / throughput mode: `process_frame` over F stacked stereo
    frames (`imgs_l`, `imgs_r`: (F, H, W) on the frames' device;
    `frame_ids`: F ints), the outputs stacked on a leading F axis
    (`stack_outputs`).  The reference scans the frame step into one
    program; here it is a loop, so a chunk costs what its frames cost one
    by one, host reads included (one inlier-count read per tracking frame,
    one per LM attempt of window BA, and the implicit ones that the `read`
    spans of utils/timer.py name).  `VisualOdometry`'s hooks (loop closure,
    async BA, the viewer) are not run."""
    outs = []
    for img_l, img_r, frame_id in zip(imgs_l, imgs_r, torch.as_tensor(frame_ids).tolist()):
        carry, out = process_frame(cfg, rig, carry, img_l, img_r, int(frame_id), ba_cfg, inline_ba, ba_solve_fn)
        outs.append(out)
    return carry, stack_outputs(outs)


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
        ba_solve_fn=None,
    ):
        self.config = config or (Config.from_yaml(config_path) if config_path else Config())
        self.dataset = dataset
        ba_mode = ba_mode or self.config["ba_mode"]
        if ba_mode not in ("inline", "async", "off"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        self.ba_mode = ba_mode
        self.ba_solve_fn = ba_solve_fn
        self.async_backend = None
        self.device = torch.device(device)
        self.frontend_cfg: Optional[frontend_mod.FrontendConfig] = None
        self.rig: Optional[StereoRig] = None
        self.ba_cfg: Optional[backend_mod.BAConfig] = None
        self.loop_closer = None
        self.viewer = None
        self._hook_prev: Optional[Tuple[StereoFrame, FrameOutput]] = None
        self._pending_correction: Optional[torch.Tensor] = None
        self.carry: Optional[VOCarry] = None
        self.outputs: List[FrameOutput] = []
        self.frame_ids: List[int] = []
        self.log_every = 0

    # --- reference API (visual_odometry.h:27-49) ---
    def init(self) -> bool:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VisualOdometry: no CUDA device for device='cuda'; "
                               "pass device='cpu' to run the plain versions on the CPU")
        if self.dataset is None:
            self.dataset = KittiDataset(self.config["dataset_dir"], scale=self.config["image_scale"])
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
            assembly_precision=str(self.config["ba_assembly_precision"]),
        )
        schur.check_engine(self.ba_cfg.engine)
        if self.frontend_cfg.use_marg_prior and self.ba_solve_fn is not None:
            raise ValueError("use_marg_prior is not supported with an injected ba_solve_fn "
                             "(distributed BA): the prior needs the single-device solver")
        self.async_backend = None
        if self.ba_mode == "async":
            from legoslam_tpu_torch.pipeline.async_backend import AsyncBackend, pick_ba_device

            self.async_backend = AsyncBackend(
                self.frontend_cfg, self.rig, self.ba_cfg, solve_fn=self.ba_solve_fn,
                ba_device=pick_ba_device(str(self.config["ba_async_device"]), self.device),
                dispatch_every=int(self.config["ba_async_dispatch_every"]), device=self.device,
            )
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
        # Live viewer stream (viewer.cpp:38-97's continuous redraw, every N
        # frames): opt-in, it reads the feature table from the device.
        viz_n = int(self.config["viewer_every_n"])
        if viz_n > 0:
            from legoslam_tpu_torch.pipeline.viewer import Viewer

            self.viewer = Viewer(every_n=viz_n)
        else:
            self.viewer = None
        self._hook_prev = None
        self._pending_correction = None
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
        ab = self.async_backend
        if ab is not None:
            # Merge a finished solve before this frame tracks (never blocks).
            self.carry = self.carry.replace(wmap=ab.poll(self.carry.wmap))
        self.carry, out = process_frame(self.frontend_cfg, self.rig, self.carry, img_l, img_r,
                                        int(frame.frame_id), self.ba_cfg, self.ba_mode == "inline",
                                        self.ba_solve_fn)
        if ab is not None:
            ab.observe(out.kf_inserted)
            if ab.want_dispatch:
                ab.dispatch(self.carry.wmap)
        if self.loop_closer is not None:
            self._loop_hook(frame, out)
        if self.viewer is not None:
            self._viewer_hook(frame, out)
        self.outputs.append(out)
        self.frame_ids.append(frame.frame_id)
        if self.log_every > 0 and len(self.outputs) % self.log_every == 0:
            self._log_frame(frame.frame_id, out)
        return out

    def _loop_hook(self, frame: StereoFrame, out: FrameOutput) -> None:
        """Feed the loop closer: the frame after each keyframe is the one
        registered (its pose, features and landmark positions describe one
        frame, estimated against the map BA just refined), and a LOST frame
        resets the closer when the next frame arrives.  A correction held
        from the last registration is applied first, to the carry after
        this frame, as the reference's hook applies it when it reads its
        snapshot a frame late; the reference never drops one, LOST or not."""
        self._apply_pending_correction()
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
        loop closes, hold the correction for `_apply_pending_correction`."""
        with timer.span("loop", frame=int(frame.frame_id)) as sp:
            feats, wmap = self.carry.feats, self.carry.wmap
            M = feats.uv.shape[0]
            sel = feats.valid & (feats.lm >= 0)
            pw = wmap.lm_pos[torch.clamp(feats.lm, min=0).long()]
            with timer.reading("loop_register"):
                v = torch.cat([T_cw.reshape(-1), feats.uv.reshape(-1), sel.to(T_cw.dtype),
                               pw.reshape(-1)]).cpu().numpy()
            uv = v[16:16 + 2 * M].reshape(M, 2)
            keep = v[16 + 2 * M:16 + 3 * M] > 0.5
            p_world = v[16 + 3 * M:].reshape(M, 3)
            result = self.loop_closer.add_keyframe(int(frame.frame_id), np.asarray(frame.left),
                                                   v[:16].reshape(4, 4), uv[keep], p_world[keep])
            if result is not None:
                self._pending_correction = torch.as_tensor(result[1], dtype=torch.float32).to(self.device)
            sp.set(records=len(self.loop_closer.records), closed=int(result is not None))

    def _apply_pending_correction(self) -> None:
        G, self._pending_correction = self._pending_correction, None
        if G is not None:
            with timer.span("loop_apply"):
                if self.async_backend is not None:
                    # A solve in flight was linearized in the old world frame:
                    # settle it before re-anchoring.
                    self.carry = self.carry.replace(wmap=self.async_backend.flush(self.carry.wmap))
                self.carry = _apply_world_correction(self.carry, G)

    def _drain_hooks(self) -> None:
        """End of stream: a held correction is applied; the last frame's
        flags were never consumed, and a trailing keyframe (often the one
        that closes a loop) is registered from the final carry, which still
        describes that frame, its correction applied at once."""
        if self.loop_closer is None:
            return
        self._apply_pending_correction()
        prev, self._hook_prev = self._hook_prev, None
        if prev is not None:
            frame, out = prev
            self._consume_flags(out, frame, out.T_cw)
        self._apply_pending_correction()

    def _viewer_hook(self, frame: StereoFrame, out: FrameOutput) -> None:
        """Feed the live viewer stream: T_cw every frame, a feature overlay
        every N frames, a map snapshot on keyframe events (viewer.cpp:19-36)."""
        vw = self.viewer
        if len(self.outputs) % vw.every_n == 0:
            feats = self.carry.feats
            vw.add_current_frame(out.T_cw, frame.left, feats.uv, feats.valid)
        else:
            vw.add_current_frame(out.T_cw)
        if out.kf_inserted:
            wmap = self.carry.wmap
            vw.update_map(wmap.kf_pose, wmap.kf_valid, wmap.lm_pos, wmap.lm_active_mask())

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
        t_total = timer.Timer(self.device)
        n = 0
        while self.step():
            n += 1
        self.flush_ba()
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

    def flush_ba(self) -> None:
        """Settle the asynchronous backend: merge the solve in flight, and
        run one last solve if the cadence is due (the reference's backend
        likewise drains its last UpdateMap before Stop)."""
        ab = self.async_backend
        if ab is None or self.carry is None:
            return
        wmap = ab.flush(self.carry.wmap)
        if ab.want_dispatch:
            ab.dispatch(wmap)
            wmap = ab.flush(wmap)
        self.carry = self.carry.replace(wmap=wmap)
        log.info("async BA: %d solves dispatched, %d merged, %d keyframe events coalesced while busy",
                 ab.stats["dispatched"], ab.stats["merged"], ab.stats["skipped"])

    # --- results ---
    def frontend_status(self) -> FrontendStatus:
        return FrontendStatus(self.carry.status) if self.carry is not None else FrontendStatus.INITING

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

    # --- checkpoint / resume ---
    def save_checkpoint(self, path: str) -> str:
        """Write the run's state (utils/checkpoint.py) after draining the
        loop hook, whose pending frame is not state; returns the path."""
        from legoslam_tpu_torch.utils import checkpoint

        self.flush_ba()
        self._drain_hooks()
        return checkpoint.save_vo_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from legoslam_tpu_torch.utils import checkpoint

        checkpoint.load_vo_checkpoint(path, self)

    # --- export / visualization ---
    def save_trajectory(self, path: str, fmt: str = "kitti") -> None:
        from legoslam_tpu_torch.utils import evaluation

        T_wc = self.trajectory_T_wc()
        if fmt == "tum":
            evaluation.save_tum_trajectory(path, [float(i) for i in self.frame_ids], T_wc)
        elif fmt == "kitti":
            evaluation.save_kitti_trajectory(path, T_wc)
        else:
            raise ValueError(f"unknown trajectory format {fmt!r}; expected 'kitti' or 'tum'")

    def save_visualization(self, out_dir: str, ground_truth=None, last_frame=None) -> List[str]:
        """Render the reference viewer's artifacts headlessly (pipeline/viewer.py).

        With `viewer_every_n` > 0 the live stream collected during the run is
        rendered (per-frame overlays + follow-mode local map + GIF);
        otherwise only the final state.  Returns the paths written (none
        where matplotlib is missing)."""
        from legoslam_tpu_torch.pipeline.viewer import Viewer

        if self.viewer is not None:
            if self.carry is not None:
                wmap = self.carry.wmap
                self.viewer.update_map(wmap.kf_pose, wmap.kf_valid, wmap.lm_pos, wmap.lm_active_mask())
            return self.viewer.save(out_dir, ground_truth=ground_truth)
        viewer = Viewer()
        for T_cw in (self.trajectory_T_cw() if self.outputs else []):
            viewer.add_current_frame(T_cw)
        if self.carry is not None:
            wmap = self.carry.wmap
            viewer.update_map(wmap.kf_pose, wmap.kf_valid, wmap.lm_pos, wmap.lm_alive)
            if last_frame is not None:
                feats = self.carry.feats
                viewer.last_frame_img = last_frame
                viewer.last_features = feats.uv[feats.valid].cpu().numpy()
        return viewer.save(out_dir, ground_truth=ground_truth)
