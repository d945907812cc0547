"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Device: the CUDA card's name, and its name and power limit from
   nvidia-smi.  Exits non-zero without a CUDA device.
2. Build: both CUDA kernels from legoslam_tpu_torch/csrc (nvcc, sm_90a).
3. Kernels against their plain PyTorch versions at the main path's shapes:
   the anchored pyramid KLT (512 lanes, 3 levels of 188x620) and the pose
   estimate (512 edges), with the agreement bars stated below, their work
   counts (GN lane-iterations, LM attempts) against the plain versions',
   the roofline bound of that work on this card, and median times from
   CUDA events (`device_ms`: the kernel's device time per launch;
   `wall_ms`: a whole call of the plain version, host syncs included).
4. The BA-off slice: 40 frames of the plane-world benchmark sequence
   through `VisualOdometry(ba_mode="off")` on the card; every frame must
   track (TRACKING_GOOD), 7-9 keyframes, both kernels launched on every
   tracking frame, ATE < 0.05 m.
5. The BA-inline slice, the default path: the same 40 frames through
   `VisualOdometry(config)` with no `ba_mode`, so window BA runs after every
   keyframe (`backend.ba_step`, PyTorch ops on the card).  Every frame must
   track, every keyframe frame must carry a finite BA chi, the keyframe
   count must be within 1 of the JAX reference's, both kernels launched on
   every tracking frame, ATE < 0.05 m.  Prints ms/frame split into tracking
   and keyframe frames, and keyframe frames into BA and the rest.
6. Window BA at full width (K=16 window slots, L=2048 active landmarks,
   E=5120 edges, 512 feature lanes, 131,072 landmarks): the map of step 5
   just before its last keyframe's BA goes through `backend.ba_step` on the
   card and, copied, on the CPU (the same port code); final chi, keyframe
   poses, outlier verdicts and observation counts must agree (bars below).
   Prints the card's wall ms per `ba_step`, LM iterations and attempts, the
   host reads counted by CUDA's sync debug mode, and the landmark counts.

The kernel launch counts are set to 0 just before each slice and read just
after it.  Prints one JSON line of per-kernel results, then, as the last
line, {"ok": true, "device": {...}}.  Any failed check raises, so the script
exits non-zero and prints no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SHAPE = (188, 620)        # KITTI half resolution
N_FRAMES = 40
WARMUP = 4
LANES = 512
SEED = 0
# Agreement bars, kernel vs plain version on identical inputs.
KLT_MASK_AGREE = 0.99     # success masks
KLT_POS_ATOL = 1e-2       # px, where both succeed
POSE_T_ATOL = 1e-3        # pose entries
POSE_INLIER_AGREE = 0.99
ATE_MAX = 0.05            # m, the JAX reference gets 0.0047 m on these frames (BA off)
# The JAX reference's BA-inline run of the same 40 frames (VisualOdometry,
# ba_mode inline, ba_assembly_precision f32, on the CPU; printed by
# `python -m tests.ba_parity_report --bench-world`): 8 keyframes, every
# frame TRACKING_GOOD, ATE 0.019379 m.
REF_INLINE_KEYFRAMES = 8
REF_INLINE_ATE = 0.019379
# Window BA, card against CPU on the same map (same port code; the sums of
# `index_add_` run in another order on the card): final chi relative, poses
# relative to the oldest keyframe (every window pose is free, so the
# window's rigid placement is held only by the LM damping), verdict masks.
BA_CHI_RTOL = 1e-3
BA_POSE_ATOL = 1e-3
BA_MASK_AGREE = 0.99
# Work counts, kernel vs plain version.  A lane moved by one GN step moves
# the KLT count by one: max(atol, rtol * plain).  Near convergence a pose
# step's chi change is at the float rounding level, so one run may accept it
# and stop where the other rejects it and runs a rejection chain of up to
# false_cnt_threshold (10) attempts: per round, at most 10 + 3 apart.
KLT_WORK_TOL = (8, 0.02)
POSE_ROUND_TOL = 13

# Roofline of one H100 SXM (NVIDIA's data sheet; at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
# FLOPs of one KLT GN iteration: 81 bilinear samples (three lerps of 4),
# 49 residual/gradient terms (err 1, gradients 4, cost 2, H 6, b 4), the
# 2x2 solve; of one lane's ZNCC gate: 49 samples and 49 x 8 for the sums.
KLT_FLOP_PER_ITER = 81 * 12 + 49 * 17 + 20
KLT_FLOP_ZNCC = 49 * 12 + 49 * 8
# FLOPs of one pose edge per LM pass: projection and Jacobian (~40), Huber
# weights (~15), the 21 + 6 + 1 sums (~135).
POSE_FLOP_PER_EDGE = 190


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def wall_ms(fn, reps: int) -> float:
    """Median of CUDA events around one whole call (host time included
    wherever the device waits for the host)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 50, trials: int = 5) -> float:
    """Median over `trials` of the device time per launch: `reps` launches
    queued back to back behind a sleep kernel, so the host's time to enqueue
    them is hidden, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0  # an upper bound of one launch's host time
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2.0 * reps * enqueue_s + 1e-3)))  # >= that long at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def bound(flop: float, nbytes: float):
    """(ms, kind): the least time the card could take for this work."""
    t_ops, t_bytes = flop / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")




def bench_world(n_frames: int):
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset

    # bench.py's plane world: focal 360, baseline 0.54, speed 0.12.
    return SyntheticPlanesDataset(n_frames=n_frames, shape=SHAPE, focal=360.0, baseline=0.54,
                                  speed=0.12, half_width=10.0, length=200.0)


def klt_inputs(frames, dev):
    """512 anchored lanes from frame 0's corners, tracked into frame 1 from
    guesses a few px off."""
    from legoslam_tpu_torch.ops import detect, klt, pyramid

    img0 = torch.from_numpy(frames[0][0]).to(dev)
    img1 = torch.from_numpy(frames[1][0]).to(dev)
    kp, ok = detect.detect(img0, detect.GFTTConfig(max_corners=LANES, min_distance=4, border=8))
    check(int(ok.sum()) >= LANES // 2, f"only {int(ok.sum())} corners")
    cfg = klt.KLTConfig(levels=3)
    anchors = klt.extract_anchors(pyramid.build_pyramid(img0, 4), kp, cfg._replace(levels=4))
    rng = np.random.default_rng(SEED)
    guess = kp + torch.from_numpy(rng.uniform(-3.0, 3.0, (LANES, 2)).astype(np.float32)).to(dev)
    valid = ok & torch.from_numpy(rng.uniform(size=LANES) > 0.05).to(dev)
    return anchors.contiguous(), kp.contiguous(), tuple(pyramid.build_pyramid(img1, 4)), guess, valid, cfg


def pose_inputs(dev):
    """512 edges: a known pose, noisy projections, 10% gross outliers."""
    from legoslam_tpu_torch.geometry import se3
    from legoslam_tpu_torch.solver import reprojection

    rng = np.random.default_rng(SEED)
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    z = rng.uniform(4.0, 60.0, LANES)
    P = np.stack([rng.uniform(-0.8, 0.8, LANES) * z, rng.uniform(-0.3, 0.3, LANES) * z, z], -1)
    T_true = se3.se3_exp(torch.tensor([0.1, -0.05, 0.3, 0.01, 0.02, -0.01])).double().numpy()
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[: LANES // 10] += rng.normal(0, 30.0, (LANES // 10, 2))
    valid = rng.uniform(size=LANES) > 0.05
    T_prior = se3.se3_exp(torch.tensor([0.12, -0.03, 0.25, 0.0, 0.025, 0.0]))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)).to(dtype).to(dev).contiguous()

    return intr, T_prior.to(dev), t(P), t(uv), t(valid, torch.bool), T_true


class _FrameList:
    def __init__(self, frames, rig):
        self.frames, self.rig, self.i = frames, rig, 0

    def init(self):
        self.i = 0
        return True

    def next_frame(self):
        from legoslam_tpu_torch.pipeline.dataset import StereoFrame

        if self.i >= len(self.frames):
            return None
        left, right = self.frames[self.i]
        self.i += 1
        return StereoFrame(self.i - 1, left, right)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}", flush=True)
    print(smi, flush=True)  # name, power limit as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    from legoslam_tpu_torch.kernels import _build
    from legoslam_tpu_torch.kernels import klt as klt_k
    from legoslam_tpu_torch.kernels import pose as pose_k

    # --- 2. build: one nvcc per source, all started together --------------
    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return f"build {name}: {time.perf_counter() - t0:.2f} s ({_build.library_path(name).name})"

    with ThreadPoolExecutor() as pool:
        for line in pool.map(build, ("klt_anchored", "pose")):
            print(line, flush=True)

    # --- 3. kernels against plain versions ---------------------------------
    ds = bench_world(N_FRAMES)
    ds.init()
    t0 = time.perf_counter()
    frames = []
    for _ in range(N_FRAMES):
        fr = ds.next_frame()
        frames.append((fr.left, fr.right))
    print(f"rendered {N_FRAMES} frames of {SHAPE[0]}x{SHAPE[1]} in {time.perf_counter() - t0:.1f} s", flush=True)

    results = []
    anchors, kp, pyr1, guess, valid, kcfg = klt_inputs(frames, dev)
    it_k = torch.zeros((1,), dtype=torch.int32, device=dev)
    it_e = torch.zeros((1,), dtype=torch.int32, device=dev)
    kp_k, ok_k = klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, kcfg, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg, gn_iterations=it_e)
    torch.cuda.synchronize()
    agree = float((ok_k == ok_e).float().mean())
    both = ok_k & ok_e
    err = float((kp_k - kp_e)[both].abs().max()) if bool(both.any()) else float("nan")
    gn_k, gn_e = int(it_k), int(it_e)
    print(f"K1 klt: masks agree {agree:.4f} (bar {KLT_MASK_AGREE}), success kernel {int(ok_k.sum())} "
          f"plain {int(ok_e.sum())}, max |dpos| {err:.2e} px over {int(both.sum())} lanes (bar {KLT_POS_ATOL})",
          flush=True)
    print(f"K1 klt: GN lane-iterations kernel {gn_k} plain {gn_e} (bar max{KLT_WORK_TOL})", flush=True)
    check(agree >= KLT_MASK_AGREE, "K1 masks disagree with the plain version")
    check(int(both.sum()) >= LANES // 4, "K1 tracked too few lanes")
    check(err <= KLT_POS_ATOL, "K1 positions disagree with the plain version")
    check(abs(gn_k - gn_e) <= max(KLT_WORK_TOL[0], KLT_WORK_TOL[1] * gn_e),
          "K1 work count disagrees with the plain version")
    levels = kcfg.levels
    klt_bytes = (anchors.shape[0] * levels * anchors.shape[2] * anchors.shape[3] * 4
                 + sum(p.numel() * 4 for p in pyr1[:levels])
                 + kp.numel() * 4 + guess.numel() * 4 + valid.numel()   # inputs
                 + kp_k.numel() * 4 + ok_k.numel())                      # outputs
    klt_flop = gn_k * KLT_FLOP_PER_ITER + LANES * KLT_FLOP_ZNCC
    k1_bound, k1_kind = bound(klt_flop, klt_bytes)
    ms = device_ms(lambda: klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, kcfg))
    plain = wall_ms(lambda: klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg), 20)
    print(f"K1 klt: kernel {ms:.5f} ms/launch (device), plain {plain:.4f} ms/call (wall); bound {k1_bound:.6f} ms "
          f"({k1_kind}: {klt_flop / 1e6:.3f} MFLOP, {klt_bytes / 1e6:.3f} MB)", flush=True)
    results.append({"name": "klt_pyramid_anchored", "route": "cuda",
                    "source": "legoslam_tpu_torch/csrc/klt_anchored.cu",
                    "replaces": "legoslam_tpu/ops/klt_pallas.py:329,414",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": k1_bound, "bound_by": k1_kind,
                    "work": {"gn_lane_iterations": gn_k, "plain": gn_e}})

    intr, T_prior, P, uv, pvalid, T_true = pose_inputs(dev)
    outer = 4  # estimate_pose's default outer_iterations
    at_k = torch.zeros((outer,), dtype=torch.int32, device=dev)
    at_e = torch.zeros((outer,), dtype=torch.int32, device=dev)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T_prior, P, uv, pvalid, attempts=at_k)
    T_e, in_e, n_e = pose_k.estimate_pose_eager(intr, T_prior, P, uv, pvalid, attempts=at_e)
    torch.cuda.synchronize()
    terr = float((T_k - T_e).abs().max())
    tru = float(np.abs(T_k.double().cpu().numpy() - T_true).max())
    iagree = float((in_k == in_e).float().mean())
    a_k, a_e = at_k.tolist(), at_e.tolist()
    print(f"K2 pose: max |dT| {terr:.2e} (bar {POSE_T_ATOL}), |T - T_true| {tru:.2e}, inliers agree "
          f"{iagree:.4f} (bar {POSE_INLIER_AGREE}), n_in kernel {int(n_k)} plain {int(n_e)}", flush=True)
    print(f"K2 pose: LM attempts per round kernel {a_k} plain {a_e} (bar {POSE_ROUND_TOL} per round)", flush=True)
    check(terr <= POSE_T_ATOL, "K2 pose disagrees with the plain version")
    check(tru <= 5e-3, "K2 pose misses the true pose")
    check(iagree >= POSE_INLIER_AGREE, "K2 inliers disagree with the plain version")
    check(all(abs(x - y) <= POSE_ROUND_TOL for x, y in zip(a_k, a_e)),
          "K2 work count disagrees with the plain version")
    E = P.shape[0]
    pose_bytes = T_prior.numel() * 4 + E * (12 + 8 + 1) + T_k.numel() * 4 + E + 4
    pose_flop = (sum(a_k) + outer) * int(pvalid.sum()) * POSE_FLOP_PER_EDGE  # attempts + each round's first pass
    k2_bound, k2_kind = bound(pose_flop, pose_bytes)
    ms = device_ms(lambda: pose_k.estimate_pose_kernel(intr, T_prior, P, uv, pvalid))
    plain = wall_ms(lambda: pose_k.estimate_pose_eager(intr, T_prior, P, uv, pvalid), 10)
    print(f"K2 pose: kernel {ms:.5f} ms/launch (device), plain {plain:.4f} ms/call (wall); bound {k2_bound:.6f} ms "
          f"({k2_kind}: {pose_flop / 1e6:.3f} MFLOP, {pose_bytes / 1e3:.3f} kB)", flush=True)
    results.append({"name": "estimate_pose", "route": "cuda", "source": "legoslam_tpu_torch/csrc/pose.cu",
                    "replaces": "legoslam_tpu/solver/pose_pallas.py:311",
                    "max_abs_err": terr, "ms": ms, "plain_ms": plain, "bound_ms": k2_bound, "bound_by": k2_kind,
                    "work": {"lm_attempts": sum(a_k), "plain": sum(a_e)}})

    # --- 4. the BA-off slice -------------------------------------------------
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.state import Capacities
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    def reset_counts():
        klt_k.klt_pyramid_anchored_kernel.launches = 0
        pose_k.estimate_pose_kernel.launches = 0

    def read_counts():
        return {"klt_pyramid_anchored": klt_k.klt_pyramid_anchored_kernel.launches,
                "estimate_pose": pose_k.estimate_pose_kernel.launches}

    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    vo = VisualOdometry(config=config, dataset=_FrameList(frames, ds.rig), ba_mode="off")  # the card by default
    check(vo.device.type == "cuda", f"VisualOdometry defaults to {vo.device}")
    check(vo.init(), "VisualOdometry.init failed")
    reset_counts()
    for _ in range(WARMUP):
        vo.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while vo.step():
        pass
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_off = read_counts()
    statuses = vo.statuses()
    n_kf = int(vo.keyframe_flags().sum())
    T_wc = vo.trajectory_T_wc()
    ate = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    n_track = N_FRAMES - 1
    timed = N_FRAMES - WARMUP
    print(f"slice off: {N_FRAMES} frames, statuses {statuses.tolist()}", flush=True)
    print(f"slice off: keyframes {n_kf} (JAX reference: 8), launches {launches_off} (tracking frames {n_track}), "
          f"ATE {ate:.5f} m (bar {ATE_MAX}; JAX reference 0.0047 m)", flush=True)
    print(f"slice off: {1e3 * dt / timed:.3f} ms/frame, {timed / dt:.2f} frames/s over frames {WARMUP}..{N_FRAMES - 1} "
          f"on {kind} ({smi})", flush=True)
    check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), "a frame did not track (BA off)")
    check(7 <= n_kf <= 9, f"{n_kf} keyframes, expected 7-9 (BA off)")
    check(all(n >= n_track for n in launches_off.values()), "a kernel was not launched on every tracking frame")
    check(bool(np.isfinite(T_wc).all()), "non-finite trajectory (BA off)")
    check(ate < ATE_MAX, f"ATE {ate:.4f} m (BA off)")

    # --- 5. the BA-inline slice, the default path ---------------------------
    # Each ba_step of the driver is timed between two synchronizes, and the
    # arguments of the last one (the map just before its BA) are kept.
    ba_step = backend.ba_step
    ba_calls = []

    def timed_ba_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ba_step(*args)
        torch.cuda.synchronize()
        ba_calls.append((1e3 * (time.perf_counter() - t0), args))
        return out

    vo = VisualOdometry(config=config, dataset=_FrameList(frames, ds.rig))
    check(vo.ba_mode == "inline" and vo.device.type == "cuda", f"default ba_mode {vo.ba_mode}, device {vo.device}")
    check(vo.init(), "VisualOdometry.init failed (BA inline)")
    backend.ba_step = timed_ba_step
    try:
        reset_counts()
        frame_ms = []
        for _ in range(N_FRAMES):
            t0 = time.perf_counter()
            check(vo.step(), "the dataset ended early")
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        launches_inline = read_counts()
    finally:
        backend.ba_step = ba_step
    statuses = vo.statuses()
    kf = vo.keyframe_flags()
    n_kf = int(kf.sum())
    T_wc = vo.trajectory_T_wc()
    ate_inline = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    ba_chi = np.asarray([float(o.ba_chi) for o in vo.outputs])
    check(len(ba_calls) == n_kf, f"{len(ba_calls)} BA calls for {n_kf} keyframes")
    check(all(o.ba.chi.is_cuda for o in vo.outputs) and vo.carry.wmap.lm_pos.is_cuda, "BA left the card")
    ba_ms = dict(zip(np.nonzero(kf)[0].tolist(), (c[0] for c in ba_calls)))
    track = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if not kf[i]]
    kfs = [i for i in range(WARMUP, N_FRAMES) if kf[i]]
    print(f"slice inline: {N_FRAMES} frames, statuses {statuses.tolist()}", flush=True)
    print(f"slice inline: keyframes {n_kf} (JAX reference: {REF_INLINE_KEYFRAMES}), BA chi on keyframe frames "
          f"{[round(float(c), 4) for c in ba_chi[kf]]}, launches {launches_inline} (tracking frames {n_track}), "
          f"ATE {ate_inline:.5f} m (bar {ATE_MAX}; JAX reference {REF_INLINE_ATE} m)", flush=True)
    print(f"slice inline: {np.mean(frame_ms[WARMUP:]):.3f} ms/frame over frames {WARMUP}..{N_FRAMES - 1} "
          f"(each ends in a synchronize); tracking frames n={len(track)} median {np.median(track):.3f} ms; "
          f"keyframe frames n={len(kfs)} median {np.median([frame_ms[i] for i in kfs]):.3f} ms = BA median "
          f"{np.median([ba_ms[i] for i in kfs]):.3f} ms + rest median "
          f"{np.median([frame_ms[i] - ba_ms[i] for i in kfs]):.3f} ms; every ba_step (ms) "
          f"{[round(c[0], 3) for c in ba_calls]} on {kind} ({smi})", flush=True)
    check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), "a frame did not track (BA inline)")
    check(bool(np.isfinite(ba_chi[kf]).all()), "a keyframe frame has no finite BA chi")
    check(abs(n_kf - REF_INLINE_KEYFRAMES) <= 1, f"{n_kf} keyframes, JAX reference {REF_INLINE_KEYFRAMES}")
    check(all(n >= n_track for n in launches_inline.values()),
          "a kernel was not launched on every tracking frame (BA inline)")
    check(bool(np.isfinite(T_wc).all()), "non-finite trajectory (BA inline)")
    check(ate_inline < ATE_MAX, f"ATE {ate_inline:.4f} m (BA inline)")

    # --- 6. window BA at full width, card against CPU -----------------------
    cfg_b, rig_b, wmap_b, ba_cfg_b = ba_calls[-1][1]
    check(cfg_b.caps == Capacities(), f"BA capacities {cfg_b.caps} are not the defaults")
    check(wmap_b.kf_pose.is_cuda, "the BA map is not on the card")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            map_g, st_g = backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_reads = sum("synchroniz" in str(w.message) for w in caught)
    map_c, st_c = backend.ba_step(cfg_b, rig_b.to("cpu"), wmap_b.to("cpu"), ba_cfg_b)
    ms_ba = wall_ms(lambda: backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_b), 5)
    chi_g, chi_c = float(st_g.chi), float(st_c.chi)
    valid = wmap_b.kf_valid.cpu().numpy()
    oldest = int(np.argmax(valid))

    def relative(T):
        T = T.double().cpu().numpy()
        return (T @ np.linalg.inv(T[oldest]))[valid]

    pose_err = float(np.abs(relative(map_g.kf_pose) - relative(map_c.kf_pose)).max())
    pose_abs = float((map_g.kf_pose.cpu() - map_c.kf_pose).abs().max())
    agree = np.ones(tuple(wmap_b.kf_lm.shape), bool)
    mask_agree = []
    for name in ("kf_obs_left", "kf_obs_right"):
        a, b = getattr(map_g, name).cpu().numpy(), getattr(map_c, name).numpy()
        mask_agree.append(float((a == b).mean()))
        agree &= a == b
    kf_lm = wmap_b.kf_lm.cpu().numpy()
    ids = kf_lm[agree & (kf_lm >= 0)]
    obs_equal = bool((map_g.lm_obs.cpu().numpy()[ids] == map_c.lm_obs.numpy()[ids]).all())
    n_active, n_dropped = int(st_g.n_active_landmarks), int(st_g.n_dropped_landmarks)
    n_edges = int(backend.build_problem(cfg_b, rig_b, wmap_b)[0].graph.e_valid.sum())
    print(f"BA: K={cfg_b.caps.window} L={cfg_b.caps.active_landmarks} E={cfg_b.caps.ba_edges} lanes "
          f"{cfg_b.caps.max_features} landmarks {cfg_b.caps.landmarks}; {int(valid.sum())} keyframes, "
          f"{n_active} active landmarks, {n_dropped} dropped, {n_edges} edges", flush=True)
    print(f"BA: chi card {chi_g:.6f} cpu {chi_c:.6f} (rtol {BA_CHI_RTOL}); relative poses max |d| {pose_err:.2e} "
          f"(bar {BA_POSE_ATOL}; absolute {pose_abs:.2e}); masks agree {mask_agree} (bar {BA_MASK_AGREE}); "
          f"lm_obs equal where they agree: {obs_equal}; outliers card {int(st_g.n_outlier)} cpu {int(st_c.n_outlier)}",
          flush=True)
    print(f"BA: {ms_ba:.3f} ms per ba_step (card wall, median of 5); LM iterations {st_g.iterations} "
          f"attempts {st_g.attempts} (cpu: {st_c.iterations} / {st_c.attempts}); host reads {host_reads} "
          f"on {kind} ({smi})", flush=True)
    check(abs(chi_g - chi_c) <= BA_CHI_RTOL * abs(chi_c), "BA chi disagrees between card and CPU")
    check(pose_err <= BA_POSE_ATOL, "BA poses disagree between card and CPU")
    check(min(mask_agree) >= BA_MASK_AGREE, "BA outlier verdicts disagree between card and CPU")
    check(obs_equal, "BA observation counts disagree where the verdicts agree")
    check(np.isfinite(chi_g) and st_g.iterations >= 1, "BA did not run on the card")
    check(map_g.lm_pos.is_cuda and st_g.chi.is_cuda, "BA left the card")

    # library_ms: no single PyTorch call computes either function.
    launches = {k: launches_off[k] + launches_inline[k] for k in launches_off}
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"], "replaces": r["replaces"],
                "launches": launches[r["name"]], "launches_per_frame": launches[r["name"]] / (2 * n_track),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bound_kind": r["bound_by"],
                "library_ms": None, "work": r["work"]} for r in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
