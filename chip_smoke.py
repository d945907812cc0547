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
4. The slice: 40 frames of the plane-world benchmark sequence through
   `VisualOdometry(ba_mode="off")` on the card; every frame must track
   (TRACKING_GOOD), 7-9 keyframes, both kernels launched on every tracking
   frame, ATE < 0.05 m.

Prints one JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises, so the script exits
non-zero and prints no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
ATE_MAX = 0.05            # m, the JAX reference gets 0.0047 m on these frames
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

    # --- 4. the slice -------------------------------------------------------
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    vo = VisualOdometry(config=config, dataset=_FrameList(frames, ds.rig), ba_mode="off")  # the card by default
    check(vo.device.type == "cuda", f"VisualOdometry defaults to {vo.device}")
    check(vo.init(), "VisualOdometry.init failed")
    klt_k.klt_pyramid_anchored_kernel.launches = 0
    pose_k.estimate_pose_kernel.launches = 0
    for _ in range(WARMUP):
        vo.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while vo.step():
        pass
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"klt_pyramid_anchored": klt_k.klt_pyramid_anchored_kernel.launches,
                "estimate_pose": pose_k.estimate_pose_kernel.launches}
    statuses = vo.statuses()
    n_kf = int(vo.keyframe_flags().sum())
    T_wc = vo.trajectory_T_wc()
    ate = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    n_track = N_FRAMES - 1
    timed = N_FRAMES - WARMUP
    print(f"slice: {N_FRAMES} frames, statuses {statuses.tolist()}", flush=True)
    print(f"slice: keyframes {n_kf} (JAX reference: 8), launches {launches} (tracking frames {n_track}), "
          f"ATE {ate:.5f} m (bar {ATE_MAX}; JAX reference 0.0047 m)", flush=True)
    print(f"slice: {1e3 * dt / timed:.3f} ms/frame, {timed / dt:.2f} frames/s over frames {WARMUP}..{N_FRAMES - 1} "
          f"on {kind} ({smi})", flush=True)
    check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), "a frame did not track")
    check(7 <= n_kf <= 9, f"{n_kf} keyframes, expected 7-9")
    check(all(n >= n_track for n in launches.values()), "a kernel was not launched on every tracking frame")
    check(bool(np.isfinite(T_wc).all()), "non-finite trajectory")
    check(ate < ATE_MAX, f"ATE {ate:.4f} m")
    # library_ms: no single PyTorch call computes either function.
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"], "replaces": r["replaces"],
                "launches": launches[r["name"]], "launches_per_frame": launches[r["name"]] / n_track,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bound_kind": r["bound_by"],
                "library_ms": None, "work": r["work"]} for r in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
