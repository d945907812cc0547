"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Device: the CUDA card's name, and its name and power limit from
   nvidia-smi.  Exits non-zero without a CUDA device.
2. Build: both CUDA kernels from legoslam_tpu_torch/csrc (nvcc, sm_90a).
3. Kernels against their plain PyTorch versions at the main path's shapes:
   the anchored pyramid KLT (512 lanes, 3 levels of 188x620) and the pose
   estimate (512 edges), with the agreement bars stated below and median
   times from CUDA events.
4. The slice: 40 frames of the plane-world benchmark sequence through
   `VisualOdometry(ba_mode="off", device="cuda")`; every frame must track
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, reps: int) -> float:
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

    # --- 2. build ---------------------------------------------------------
    for name in ("klt_anchored", "pose"):
        t0 = time.perf_counter()
        _build.load(name)
        print(f"build {name}: {time.perf_counter() - t0:.2f} s ({_build.library_path(name).name})", flush=True)

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
    kp_k, ok_k = klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, kcfg)
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg)
    torch.cuda.synchronize()
    agree = float((ok_k == ok_e).float().mean())
    both = ok_k & ok_e
    err = float((kp_k - kp_e)[both].abs().max()) if bool(both.any()) else float("nan")
    print(f"K1 klt: masks agree {agree:.4f} (bar {KLT_MASK_AGREE}), success kernel {int(ok_k.sum())} "
          f"plain {int(ok_e.sum())}, max |dpos| {err:.2e} px over {int(both.sum())} lanes (bar {KLT_POS_ATOL})",
          flush=True)
    check(agree >= KLT_MASK_AGREE, "K1 masks disagree with the plain version")
    check(int(both.sum()) >= LANES // 4, "K1 tracked too few lanes")
    check(err <= KLT_POS_ATOL, "K1 positions disagree with the plain version")
    ms = median_ms(lambda: klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, kcfg), 50)
    plain = median_ms(lambda: klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg), 20)
    print(f"K1 klt: kernel {ms:.4f} ms, plain {plain:.4f} ms (median)", flush=True)
    results.append({"name": "klt_pyramid_anchored", "route": "cuda",
                    "source": "legoslam_tpu_torch/csrc/klt_anchored.cu",
                    "replaces": "legoslam_tpu/ops/klt_pallas.py:329,414",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain})

    intr, T_prior, P, uv, pvalid, T_true = pose_inputs(dev)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T_prior, P, uv, pvalid)
    T_e, in_e, n_e = pose_k.estimate_pose_eager(intr, T_prior, P, uv, pvalid)
    torch.cuda.synchronize()
    terr = float((T_k - T_e).abs().max())
    tru = float(np.abs(T_k.double().cpu().numpy() - T_true).max())
    iagree = float((in_k == in_e).float().mean())
    print(f"K2 pose: max |dT| {terr:.2e} (bar {POSE_T_ATOL}), |T - T_true| {tru:.2e}, inliers agree "
          f"{iagree:.4f} (bar {POSE_INLIER_AGREE}), n_in kernel {int(n_k)} plain {int(n_e)}", flush=True)
    check(terr <= POSE_T_ATOL, "K2 pose disagrees with the plain version")
    check(tru <= 5e-3, "K2 pose misses the true pose")
    check(iagree >= POSE_INLIER_AGREE, "K2 inliers disagree with the plain version")
    ms = median_ms(lambda: pose_k.estimate_pose_kernel(intr, T_prior, P, uv, pvalid), 50)
    plain = median_ms(lambda: pose_k.estimate_pose_eager(intr, T_prior, P, uv, pvalid), 10)
    print(f"K2 pose: kernel {ms:.4f} ms, plain {plain:.4f} ms (median)", flush=True)
    results.append({"name": "estimate_pose", "route": "cuda", "source": "legoslam_tpu_torch/csrc/pose.cu",
                    "replaces": "legoslam_tpu/solver/pose_pallas.py:311",
                    "max_abs_err": terr, "ms": ms, "plain_ms": plain})

    # --- 4. the slice -------------------------------------------------------
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    vo = VisualOdometry(config=config, dataset=_FrameList(frames, ds.rig), ba_mode="off", device=dev)
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
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"], "replaces": r["replaces"],
                "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for r in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
