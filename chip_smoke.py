"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Device: the CUDA card's name, and its name and power limit from
   nvidia-smi.  Exits non-zero without a CUDA device.
2. Build: the CUDA kernels from legoslam_tpu_torch/csrc (nvcc, sm_90a),
   while a pool of processes renders the two worlds (each once; every
   phase reuses the frames).
3. Kernels against their plain PyTorch versions at the main path's shapes:
   the anchored pyramid KLT (512 lanes, 3 levels of 188x620), the same
   kernel source in frame mode (consecutive frames, 512 lanes, 4 levels,
   forward then backward; and again at the loop closer's shapes, 256 lanes
   and 3 levels of 94x310 from quantized half-resolution images) and the
   pose estimate (512 edges), with the agreement bars stated below, their
   work counts (GN lane-iterations, LM attempts) against the plain
   versions', the roofline bound of that work on this card (the KLT bytes
   are those of the pixels the lanes' windows touch, not whole pyramids),
   and median times from CUDA events (`device_ms`: the kernel's device time
   per launch; `wall_ms`: a whole call of the plain version, host syncs
   included).
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

7. The reference-mode slice: the same 40 frames with `track_mode: frame`
   and `stereo_matcher: klt`, so tracking and stereo matching run the
   frame-mode KLT kernel with their forward-backward gates: never LOST,
   TRACKING_GOOD from frame 2, 2 frame-mode launches per tracking frame and
   2 per keyframe, ATE under the bar; and the same slice through the same
   code on the CPU (the plain versions): statuses equal, the two
   trajectories within the bar of each other after a rigid alignment.
8. The marginalization slice: a window of 4 active keyframes in 5 slots and
   a keyframe on every frame, `use_marg_prior` on, full width otherwise:
   never LOST, a prior present at the end, and `marginalize` of the run's
   last window information on the card against a CPU copy.
9. Loop closure at full width: a rounded-square course driven twice, with
   the detector shut (open arm) and open (closed arm), under
   torch.use_deterministic_algorithms(True) so that the arms are one run up
   to the first closure: at least one closure, keyframe ATE and full ATE
   lower closed than open, the frames the arms share bit for bit, the closer's stats, ms per verified candidate,
   frame-mode launches, and the host reads per registered keyframe.  The
   pyramids, features and mask of the closed arm's first accepted candidate
   are kept, and after the run the frame-mode kernel is held against its
   plain version on them, forward and backward, under the bars of step 3.

The kernel launch counts are set to 0 just before each slice and read just
after it.  Prints one JSON line of per-kernel results, then, as the last
line, {"ok": true, "device": {...}}.  Any failed check raises, so the script
exits non-zero and prints no result line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
import warnings
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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

# The JAX reference's run of the same 40 frames with track_mode frame and
# stereo_matcher klt (BA inline, f32, on the CPU; `python -m
# tests.ba_parity_report --bench-world`).
REF_MODES_KEYFRAMES = 8
REF_MODES_ATE = 0.043943
# Its ATE bar: frame-to-frame templates random-walk (the reference's note
# at legoslam_tpu/ops/klt.py:243-249), so this configuration sits at twice
# the default path's ATE in the reference too, and whatever moves a track by
# a hundredth of a pixel moves the trajectory.  The port's plain versions on
# a CPU end 0.002053 m from the reference there after a rigid alignment (ATE
# 0.042167 m; `python -m tests.ba_parity_report --only-bench-world`); on an
# NVIDIA H100 80GB HBM3 three runs with the kernels, two with the plain
# versions in their place and one on that host's CPU gave ATEs of 0.0403 to
# 0.0541 m and lay 0.0017 to 0.0207 m apart, the runs with the kernels no
# further from the others than from each other (scripts/modes_spread.py).
# So the slice is also run through the same code on the CPU here, and the
# card's trajectory is held to that one at twice the largest distance seen.
ATE_MAX_MODES = 0.08
MODES_CARD_CPU_APART = 0.04
# marginalize(), card against CPU on the same information (eigh on cuSOLVER
# against LAPACK): H and b relative to their largest entry.
MARG_RTOL = 1e-3
# The course of the loop-closure phase: a rounded square driven LAP_LAPS
# times (4 straights of LAP_SIDE frames and 4 raised-cosine quarter turns of
# LAP_TURN frames a lap, at LAP_SPEED m/frame), then LAP_TAIL frames straight
# on.  One lap with a 28-frame tail already closes (3 closures, keyframe ATE
# down each time), but a closure's own error is of the size of one lap's
# drift there, so the full ATE fell in one run and rose in another; with an
# 80-frame tail a revisit 2 m off is sometimes measured 1 m wrong, by the
# reference's closer too (tests/test_torch_loop.py); a third lap does not
# widen the margin (scripts/loop_course_scan.py).
#
# The two arms are the same code on the same frames, and the comparison
# means something only if they are the same run up to the first closure, as
# they are in the reference, which is deterministic.  The port on a card is
# not, left to itself: `index_add_` sums duplicate indices in no fixed order
# (solver/schur.py), and over a lap that rounding decides the drift.  Two
# runs with the detector shut on these very frames ended 0.191 and 0.476 m
# off (full ATE, NVIDIA H100 80GB HBM3), more than a closure gains, so
# arms drawn apart could and did come out in the wrong order (1 call of 10).
# This phase therefore runs under torch.use_deterministic_algorithms(True):
# the arms are then bit-equal up to the first closure (printed), and so are
# two calls (3 runs of each arm in one call of
# `scripts/loop_course_scan.py --deterministic --repeat 3 lap2`: one
# trajectory digest per arm; keyframe ATE 0.4172 -> 0.2307 m, full ATE
# 0.4165 -> 0.3171 m).
LAP_SIDE, LAP_TURN, LAP_SPEED, LAP_LAPS, LAP_TAIL = 32, 24, 0.3, 2, 4

# Roofline of one H100 SXM (NVIDIA's data sheet; at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
# FLOPs of one KLT GN iteration: 81 bilinear samples (three lerps of 4),
# 49 residual/gradient terms (err 1, gradients 4, cost 2, H 6, b 4), the
# 2x2 solve; of one lane's ZNCC gate: 49 samples and 49 x 8 for the sums.
KLT_FLOP_PER_ITER = 81 * 12 + 49 * 17 + 20
KLT_FLOP_ZNCC = 49 * 12 + 49 * 8
KLT_FLOP_TEMPLATE = 81 * 12   # frame mode samples its 9x9 template per lane and level
# FLOPs of one pose edge per LM pass: projection and Jacobian (~40), Huber
# weights (~15), the 21 + 6 + 1 sums (~135).
POSE_FLOP_PER_EDGE = 190
MAIN_KERNELS = ("klt_pyramid_anchored", "estimate_pose")  # launched on every tracking frame of the default path


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


KLT_WINDOW_RADIUS = 4     # the 9x9 halo window around a lane's position


def touched_pixels(shape, lo, hi) -> int:
    """Pixels of one pyramid level inside the union of the lanes' windows.
    Lane n's window centre moved within the box `lo[n]`..`hi[n]` (x, y in
    this level's pixels); bilinear sampling of the 9x9 halo window reads
    floor(centre - 4) .. floor(centre + 4) + 1, clamped to the image as
    ops/interp.py clamps."""
    h, w = shape
    lo, hi = np.asarray(lo, np.float64).reshape(-1, 2), np.asarray(hi, np.float64).reshape(-1, 2)
    x0 = np.clip(np.floor(lo[:, 0] - KLT_WINDOW_RADIUS), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(lo[:, 1] - KLT_WINDOW_RADIUS), 0, h - 1).astype(np.int64)
    x1 = np.clip(np.floor(hi[:, 0] + KLT_WINDOW_RADIUS) + 1, 0, w - 1).astype(np.int64)
    y1 = np.clip(np.floor(hi[:, 1] + KLT_WINDOW_RADIUS) + 1, 0, h - 1).astype(np.int64)
    cover = np.zeros((h + 1, w + 1), np.int64)  # a 2-D difference array of the boxes
    np.add.at(cover, (y0, x0), 1)
    np.add.at(cover, (y0, x1 + 1), -1)
    np.add.at(cover, (y1 + 1, x0), -1)
    np.add.at(cover, (y1 + 1, x1 + 1), 1)
    return int((cover.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def klt_window_bytes(pyr, scale, levels, valid, *tracks) -> int:
    """Bytes of `pyr`'s first `levels` levels that a launch must read: per
    level, the union over the valid lanes of the windows along each lane's
    way.  `tracks` are (N, 2) level-0 positions the lane's window visited
    (its start and, where it succeeded, its end); the window is taken to
    have stayed inside their bounding box, which undercounts a lane that
    strayed and came back, as a bound may."""
    valid = valid.cpu().numpy()
    pts = np.stack([t.detach().float().cpu().numpy()[valid] for t in tracks])  # (T, n, 2)
    pts = np.where(np.isfinite(pts), pts, pts[:1])
    lo, hi = pts.min(0), pts.max(0)
    return 4 * sum(touched_pixels(tuple(pyr[k].shape), lo * scale ** k, hi * scale ** k) for k in range(levels))


def bound(flop: float, nbytes: float):
    """(ms, kind): the least time the card could take for this work."""
    t_ops, t_bytes = flop / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def bench_world(n_frames: int):
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset

    # bench.py's plane world: focal 360, baseline 0.54, speed 0.12.
    return SyntheticPlanesDataset(n_frames=n_frames, shape=SHAPE, focal=360.0, baseline=0.54,
                                  speed=0.12, half_width=10.0, length=200.0)


def loop_trajectory(side=LAP_SIDE, turn=LAP_TURN, speed=LAP_SPEED, laps=LAP_LAPS, tail=LAP_TAIL):
    """T_wc of a rounded-square course (tests/test_loop_closure.py's
    `loop_trajectory`): the discrete lap closes exactly, so later laps
    revisit earlier poses; the yaw rate of a turn is a raised cosine, so the
    constant-velocity prior holds."""
    r = np.arange(turn)
    w = 0.5 * (1 - np.cos(2 * np.pi * (r + 0.5) / turn))
    w = w * (np.pi / 2 / w.sum())
    dyaws = np.concatenate([np.concatenate([np.zeros(side), w]) for _ in range(4 * laps)] + [np.zeros(tail)])
    poses, pos, yaw = [], np.zeros(3), 0.0
    for dy in dyaws:
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = pos
        poses.append(T)
        pos = pos + T[:3, :3] @ np.array([0.0, 0.0, speed])
        yaw += dy
    return np.stack(poses)


def lap_world(laps=LAP_LAPS, tail=LAP_TAIL):
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset

    return SyntheticPlanesDataset(shape=SHAPE, focal=360.0, baseline=0.54, half_width=20.0, length=30.0,
                                  z_min=-25.0, trajectory=loop_trajectory(laps=laps, tail=tail))


LAP = ("lap", LAP_LAPS, LAP_TAIL)


def world(kind):
    """The dataset of `"bench"` or of `("lap", laps, tail)`."""
    return bench_world(N_FRAMES) if kind == "bench" else lap_world(*kind[1:])


def render_chunk(kind, indices):
    """Frames `indices` of one world (runs in a worker process)."""
    ds = world(kind)
    out = []
    for i in indices:
        ds.current_index = i
        fr = ds.next_frame()
        out.append((fr.left, fr.right))
    return out


def render_worlds(pool, workers: int, kinds=("bench", LAP)):
    """Submit the worlds to the pool in interleaved chunks; returns a
    function that gathers {kind: frames}."""
    sizes = {kind: world(kind).n_frames for kind in kinds}
    jobs = []
    for kind, n in sizes.items():
        for w in range(workers):
            idx = list(range(w, n, workers))
            jobs.append((kind, idx, pool.submit(render_chunk, kind, idx)))

    def gather():
        out = {kind: [None] * n for kind, n in sizes.items()}
        for kind, idx, fut in jobs:
            for i, fr in zip(idx, fut.result()):
                out[kind][i] = fr
        return out

    return gather


def count_host_reads(fn):
    """(fn's result, device-to-host synchronizations it made), counted by
    CUDA's sync debug mode."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return out, sum("synchroniz" in str(w.message) for w in caught)


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


def hold_klt_frame(klt_k, label, pyr0, pyr1, kp, ok, cfg, min_tracked=None):
    """K1 in frame mode against its plain version on one pair of pyramids:
    forward from a zero-motion guess, backward over the lanes that succeeded
    and from the first image's positions (the forward-backward gates'
    pattern), under the bars of the anchored check.  Returns (largest position error, GN lane-iterations of the
    forward pass kernel and plain, forward positions and mask)."""
    dev = kp.device
    it_k = torch.zeros((1,), dtype=torch.int32, device=dev)
    it_e = torch.zeros((1,), dtype=torch.int32, device=dev)
    kp_k, ok_k = klt_k.klt_pyramid_kernel(pyr0, pyr1, kp, kp, ok, cfg, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_eager(pyr0, pyr1, kp, kp, ok, cfg, gn_iterations=it_e)
    bk_k, okb_k = klt_k.klt_pyramid_kernel(pyr1, pyr0, kp_k, kp, ok_k, cfg)
    bk_e, okb_e = klt_k.klt_pyramid_eager(pyr1, pyr0, kp_k, kp, ok_k, cfg)
    torch.cuda.synchronize()
    gn_k, gn_e = int(it_k), int(it_e)
    lanes = int(ok.sum())
    min_tracked = lanes // 4 if min_tracked is None else min_tracked
    err = 0.0
    for name, (a, oa), (b, ob) in (("forward", (kp_k, ok_k), (kp_e, ok_e)), ("backward", (bk_k, okb_k), (bk_e, okb_e))):
        agree = float((oa == ob).float().mean())
        both = oa & ob
        e = float((a - b)[both].abs().max()) if bool(both.any()) else float("nan")
        print(f"{label} {name}: masks agree {agree:.4f} (bar {KLT_MASK_AGREE}), success kernel {int(oa.sum())} "
              f"plain {int(ob.sum())}, max |dpos| {e:.2e} px over {int(both.sum())} lanes (bar {KLT_POS_ATOL})",
              flush=True)
        check(agree >= KLT_MASK_AGREE, f"{label} {name} masks disagree with the plain version")
        check(int(both.sum()) >= min_tracked, f"{label} {name} tracked too few lanes")
        check(e <= KLT_POS_ATOL, f"{label} {name} positions disagree with the plain version")
        err = max(err, e)
    rt = (bk_k - kp).norm(dim=-1)
    print(f"{label}: {kp.shape[0]} lanes ({lanes} valid), {cfg.levels} levels of {tuple(pyr0[0].shape)}; GN "
          f"lane-iterations kernel {gn_k} plain {gn_e} (bar max{KLT_WORK_TOL}); round trip under 0.8 px on "
          f"{int((okb_k & (rt < 0.8)).sum())} lanes", flush=True)
    check(abs(gn_k - gn_e) <= max(KLT_WORK_TOL[0], KLT_WORK_TOL[1] * gn_e),
          f"{label} work count disagrees with the plain version")
    return err, gn_k, gn_e, kp_k, ok_k


def check_klt_frame(frames, dev, klt_k):
    """K1 in frame mode against its plain version: frame 0 -> frame 1 of the
    bench world, 512 lanes from frame 0's corners, 4 levels, with its time
    and bound; then the same at the loop closer's shapes, as the closer
    makes them (`LoopCloser.add_keyframe`, `_verify`): every second pixel,
    quantized to uint8, 3 levels, 256 lanes at half the positions."""
    from legoslam_tpu_torch.ops import detect, klt, pyramid

    img0 = torch.from_numpy(frames[0][0]).to(dev)
    img1 = torch.from_numpy(frames[1][0]).to(dev)
    kp, ok = detect.detect(img0, detect.GFTTConfig(max_corners=LANES, min_distance=4, border=8))
    kp = kp.contiguous()
    cfg = klt.KLTConfig(levels=4)
    pyr0, pyr1 = tuple(pyramid.build_pyramid(img0, 4)), tuple(pyramid.build_pyramid(img1, 4))
    err, gn_k, gn_e, kp_k, ok_k = hold_klt_frame(klt_k, "K1 frame", pyr0, pyr1, kp, ok, cfg)
    n_valid = int(ok.sum())
    px0 = klt_window_bytes(pyr0, cfg.scale, cfg.levels, ok, kp)
    px1 = klt_window_bytes(pyr1, cfg.scale, cfg.levels, ok, kp, torch.where(ok_k[:, None], kp_k, kp))
    whole = sum(p.numel() * 4 for p in pyr0) + sum(p.numel() * 4 for p in pyr1)
    nbytes = px0 + px1 + 2 * kp.numel() * 4 + ok.numel() + kp_k.numel() * 4 + ok_k.numel()
    flop = gn_k * KLT_FLOP_PER_ITER + n_valid * cfg.levels * KLT_FLOP_TEMPLATE
    b_ms, b_kind = bound(flop, nbytes)
    ms = device_ms(lambda: klt_k.klt_pyramid_kernel(pyr0, pyr1, kp, kp, ok, cfg))
    plain = wall_ms(lambda: klt_k.klt_pyramid_eager(pyr0, pyr1, kp, kp, ok, cfg), 10)
    print(f"K1 frame: kernel {ms:.5f} ms/launch (device), plain {plain:.4f} ms/call (wall); bound {b_ms:.6f} ms "
          f"({b_kind}: {flop / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, of which the windows touch {px0 / 1e6:.3f} + "
          f"{px1 / 1e6:.3f} MB of the two pyramids' {whole / 1e6:.3f} MB)", flush=True)

    def closer_pyramid(img):
        half = img[::2, ::2].clamp(0.0, 255.0).to(torch.uint8).to(torch.float32).contiguous()
        return tuple(pyramid.build_pyramid(half, 3))

    half0, half1 = closer_pyramid(img0), closer_pyramid(img1)
    kp_h, ok_h, cfg_h = (kp[:256] * 0.5).contiguous(), ok[:256].contiguous(), cfg._replace(levels=3)
    err_h, gn_hk, gn_he, _, _ = hold_klt_frame(klt_k, "K1 frame at the loop closer's shapes", half0, half1,
                                               kp_h, ok_h, cfg_h)
    ms_h = device_ms(lambda: klt_k.klt_pyramid_kernel(half0, half1, kp_h, kp_h, ok_h, cfg_h))
    print(f"K1 frame at the loop closer's shapes: {ms_h:.5f} ms/launch (device)", flush=True)
    return {"name": "klt_pyramid_frame", "route": "cuda", "source": "legoslam_tpu_torch/csrc/klt_anchored.cu",
            "replaces": "legoslam_tpu/ops/klt_pallas.py:329,414 (through legoslam_tpu/ops/klt.py:202-215)",
            "max_abs_err": max(err, err_h), "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_kind,
            "work": {"gn_lane_iterations": gn_k, "plain": gn_e, "loop_closer_shapes_ms": ms_h,
                     "loop_closer_shapes_gn_lane_iterations": gn_hk, "loop_closer_shapes_plain": gn_he}}


class FrameList:
    """Rendered frames as a dataset."""

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
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's condition for reproducible products (step 9)
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

    # The worlds render in worker processes (spawned: they never touch the
    # card) while nvcc runs; the pool is closed before the first check.
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as procs:
        gather = render_worlds(procs, workers)
        with ThreadPoolExecutor() as pool:
            for line in pool.map(build, ("klt_anchored", "pose")):
                print(line, flush=True)
        worlds = gather()
    frames, lap_frames = worlds["bench"], worlds[LAP]
    ds = bench_world(N_FRAMES)
    print(f"rendered {N_FRAMES} + {len(lap_frames)} frames of {SHAPE[0]}x{SHAPE[1]} in {workers} processes, "
          f"{time.perf_counter() - t0:.1f} s with the build", flush=True)

    # --- 3. kernels against plain versions ---------------------------------

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
    n_valid = int(valid.sum())
    # the valid lanes' templates, and the pixels their windows touch between the guess and the result
    tpl_bytes = n_valid * levels * anchors.shape[2] * anchors.shape[3] * 4
    px_bytes = klt_window_bytes(pyr1, kcfg.scale, levels, valid, guess, torch.where(ok_k[:, None], kp_k, guess))
    klt_bytes = (tpl_bytes + px_bytes
                 + kp.numel() * 4 + guess.numel() * 4 + valid.numel()   # inputs
                 + kp_k.numel() * 4 + ok_k.numel())                      # outputs
    klt_flop = gn_k * KLT_FLOP_PER_ITER + n_valid * KLT_FLOP_ZNCC
    k1_bound, k1_kind = bound(klt_flop, klt_bytes)
    ms = device_ms(lambda: klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, kcfg))
    plain = wall_ms(lambda: klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg), 20)
    print(f"K1 klt: kernel {ms:.5f} ms/launch (device), plain {plain:.4f} ms/call (wall); bound {k1_bound:.6f} ms "
          f"({k1_kind}: {klt_flop / 1e6:.3f} MFLOP, {klt_bytes / 1e6:.3f} MB, of which templates "
          f"{tpl_bytes / 1e6:.3f} MB and the windows touch {px_bytes / 1e6:.3f} MB of the pyramid's "
          f"{sum(p.numel() * 4 for p in pyr1[:levels]) / 1e6:.3f} MB)", flush=True)
    results.append({"name": "klt_pyramid_anchored", "route": "cuda",
                    "source": "legoslam_tpu_torch/csrc/klt_anchored.cu",
                    "replaces": "legoslam_tpu/ops/klt_pallas.py:329,414",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": k1_bound, "bound_by": k1_kind,
                    "work": {"gn_lane_iterations": gn_k, "plain": gn_e}})

    results.append(check_klt_frame(frames, dev, klt_k))

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
        klt_k.klt_pyramid_kernel.launches = 0
        pose_k.estimate_pose_kernel.launches = 0

    def read_counts():
        return {"klt_pyramid_anchored": klt_k.klt_pyramid_anchored_kernel.launches,
                "klt_pyramid_frame": klt_k.klt_pyramid_kernel.launches,
                "estimate_pose": pose_k.estimate_pose_kernel.launches}

    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    vo = VisualOdometry(config=config, dataset=FrameList(frames, ds.rig), ba_mode="off")  # the card by default
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
    check(all(launches_off[k] >= n_track for k in MAIN_KERNELS), "a kernel was not launched on every tracking frame")
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

    vo = VisualOdometry(config=config, dataset=FrameList(frames, ds.rig))
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
    check(all(launches_inline[k] >= n_track for k in MAIN_KERNELS),
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

    # --- 7. the reference-mode slice -------------------------------------------
    vo = VisualOdometry(config=config.override(track_mode="frame", stereo_matcher="klt"),
                        dataset=FrameList(frames, ds.rig))
    check(vo.init(), "VisualOdometry.init failed (reference modes)")
    reset_counts()
    frame_ms = []
    for _ in range(N_FRAMES):
        t0 = time.perf_counter()
        check(vo.step(), "the dataset ended early")
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    launches_modes = read_counts()
    statuses, kf = vo.statuses(), vo.keyframe_flags()
    n_kf = int(kf.sum())
    T_wc = vo.trajectory_T_wc()
    ate_modes = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    track = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if not kf[i]]
    kfs = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if kf[i]]
    print(f"slice modes (track_mode frame, stereo_matcher klt): statuses {statuses.tolist()}", flush=True)
    print(f"slice modes: keyframes {n_kf} (JAX reference: {REF_MODES_KEYFRAMES}), launches {launches_modes} "
          f"(tracking frames {n_track}), ATE {ate_modes:.5f} m (bar {ATE_MAX_MODES}; JAX reference {REF_MODES_ATE} m)",
          flush=True)
    print(f"slice modes: {np.mean(frame_ms[WARMUP:]):.3f} ms/frame over frames {WARMUP}..{N_FRAMES - 1}; tracking "
          f"frames n={len(track)} median {np.median(track):.3f} ms; keyframe frames n={len(kfs)} median "
          f"{np.median(kfs):.3f} ms on {kind} ({smi})", flush=True)
    check(bool((statuses != FrontendStatus.LOST).all()), "a frame was LOST (reference modes)")
    check(bool((statuses[2:] == FrontendStatus.TRACKING_GOOD).all()), "not TRACKING_GOOD from frame 2 (reference modes)")
    check(launches_modes["klt_pyramid_frame"] == 2 * n_track + 2 * n_kf,
          f"{launches_modes['klt_pyramid_frame']} frame-mode launches, expected 2 per tracking frame and keyframe")
    check(launches_modes["klt_pyramid_anchored"] == 0 and launches_modes["estimate_pose"] == n_track,
          "the reference-mode slice launched the wrong kernels")
    check(abs(n_kf - REF_MODES_KEYFRAMES) <= 1, f"{n_kf} keyframes, JAX reference {REF_MODES_KEYFRAMES}")
    check(bool(np.isfinite(T_wc).all()) and ate_modes < ATE_MAX_MODES, f"ATE {ate_modes:.4f} m (reference modes)")
    t0 = time.perf_counter()
    vo_c = VisualOdometry(config=config.override(track_mode="frame", stereo_matcher="klt"),
                          dataset=FrameList(frames, ds.rig), device="cpu")
    check(vo_c.init(), "VisualOdometry.init failed (reference modes, CPU)")
    while vo_c.step():
        pass
    T_c = vo_c.trajectory_T_wc()
    ate_modes_cpu = evaluation.ate_rmse(T_c[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    apart = evaluation.ate_rmse(T_wc[:, :3, 3], T_c[:, :3, 3])
    n_kf_c = int(vo_c.keyframe_flags().sum())
    print(f"slice modes, the same code on the CPU ({time.perf_counter() - t0:.1f} s): keyframes {n_kf_c}, ATE "
          f"{ate_modes_cpu:.5f} m; card against CPU, rigidly aligned: {apart:.5f} m (bar {MODES_CARD_CPU_APART}); "
          f"keyframe flags equal: {bool((vo_c.keyframe_flags() == kf).all())}", flush=True)
    check(launches_modes == read_counts(), "the CPU run launched a kernel")
    check(bool((vo_c.statuses() == statuses).all()) and abs(n_kf_c - n_kf) <= 1,
          "the reference-mode slice differs between card and CPU in statuses or keyframes")
    check(apart < MODES_CARD_CPU_APART, f"the reference-mode trajectories of card and CPU are {apart:.4f} m apart")

    # --- 8. the marginalization slice ------------------------------------------
    from legoslam_tpu_torch.solver import marginalization

    vo = VisualOdometry(config=config.override(keyframe_window_capacity=5, num_active_keyframes=4, max_keyframe_gap=1,
                                               use_marg_prior=True), dataset=FrameList(frames, ds.rig))
    check(vo.init(), "VisualOdometry.init failed (marginalization)")
    reset_counts()
    t0 = time.perf_counter()
    while vo.step():
        pass
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_marg = read_counts()
    statuses = vo.statuses()
    T_wc = vo.trajectory_T_wc()
    ate_marg = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
    mg = vo.carry.wmap.marg
    n_prior = int((mg.prior_kf_id >= 0).sum())
    evict = torch.arange(5, device=dev) == int(torch.argmax((mg.info_kf_id >= 0).to(torch.int32)))
    mask = evict.repeat_interleave(6)
    f_g = marginalization.marginalize(mg.info_S, mg.info_b, mask, 6)
    f_c = marginalization.marginalize(mg.info_S.cpu(), mg.info_b.cpu(), mask.cpu(), 6)
    ms_marg = wall_ms(lambda: marginalization.marginalize(mg.info_S, mg.info_b, mask, 6), 10)
    dH = float((f_g.H.cpu() - f_c.H).abs().max() / f_c.H.abs().max())
    db = float((f_g.b.cpu() - f_c.b).abs().max() / f_c.b.abs().max())
    dJ = float(((f_g.sqrt_J.T @ f_g.sqrt_J).cpu() - f_c.sqrt_J.T @ f_c.sqrt_J).abs().max() / f_c.H.abs().max())
    print(f"slice marg (window 4 of 5, a keyframe every frame, use_marg_prior): statuses {statuses.tolist()}",
          flush=True)
    print(f"slice marg: keyframes {int(vo.keyframe_flags().sum())}, prior on {n_prior} slots (kf ids "
          f"{mg.prior_kf_id.tolist()}), max |prior_J| {float(mg.prior_J.abs().max()):.3f}, ATE {ate_marg:.5f} m, "
          f"{1e3 * dt / N_FRAMES:.3f} ms/frame, launches {launches_marg}", flush=True)
    print(f"slice marg: marginalize on the card against the CPU: |dH| {dH:.2e} |db| {db:.2e} |d J^T J| {dJ:.2e} "
          f"of the largest entry (bar {MARG_RTOL}); {ms_marg:.3f} ms per call (card wall) on {kind} ({smi})", flush=True)
    check(bool((statuses != FrontendStatus.LOST).all()), "a frame was LOST (marginalization)")
    check(n_prior >= 1 and float(mg.prior_J.abs().max()) > 0, "no prior at the end of the marginalization slice")
    check(mg.prior_J.is_cuda and f_g.H.is_cuda, "the prior left the card")
    check(max(dH, db, dJ) <= MARG_RTOL, "marginalize disagrees between card and CPU")
    check(bool(np.isfinite(T_wc).all()) and ate_marg < ATE_MAX, f"ATE {ate_marg:.4f} m (marginalization)")

    # --- 9. loop closure at full width -------------------------------------------
    from legoslam_tpu_torch.pipeline import loop_closure

    lap = lap_world()
    traj = lap.gt_T_wc
    arms = {}
    torch.use_deterministic_algorithms(True, warn_only=True)  # see LAP_SIDE: the arms must be one run until a loop closes
    for zncc in (1.1, 0.5):
        vo = VisualOdometry(config=config.override(use_loop_closure=True, loop_zncc_min=zncc),
                            dataset=FrameList(lap_frames, lap.rig))
        check(vo.init(), "VisualOdometry.init failed (loop closure)")
        lc = vo.loop_closer
        check(lc.device.type == "cuda" and lc.cfg.max_feats == 256 and lc.cfg.klt.levels == 3
              and lc.cfg == dataclasses.replace(loop_closure.LoopConfig(), zncc_min=zncc), "LoopConfig is not the default")
        verify, register = lc._verify, vo._register_keyframe
        verify_ms, verify_reads, register_reads = [], [], []

        pending, captured = [], []

        def timed_verify(j, verify=verify, verify_ms=verify_ms, verify_reads=verify_reads, pending=pending,
                         captured=captured):
            pending.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, reads = count_host_reads(lambda: verify(j))
            verify_ms.append(1e3 * (time.perf_counter() - t0))
            verify_reads.append(reads)
            if out[0] and not captured:  # the first accepted candidate's frame-mode inputs, as the closer made them
                captured.append(pending[0])
            return out

        def counted_register(frame, T, register=register, register_reads=register_reads, lc=lc):
            # (reads, a candidate was verified); a verification inside counts its own reads (timed_verify)
            n0 = lc.stats["candidates"]
            register_reads.append((count_host_reads(lambda: register(frame, T))[1], lc.stats["candidates"] > n0))

        verify_device = lc._verify_device

        def capturing_verify_device(pyr_j, pyr_i, uv_j, valid, *rest, verify_device=verify_device, pending=pending):
            pending.append((pyr_j, pyr_i, uv_j.contiguous(), valid.contiguous()))
            return verify_device(pyr_j, pyr_i, uv_j, valid, *rest)

        lc._verify, lc._verify_device, vo._register_keyframe = timed_verify, capturing_verify_device, counted_register
        reset_counts()
        t0 = time.perf_counter()
        while vo.step():
            pass
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        est = vo.trajectory_T_wc()
        ids, kf_T_cw = vo.keyframe_trajectory()
        arms[zncc] = {
            "full_ate": evaluation.ate_rmse(est[:, :3, 3], traj[: len(est), :3, 3]),
            "kf_ate": evaluation.ate_rmse(np.linalg.inv(kf_T_cw)[:, :3, 3], traj[ids][:, :3, 3]),
            "stats": dict(lc.stats), "statuses": vo.statuses(), "launches": counts, "records": len(ids),
            "ms_per_frame": 1e3 * dt / len(est), "verify_ms": verify_ms, "verify_reads": verify_reads,
            "register_reads": register_reads, "finite": bool(np.isfinite(est).all()), "captured": captured,
            "klt_cfg": lc.cfg.klt, "est": est,
            "first_closure": lc.records[lc.loop_edges[0][0]].frame_id if lc.loop_edges else None,
        }
    torch.use_deterministic_algorithms(False)
    for name, zncc in (("open", 1.1), ("closed", 0.5)):
        a = arms[zncc]
        print(f"loop {name} (loop_zncc_min {zncc}): {len(traj)} frames (side {LAP_SIDE}, turn {LAP_TURN}, speed "
              f"{LAP_SPEED}, laps {LAP_LAPS}, tail {LAP_TAIL}), {a['records']} keyframe records, stats {a['stats']}, keyframe ATE "
              f"{a['kf_ate']:.5f} m, full ATE {a['full_ate']:.5f} m, lost frames "
              f"{int((a['statuses'] == FrontendStatus.LOST).sum())}, {a['ms_per_frame']:.3f} ms/frame, launches "
              f"{a['launches']}", flush=True)
    closed = arms[0.5]
    same = np.all(closed["est"] == arms[1.1]["est"], axis=(1, 2))
    sha = {z: hashlib.sha1(a["est"][:, :3, 3].tobytes()).hexdigest()[:12] for z, a in arms.items()}  # of the positions
    print(f"loop arms: trajectory sha1 open {sha[1.1]}, closed {sha[0.5]}; {len(same) if same.all() else int(np.argmin(same))} "
          f"leading frames bit-equal in both arms, first closure registered at frame {closed['first_closure']}", flush=True)
    print(f"loop closed: verified candidates {len(closed['verify_ms'])}, ms per candidate "
          f"{[round(x, 3) for x in closed['verify_ms']]}, host reads per candidate {closed['verify_reads']}; host "
          f"reads per registered keyframe {sorted(set(r for r, v in closed['register_reads'] if not v))}, with a "
          f"verification (its own reads apart) {sorted(set(r for r, v in closed['register_reads'] if v))} on {kind} "
          f"({smi})", flush=True)
    check(all(a["finite"] and not (a["statuses"] == FrontendStatus.LOST).any() for a in arms.values()),
          "the lap lost track")
    check(arms[1.1]["stats"]["closures"] == 0 and arms[1.1]["launches"]["klt_pyramid_frame"] == 0,
          "the open arm closed a loop")
    check(closed["stats"]["closures"] >= 1, f"no loop closed: {closed['stats']}")
    check(closed["launches"]["klt_pyramid_frame"] >= 2 * closed["stats"]["candidates"] > 0,
          "verification did not launch the frame-mode kernel")
    check(closed["kf_ate"] < arms[1.1]["kf_ate"], "loop closure did not lower the keyframe ATE")
    check(closed["full_ate"] < arms[1.1]["full_ate"], "loop closure did not lower the full ATE")
    check(all(r == 1 for arm in arms.values() for r, verified in arm["register_reads"] if not verified),
          "registering a keyframe reads more than once from the card")
    check(len(closed["captured"]) == 1, "no accepted verification was captured")
    pyr_j, pyr_i, uv_j, valid_j = closed["captured"][0]
    check(uv_j.shape == (256, 2) and len(pyr_j) == 3 and tuple(pyr_j[0].shape) == (SHAPE[0] // 2, SHAPE[1] // 2),
          f"the closer's verification shapes are {tuple(uv_j.shape)}, {len(pyr_j)} levels of {tuple(pyr_j[0].shape)}")
    err_loop = hold_klt_frame(klt_k, "K1 frame on the closed arm's first accepted candidate", pyr_j, pyr_i, uv_j,
                              valid_j, closed["klt_cfg"], min_tracked=loop_closure.LoopConfig().min_inliers)[0]

    # library_ms: no single PyTorch call computes any of the three functions.
    slices = (launches_off, launches_inline, launches_modes, launches_marg, arms[1.1]["launches"], closed["launches"])
    launches = {k: sum(sl[k] for sl in slices) for k in launches_off}
    check(all(n > 0 for n in launches.values()), f"a kernel was never launched on the main paths: {launches}")
    n_frames_all = 4 * N_FRAMES + 2 * len(traj)
    results[1]["max_abs_err"] = max(results[1]["max_abs_err"], err_loop)  # klt_pyramid_frame
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"], "replaces": r["replaces"],
                "launches": launches[r["name"]], "launches_per_frame": launches[r["name"]] / n_frames_all,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bound_kind": r["bound_by"],
                "library_ms": None, "work": r["work"]} for r in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
