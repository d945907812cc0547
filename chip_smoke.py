"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Device: the CUDA card's name, and its name and power limit from
   nvidia-smi.  Exits non-zero without a CUDA device.
2. Build: the CUDA kernels from legoslam_tpu_torch/csrc (nvcc, sm_90a),
   while a pool of processes renders the two worlds (each once; every
   phase reuses the frames) and writes step 10's KITTI-format sequence to
   a temporary directory (removed at the end).
3. Kernels against their plain PyTorch versions at the main path's shapes:
   the anchored pyramid KLT (512 lanes, 3 levels of 188x620; bit for bit:
   positions, masks and GN lane-iterations equal), the same
   kernel source in frame mode (consecutive frames, 512 lanes, 4 levels,
   forward then backward; and again at the loop closer's shapes, 256 lanes
   and 3 levels of 94x310 from quantized half-resolution images) and the
   pose estimate (512 edges, held bit for bit: the same pose, inliers, n_in
   and LM attempts in every round; held alike at 4096 edges and with a
   prior 0.3 rad off, whose LM steps take the retraction's sinf branch,
   each timed too), with the agreement bars stated below; then, bit for
   bit and timed with their bounds, the configurations the kernels widened
   to take: K1 anchored at half-patches 5 and 9, K1 frame mode over 9
   levels of step 10's KITTI frames at 376x1240, and K2 at 6,000 edges (in
   its shared copy) and 8,192 and 16,384 (read from global memory),
   their work counts (GN lane-iterations, LM attempts) against the plain
   versions', the roofline bound of that work on this card (the KLT bytes
   are those of the pixels the lanes' windows touch, not whole pyramids),
   and median times from CUDA events (`device_ms`: the kernel's device time
   per launch; `wall_ms`: a whole call of the plain version, host syncs
   included).  Then scanline stereo (K3, csrc/stereo.cu) at kitti00's rig
   (28 disparities) on 512 lanes of frame 0: the plain version's bits (uv_r,
   ok), one launch and no host read, its device and wall time per call
   against the plain version's wall time.  Every slice below counts K3's
   launches too: one per keyframe on the default path, none under
   `stereo_matcher: klt`.
4. The BA-off slice: 40 frames of the plane-world benchmark sequence
   through `VisualOdometry(ba_mode="off")` on the card; every frame must
   track (TRACKING_GOOD), 7-9 keyframes, both kernels launched on every
   tracking frame, ATE < 0.05 m.
5. The BA-inline slice, the default path: the same 40 frames through
   `VisualOdometry(config)` with no `ba_mode` and no assembly precision, so
   window BA runs after every keyframe (`backend.ba_step`, PyTorch ops on the
   card) with its cross terms rounded to bfloat16, as the JAX package's
   default path assembles them.  Every frame must
   track, every keyframe frame must carry a finite BA chi, the keyframe
   count must be within 1 of the JAX reference's, both kernels launched on
   every tracking frame, ATE < 0.05 m.  Prints ms/frame split into tracking
   and keyframe frames, and keyframe frames into BA and the rest.  Then the
   same slice again: the two trajectories must be bit-equal (window BA sums
   in an order fixed by the graph), without
   torch.use_deterministic_algorithms; in that run each pose-kernel
   launch's inputs are kept, and the plain version on them on the card
   must give the kernel's bits (pose, inliers, n_in, LM attempts).
6. Window BA at full width (K=16 window slots, L=2048 active landmarks,
   E=5120 edges, 512 feature lanes, 131,072 landmarks): the map of step 5
   just before its last keyframe's BA goes through `backend.ba_step` on the
   card and, copied, on the CPU (the same port code); final chi, keyframe
   poses, outlier verdicts and observation counts must agree (bars below)
   at f32; the same call at the default path's precision (bf16) is printed
   with the same quantities and held only to running on the card (see the
   step's note).  Prints, for each, the card's wall ms per `ba_step`, final
   chi, LM iterations and attempts and the host reads counted by CUDA's sync
   debug mode, and the landmark counts.

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
   the detector shut (open arm) and open (closed arm), which are one run up
   to the first closure (the card's runs are reproducible): at least one
   closure, keyframe ATE and full ATE
   lower closed than open, the frames the arms share bit for bit, the closer's stats, ms per verified candidate,
   frame-mode launches, and the host reads per registered keyframe.  The
   pyramids, features and mask of the closed arm's first accepted candidate
   are kept, and after the run the frame-mode kernel is held against its
   plain version on them, forward and backward, under the bars of step 3;
   the inputs of the pose kernel's verification launches (warm-started
   rounds, 256 edges) are kept too, and the plain version on the first
   LOOP_POSE_HELD of them on the card must give the kernel's bits; the
   first of them is timed (`device_ms`).

10. KITTI through the command line, at full size: the first 150 frames of
   the JAX package's 1,000-frame soak (376x1240 PNGs written with zlib,
   calib.txt, poses.txt) through `python -m
   legoslam_tpu_torch.apps.run_kitti --config_file config/kitti_00.yaml
   --dataset_dir <seq> --out_dir <tmp>` in a subprocess: the user's
   command, read at 188x620 by the port's loader, window 16, 512 lanes,
   L=4096.  Exit 0, 150 poses, ATE and drift under the bars below (set
   from the JAX reference's and the port's runs of the same frames on a
   CPU).  Prints the decoder, the command's ms/frame, its ATE and RPE and
   the BA slots it dropped.
11. The same frames through the API (`VisualOdometry` with that config and
   a `KittiDataset`): no frame LOST, the keyframe count within a tenth of
   the reference's, window BA at L=4096 on every keyframe, the trajectory
   file equal to the command line's byte for byte; ms/frame split into
   tracking and keyframe frames, BA ms, dropped slots.  Then resume: 60
   frames uninterrupted against 30, `save_checkpoint`, a fresh
   `VisualOdometry`, `load_checkpoint` and 30 more: trajectories bit-equal,
   frame ids equal, the dataset's index 30 after the load; prints the
   checkpoint's size and its save and load ms.

12. `process_chunk` over step 5's 40 frames, already on the card: the same
   trajectory as step 5's, bit for bit (it is `process_frame` in a loop);
   prints ms/frame.
13. `ba_mode: async` (`ba_async_device: auto`: on one card the solve runs
   on a worker thread and a side stream of the same device) over the same
   frames, twice: every frame TRACKING_GOOD, ATE < 0.05 m, every dispatched
   solve merged, none pending.  Prints each run's ATE, the frames before
   which solves were merged, `skipped`, ms/frame and the median tracking
   frame with a solve in flight and without (each frame ends in a
   synchronize of the main stream only), beside step 5's inline numbers.
   Two runs need not give the same bits (a merge lands when its solve is
   ready).
14. The device pose graph (`solver/pose_graph.py`): a drifting chain of 92
   poses (the loop course's keyframe records) closed by one loop edge, on
   the card twice (bit-equal) and on the CPU, each run to convergence (50
   LM iterations at most, stopping at a chi change under 1e-10): chi within
   1e-4 relative, poses within 1e-4, drift reduced.
15. Distributed BA (`parallel/dist_ba.py`) over NCCL at world size 1,
   through `backend.ba_step`'s `solve_fn` seam on step 6's map, against
   step 6's f32 `lm.solve_ba` (the sharded solve assembles at f32 whatever
   the config says, as the reference's does) at tests/test_dist_ba.py's bars
   (chi 1e-3 relative, poses 1e-3, points 5e-3); prints ms and host reads.
16. Frame 5 of the KITTI soak stage by stage from the JAX reference's carry
   (tests/data/kitti_soak_stages_f5.npz through tests/kitti_stages.py, which
   imports no JAX), on the card and on the CPU: every stage and one whole
   step within tests/test_torch_kitti_stages.py's bars against each of XLA's
   three CPU settings, and the constant-velocity prior, tracking (uv and
   mask), the pose (T, inliers, n_in) and scanline stereo (uv_r, matches)
   equal between card and CPU bit for bit; a difference is printed with its
   quantity, shape and size.
17. The main path at the configurations the kernels widened to take (C20):
   (a) step 5's 40 frames with klt_half_patch 5 and max_features 8192 (K1
   at an 11x11 patch over 8,192 lanes, K2 reading 8,192 edges from global
   memory), (b) the same with klt_half_patch 9, (c) the first 30 frames of
   step 10's sequence at 376x1240 through config/kitti_00.yaml with
   track_mode frame and klt_pyramid_levels 9: every frame TRACKING_GOOD,
   ATE under ATE_MAX for (a) and (b), each kernel the run needs launched
   at the widened configuration, and on each run's last frame the plain
   versions on the launches' own inputs give the kernels' bits.

The kernel launch counts are set to 0 just before each slice and read just
after it (step 10's subprocess is counted through step 11's run of the same
frames).  Prints one JSON line of per-kernel results, then, as the last
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
import multiprocessing
import os
import shutil
import tempfile
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from legoslam_tpu_torch.utils.timer import count_host_reads

SHAPE = (188, 620)        # KITTI half resolution
N_FRAMES = 40
WARMUP = 4
LANES = 512
SEED = 0
# Agreement bars, kernel vs plain version on identical inputs.
KLT_MASK_AGREE = 0.99     # success masks
KLT_POS_ATOL = 1e-2       # px, where both succeed
# K2 computes its plain version's bits (csrc/pose.cu rounds as solver/lm.py
# does): pose entries, inlier masks, n_in and each round's LM attempts equal.
POSE_T_ATOL = 0.0         # pose entries
POSE_INLIER_AGREE = 1.0
ATE_MAX = 0.05            # m, the JAX reference gets 0.0047 m on these frames (BA off)
# The JAX reference's BA-inline run of the same 40 frames as configured
# (VisualOdometry, ba_mode inline, ba_assembly_precision bf16, the default of
# both packages, on the CPU; printed by `python -m tests.ba_parity_report
# --bench-world`): 8 keyframes, every frame TRACKING_GOOD, ATE 0.015421 m
# (at f32: 8 keyframes, ATE 0.019379 m).  The port's plain versions on that
# CPU at bf16: the same keyframes, ATE 0.017464 m, 0.014892 m from the
# reference after a rigid alignment.
REF_INLINE_KEYFRAMES = 8
REF_INLINE_ATE = 0.015421
# Window BA, card against CPU on the same map (same port code; the card sums
# the blocks through padded tables, the CPU by `index_add_`, in another
# association of the same edge order): final chi relative, poses
# relative to the oldest keyframe (every window pose is free, so the
# window's rigid placement is held only by the LM damping), verdict masks.
BA_CHI_RTOL = 1e-3
BA_POSE_ATOL = 1e-3
BA_MASK_AGREE = 0.99
# Work counts, kernel vs plain version.  A lane moved by one GN step moves
# the KLT count by one: max(atol, rtol * plain).  The pose's LM attempts per
# round: equal.
KLT_WORK_TOL = (8, 0.02)
POSE_ROUND_TOL = 0

# The JAX reference's run of the same 40 frames with track_mode frame and
# stereo_matcher klt (BA inline at bf16, the default, on the CPU; `python -m
# tests.ba_parity_report --bench-world`; at f32: 8 keyframes, ATE 0.043943 m).
REF_MODES_KEYFRAMES = 8
REF_MODES_ATE = 0.032465
# Its ATE bar: frame-to-frame templates random-walk (the reference's note
# at legoslam_tpu/ops/klt.py:243-249), so this configuration sits at twice
# the default path's ATE in the reference too, and whatever moves a track by
# a hundredth of a pixel moves the trajectory.  The port's plain versions on
# a CPU end 0.016343 m from the reference there after a rigid alignment (ATE
# 0.033972 m) at bf16, 0.005906 m (ATE 0.048234 m) with both at f32
# (`python -m tests.ba_parity_report --only-bench-world`); on an NVIDIA H100
# 80GB HBM3 three runs with the kernels, two with the plain versions in
# their place and one on that host's CPU, all at f32, gave ATEs of 0.0403 to
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
# too since window BA sums in an order fixed by the graph
# (solver/schur.py): 3 runs of each arm in one call of
# `scripts/loop_course_scan.py --repeat 3 lap2`, with and without
# --deterministic, gave one trajectory digest per arm (open d6150d6467c5,
# closed f3b4c742ae79), 224 leading frames shared, 13 closures, keyframe ATE
# 0.2540 -> 0.0440 m, full ATE 0.2515 -> 0.1150 m.  (With `index_add_`'s
# unordered sums two runs with the detector shut ended 0.191 and 0.476 m
# off, more than a closure gains, and this phase ran under
# torch.use_deterministic_algorithms(True); it needs that no longer.)
LAP_SIDE, LAP_TURN, LAP_SPEED, LAP_LAPS, LAP_TAIL = 32, 24, 0.3, 2, 4

# Step 10's sequence: the first KITTI_FRAMES frames of the JAX package's
# 1,000-frame soak (tests/test_kitti_soak.py:25-80): 376x1240 written to disk
# as KITTI lays a sequence out, focal 720, baseline 0.54 m, the S-curve at
# 0.3 m/frame, a corridor of half width 12 m from z -20, 6 occluders,
# photometric noise 1.5; read at half resolution (188x620) by the port's CLI.
SOAK_SHAPE, SOAK_FOCAL, SOAK_BASELINE, SOAK_FRAMES, SOAK_SPEED = (376, 1240), 720.0, 0.54, 1000, 0.3
SOAK_HALF_WIDTH = 12.0
SOAK_COURSES = ("s_curve", "level", "clear")  # soak_trajectory's courses; step 10 drives the first
KITTI_FRAMES = 150
RESUME_FRAMES, RESUME_AT = 60, 30   # step 11: 60 frames, stopped and resumed after 30
# The JAX reference's run of those 150 frames through its own command line
# on a CPU as configured (`JAX_PLATFORMS=cpu python apps/run_kitti.py
# --config_file config/kitti_00.yaml --dataset_dir <seq> --log_every 1`,
# bf16 assembly, the default of both packages): 30 keyframes, every frame
# TRACKING_GOOD, ATE 0.020757 m, drift 0.0870 m per 100 m (the last frame's
# error over the 44.7 m path).  With `ba_assembly_precision: f32` added to
# the config: 30 keyframes, ATE 0.029166 m, drift 0.4453.  The port's
# command line on a CPU (`--device cpu`) at f32: 30 keyframes, ATE 0.034178
# m, drift 0.2541, 0.0325 m from the f32 reference after a rigid alignment.
# The bars are twice the largest of these figures; the keyframe count may
# move by a tenth.
REF_KITTI_KEYFRAMES = 30
REF_KITTI_ATE = 0.020757
REF_KITTI_DRIFT = 0.0870
KITTI_KEYFRAME_TOL = 3
KITTI_ATE_MAX = 0.07
KITTI_DRIFT_MAX = 0.9

# Roofline of one H100 SXM (NVIDIA's data sheet; at a 700 W power limit).
PG_POSES = 92                       # the loop course's keyframe records (step 9)
PG_LOOPS = ((91, 0),)               # tests/test_pose_graph_and_prior.py's chain: one loop edge, weight 100
PG_RTOL = 1e-4                      # pose graph, card against CPU: chi (relative) and pose entries
# Run to convergence: optimize's default stop rule (a chi change under 1e-5)
# ends a solve whose chi is ~5e-3 before 1e-4 of it is resolved.
PG_ITERATIONS, PG_STOP = 50, 1e-10
# Distributed BA against the single solve: tests/test_dist_ba.py:33-42's bars.
DIST_CHI_RTOL, DIST_POSE_ATOL, DIST_POINT_ATOL = 1e-3, 1e-3, 5e-3
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores


def klt_flop(half_patch: int = 3):
    """FLOPs of one KLT GN iteration, of one lane's ZNCC gate and of one
    frame-mode template at `half_patch` (h = 3: a 9x9 halo window of 81
    samples, 49 terms).  An iteration: the window's bilinear samples (three
    lerps of 4), the terms (err 1, gradients 4, cost 2, H 6, b 4), the 2x2
    solve; the gate: the patch's samples and 8 for its sums a term; a
    template: its window's samples, per lane and level."""
    window, terms = (2 * half_patch + 3) ** 2, (2 * half_patch + 1) ** 2
    return window * 12 + terms * 17 + 20, terms * 20, window * 12

# FLOPs of one pose edge per LM pass, as the function needs them:
# projection and Jacobian (~40), Huber weights with W symmetric (~15), the
# rows of J^T W (36) and the b terms (14), the sums of H's 21 upper entries
# (84: two rows, a multiply and an add each), of b (12) and chi (1).  K2
# sums all 36 entries of H and computes W10 apart from W01, to give the
# reference's bits (its H is not symmetric bit for bit): 63 FLOPs more,
# not counted.
POSE_FLOP_PER_EDGE = 202
# Step 3's holds of the widened kernels, each bit for bit and timed: K1
# anchored at these half-patches, K1 frame mode over WIDE_KITTI's 9 levels
# of the KITTI frames at 376x1240, and K2 at these edge counts (the first
# in the shared copy on an H100, the others past it, in global memory).
KLT_WIDE_HALF_PATCHES = (5, 9)
POSE_WIDE_EDGES = (6000, 8192, 16384)
# K2's verification launches of the loop course held against the plain version.
LOOP_POSE_HELD = 12
# Step 3's further K2 holds: 4096 edges (its ring wrapping eight times a
# pass) and a prior this many rad off about x.
POSE_MAX_EDGES = 4096
POSE_LARGE_ANGLE = 0.3
# Step 17: the main path at configurations the card's kernels took only
# since they widened (ROADMAP C20), each on the bench world with BA inline
# at its defaults: (a) K1 at an 11x11 patch over 8,192 lanes and K2 past its
# shared copy, (b) K1 at 19x19; and (c) K1's frame entry over 9 levels of
# the KITTI soak's first frames at 376x1240 (config/kitti_00.yaml).  The JAX
# reference tracks every frame of each on a CPU (`python -m
# tests.ba_parity_report --widened`).
WIDE_BENCH = {"a": {"klt_half_patch": 5, "max_features": 8192}, "b": {"klt_half_patch": 9, "max_features": 8192}}
WIDE_KITTI = {"track_mode": "frame", "klt_pyramid_levels": 9, "image_scale": 1.0}
WIDE_KITTI_FRAMES = 30
MAIN_KERNELS = ("klt_pyramid_anchored", "estimate_pose")  # launched on every tracking frame of the default path
# K3 at the kitti00 configuration's rig (portbench/configs/kitti00.json: f 359.428 px at half resolution, baseline
# 0.5372 m, depth gates 8-200 m): 28 integer disparities, a strip of 36 columns.
STEREO_FXB = 359.428 * 0.5372
STEREO_DEPTHS = (8.0, 200.0)


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


def touched_pixels(shape, lo, hi, radius: int = 4) -> int:
    """Pixels of one pyramid level inside the union of the lanes' windows.
    Lane n's window centre moved within the box `lo[n]`..`hi[n]` (x, y in
    this level's pixels); bilinear sampling of the halo window (2 radius + 1
    wide: 9x9 at the default half-patch 3, radius h + 1) reads
    floor(centre - radius) .. floor(centre + radius) + 1, clamped to the
    image as ops/interp.py clamps."""
    h, w = shape
    lo, hi = np.asarray(lo, np.float64).reshape(-1, 2), np.asarray(hi, np.float64).reshape(-1, 2)
    x0 = np.clip(np.floor(lo[:, 0] - radius), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(lo[:, 1] - radius), 0, h - 1).astype(np.int64)
    x1 = np.clip(np.floor(hi[:, 0] + radius) + 1, 0, w - 1).astype(np.int64)
    y1 = np.clip(np.floor(hi[:, 1] + radius) + 1, 0, h - 1).astype(np.int64)
    cover = np.zeros((h + 1, w + 1), np.int64)  # a 2-D difference array of the boxes
    np.add.at(cover, (y0, x0), 1)
    np.add.at(cover, (y0, x1 + 1), -1)
    np.add.at(cover, (y1 + 1, x0), -1)
    np.add.at(cover, (y1 + 1, x1 + 1), 1)
    return int((cover.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def klt_window_bytes(pyr, scale, levels, valid, *tracks, half_patch: int = 3) -> int:
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
    return 4 * sum(touched_pixels(tuple(pyr[k].shape), lo * scale ** k, hi * scale ** k, half_patch + 1)
                   for k in range(levels))


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


def soak_trajectory(n=SOAK_FRAMES, speed=SOAK_SPEED, course="s_curve"):
    """T_wc of a soak course: forward at `speed` m/frame with a gentle
    alternating yaw.  "s_curve" is tests/test_kitti_soak.py's
    `_s_curve_trajectory` (dyaw = 0.0018 sin(2 pi k / 320): the heading
    swings between 0 and +0.18 rad, so the camera leaves the 12 m corridor
    at frame 460); "level" turns by 0.0018 cos(2 pi k / 320), a heading of
    +-0.092 rad about the corridor's axis, and stays within 3.02 m of it
    (but drives through two occluders, ROADMAP C14); "clear" turns by
    0.0018 cos(2 pi k / 320 + 2.847), stays within 9.50 m of the axis and
    passes every occluder at 1.51 m or more."""
    k = np.arange(n)
    if course not in SOAK_COURSES:
        raise ValueError(f"unknown soak course {course!r} ({' | '.join(SOAK_COURSES)})")
    arg = 2 * np.pi * k / 320.0
    dyaw = 0.0018 * {"s_curve": np.sin(arg), "level": np.cos(arg), "clear": np.cos(arg + 2.847)}[course]
    poses, pos, yaw = [], np.zeros(3), 0.0
    for dy in dyaw:
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = pos
        poses.append(T)
        pos = pos + T[:3, :3] @ np.array([0.0, 0.0, speed])
        yaw += dy
    return np.stack(poses)


def soak_world(n=SOAK_FRAMES, course="s_curve"):
    """The soak's world (tests/test_kitti_soak.py's `_make_dataset`) seen
    from `course`, its first `n` frames: frame i renders to the same bytes
    for any n."""
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset

    return SyntheticPlanesDataset(shape=SOAK_SHAPE, focal=SOAK_FOCAL, baseline=SOAK_BASELINE, half_width=SOAK_HALF_WIDTH,
                                  length=SOAK_FRAMES * SOAK_SPEED + 60.0, z_min=-20.0,
                                  trajectory=soak_trajectory(course=course)[:n], n_occluders=6,
                                  photometric_noise=1.5)


def write_soak_chunk(root, indices, course="s_curve"):
    """Render frames `indices` of the soak world on `course` and write them
    as KITTI PNGs under `root` (runs in a worker process)."""
    from legoslam_tpu_torch.pipeline.dataset import write_kitti_frame

    ds = soak_world(max(indices) + 1, course)
    for i in indices:
        ds.current_index = i
        fr = ds.next_frame()
        write_kitti_frame(root, i, fr.left, fr.right)
    return len(indices)


def start_soak_sequence(pool, workers: int, root: str, n: int, course="s_curve"):
    """Write calib.txt and poses.txt of the soak's first `n` frames on
    `course` under `root` and submit its frames to the pool; returns a
    function that waits for them."""
    from legoslam_tpu_torch.pipeline.dataset import write_kitti_sequence

    H, W = SOAK_SHAPE
    P0 = np.array([[SOAK_FOCAL, 0.0, W / 2.0, 0.0], [0.0, SOAK_FOCAL, H / 2.0, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P1 = P0.copy()
    P1[0, 3] = -SOAK_FOCAL * SOAK_BASELINE
    write_kitti_sequence(root, P0, P1, soak_trajectory(course=course)[:n])
    futs = [pool.submit(write_soak_chunk, root, list(range(w, n, workers)), course) for w in range(workers)]

    def gather():
        if sum(f.result() for f in futs) != n:
            raise RuntimeError("the soak sequence was not written whole")

    return gather


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


def klt_inputs(frames, dev, half_patch: int = 3):
    """512 anchored lanes from frame 0's corners, tracked into frame 1 from
    guesses a few px off, with templates of `half_patch`."""
    from legoslam_tpu_torch.ops import detect, klt, pyramid

    img0 = torch.from_numpy(frames[0][0]).to(dev)
    img1 = torch.from_numpy(frames[1][0]).to(dev)
    kp, ok = detect.detect(img0, detect.GFTTConfig(max_corners=LANES, min_distance=4, border=8))
    check(int(ok.sum()) >= LANES // 2, f"only {int(ok.sum())} corners")
    cfg = klt.KLTConfig(levels=3, half_patch=half_patch)
    anchors = klt.extract_anchors(pyramid.build_pyramid(img0, 4), kp, cfg._replace(levels=4))
    rng = np.random.default_rng(SEED)
    guess = kp + torch.from_numpy(rng.uniform(-3.0, 3.0, (LANES, 2)).astype(np.float32)).to(dev)
    valid = ok & torch.from_numpy(rng.uniform(size=LANES) > 0.05).to(dev)
    return anchors.contiguous(), kp.contiguous(), tuple(pyramid.build_pyramid(img1, 4)), guess, valid, cfg


def pose_inputs(dev, n=LANES, large_angle=False):
    """n edges: a known pose, noisy projections, 10% gross outliers; the
    prior near the pose, or with `large_angle` its rotation POSE_LARGE_ANGLE
    rad off, so the LM steps take the retraction's sinf branch."""
    from legoslam_tpu_torch.geometry import se3
    from legoslam_tpu_torch.solver import reprojection

    rng = np.random.default_rng(SEED)
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    z = rng.uniform(4.0, 60.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    xi_true = [0.1, -0.05, 0.3, 0.01, 0.02, -0.01]
    T_true = se3.se3_exp(torch.tensor(xi_true)).double().numpy()
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[: n // 10] += rng.normal(0, 30.0, (n // 10, 2))
    valid = rng.uniform(size=n) > 0.05
    xi_prior = [0.12, -0.03, 0.25, 0.0, 0.025, 0.0]
    if large_angle:
        xi_prior = xi_true[:3] + [xi_true[3] + POSE_LARGE_ANGLE] + xi_true[4:]
    T_prior = se3.se3_exp(torch.tensor(xi_prior))

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
    per_iter, _, per_template = klt_flop()
    flop = gn_k * per_iter + n_valid * cfg.levels * per_template
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two float32 tensors hold the same bits (NaN equal to itself)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def clone(a):
    """A copy of a kernel argument: tensors and sequences of them are
    cloned, anything else (configs, intrinsics, numbers) is kept."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)) and a and all(isinstance(x, torch.Tensor) for x in a):
        return tuple(x.clone() for x in a)
    return a


def hold_klt_anchored(frames, dev, klt_k, half_patch, kind, smi):
    """K1 anchored at `half_patch` on step 3's lanes: its plain version's
    bits and GN lane-iterations, its time and the bound of its work."""
    anchors, kp, pyr1, guess, valid, cfg = klt_inputs(frames, dev, half_patch)
    it_k = torch.zeros((1,), dtype=torch.int32, device=dev)
    it_e = torch.zeros((1,), dtype=torch.int32, device=dev)
    kp_k, ok_k = klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, cfg, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, cfg, gn_iterations=it_e)
    torch.cuda.synchronize()
    gn = int(it_k)
    err = float((kp_k - kp_e).abs().max())
    check(same_bits(kp_k, kp_e) and torch.equal(ok_k, ok_e) and gn == int(it_e),
          f"K1 at half-patch {half_patch} differs from its plain version")
    check(int(ok_k.sum()) >= LANES // 4, f"K1 at half-patch {half_patch} tracked too few lanes")
    n_valid = int(valid.sum())
    tpl = n_valid * cfg.levels * anchors.shape[2] * anchors.shape[3] * 4
    px = klt_window_bytes(pyr1, cfg.scale, cfg.levels, valid, guess, torch.where(ok_k[:, None], kp_k, guess),
                          half_patch=half_patch)
    # the valid lanes' templates and the pixels their windows touch between the guess and the result, the
    # other inputs and the outputs
    nbytes = tpl + px + kp.numel() * 4 + guess.numel() * 4 + valid.numel() + kp_k.numel() * 4 + ok_k.numel()
    per_iter, per_gate, _ = klt_flop(half_patch)
    flop = gn * per_iter + n_valid * per_gate
    b_ms, b_kind = bound(flop, nbytes)
    ms = device_ms(lambda: klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr1, guess, valid, cfg))
    print(f"K1 klt at half-patch {half_patch} ({2 * half_patch + 1}x{2 * half_patch + 1}): the plain version's bits "
          f"on {kp.shape[0]} lanes, {cfg.levels} levels of {tuple(pyr1[0].shape)}, success {int(ok_k.sum())}, GN "
          f"lane-iterations {gn}; kernel {ms:.5f} ms/launch (device), bound {b_ms:.6f} ms ({b_kind}: "
          f"{flop / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, of which templates {tpl / 1e6:.3f} MB and the windows "
          f"touch {px / 1e6:.3f} MB) on {kind} ({smi})", flush=True)
    return {"half_patch": half_patch, "ms": ms, "bound_ms": b_ms, "bound_by": b_kind, "max_abs_err": err,
            "gn_lane_iterations": gn}


def hold_stereo(frames, dev, kind, smi):
    """K3 against its plain version at kitti00's rig on the bench world's
    frame 0, 512 lanes from its corners: the plain version's bits, one
    launch and no host read against the plain version's reads; the kernel's
    device time and wall time per call against the plain version's wall
    time; the bound of the cross-correlation's and window sums' work and of
    the pixels the lanes' patches and strips touch."""
    from legoslam_tpu_torch.kernels import stereo as stereo_k
    from legoslam_tpu_torch.ops import detect

    left = torch.from_numpy(frames[0][0]).to(dev)
    right = torch.from_numpy(frames[0][1]).to(dev)
    kp, ok = detect.detect(left, detect.GFTTConfig(max_corners=LANES, min_distance=4, border=8))
    kp = kp.contiguous()
    d_min, d_max = STEREO_FXB / STEREO_DEPTHS[1], STEREO_FXB / STEREO_DEPTHS[0]
    cfg = stereo_k.ScanlineConfig()
    args = ((left,), (right,), kp, ok, d_min, d_max, cfg)
    n0 = stereo_k.match_kernel.launches
    out_k, reads_k = count_host_reads(lambda: stereo_k.match_kernel(*args))
    out_e, reads_e = count_host_reads(lambda: stereo_k.match_eager(*args))
    torch.cuda.synchronize()
    launched = stereo_k.match_kernel.launches - n0
    err = float((out_k[0] - out_e[0]).abs().max())
    check(same_bits(out_k[0], out_e[0]) and torch.equal(out_k[1], out_e[1]), "K3 stereo differs from its plain version")
    check(launched == 1 and reads_k == 0, f"K3 stereo: {launched} launches and {reads_k} host reads, expected 1 and 0")
    check(int(out_k[1].sum()) >= LANES // 8, f"K3 stereo matched only {int(out_k[1].sum())} lanes")
    d_hi, D = stereo_k.disparities(d_min, d_max)
    P = 2 * cfg.half_patch + 1
    S = D + P + 1
    n_valid = int(ok.sum())
    # every lane (an invalid one has its outputs too): the cross term and window sums, a multiply and an add per
    # patch pixel and disparity, two column sums and their scans per strip column; the GN iterations (at most 6
    # a lane) are left out
    flop = kp.shape[0] * (2 * D * P * P + 3 * S * P + 4 * S)
    # the patch's pixels around kp, the strip's from kp - d_hi - h - 1 to kp - d_lo + h + 1 along x
    xy = kp.cpu().numpy().astype(np.float64)
    px = (touched_pixels(tuple(left.shape), xy, xy, cfg.half_patch)
          + touched_pixels(tuple(right.shape), xy - [d_hi + 1, 0], xy - [d_hi - D, 0], cfg.half_patch))
    nbytes = 4 * px + kp.numel() * 4 + ok.numel() + out_k[0].numel() * 4 + out_k[1].numel()
    b_ms, b_kind = bound(flop, nbytes)
    ms = device_ms(lambda: stereo_k.match_kernel(*args))
    wall = wall_ms(lambda: stereo_k.match_kernel(*args), 50)
    plain = wall_ms(lambda: stereo_k.match_eager(*args), 20)
    print(f"K3 stereo: the plain version's bits on {kp.shape[0]} lanes of {tuple(left.shape)} at kitti00's rig "
          f"(D {D}, strip {S} columns), matched {int(out_k[1].sum())} of {n_valid}; 1 launch and {reads_k} host reads "
          f"a call, the plain version {reads_e} reads; kernel {ms:.5f} ms/launch (device), {wall:.4f} ms/call (wall); "
          f"plain {plain:.4f} ms/call (wall); bound {b_ms:.6f} ms ({b_kind}: {flop / 1e6:.3f} MFLOP without the GN "
          f"iterations, {nbytes / 1e6:.3f} MB) on {kind} ({smi})", flush=True)
    return {"name": "stereo_match", "route": "cuda", "source": "legoslam_tpu_torch/csrc/stereo.cu",
            "replaces": None, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_kind,
            "work": {"wall_ms": wall, "host_reads": reads_k, "plain_host_reads": reads_e, "disparities": D}}


def hold_klt_frame_levels(kitti_root, dev, klt_k, kind, smi):
    """K1 in frame mode over WIDE_KITTI's levels of the KITTI sequence's
    frames 0 and 1 at 376x1240, 512 lanes from frame 0's corners: the plain
    version's bits forward and backward, its time and bound."""
    from legoslam_tpu_torch.ops import detect, klt, pyramid
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset

    seq = KittiDataset(kitti_root, scale=WIDE_KITTI["image_scale"], use_native=False)
    check(seq.init(), "the KITTI sequence does not open")
    img0, img1 = (torch.from_numpy(np.ascontiguousarray(seq.next_frame().left, np.float32)).to(dev) for _ in range(2))
    levels = WIDE_KITTI["klt_pyramid_levels"]
    kp, ok = detect.detect(img0, detect.GFTTConfig(max_corners=LANES, min_distance=4, border=8))
    kp = kp.contiguous()
    cfg = klt.KLTConfig(levels=levels)
    pyr0, pyr1 = tuple(pyramid.build_pyramid(img0, levels)), tuple(pyramid.build_pyramid(img1, levels))
    check(min(p.shape[0] for p in pyr0) >= 1, f"a level of {levels} has no row")
    it_k = torch.zeros((1,), dtype=torch.int32, device=dev)
    it_e = torch.zeros((1,), dtype=torch.int32, device=dev)
    kp_k, ok_k = klt_k.klt_pyramid_kernel(pyr0, pyr1, kp, kp, ok, cfg, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_eager(pyr0, pyr1, kp, kp, ok, cfg, gn_iterations=it_e)
    bk_k, okb_k = klt_k.klt_pyramid_kernel(pyr1, pyr0, kp_k, kp, ok_k, cfg)
    bk_e, okb_e = klt_k.klt_pyramid_eager(pyr1, pyr0, kp_k, kp, ok_k, cfg)
    torch.cuda.synchronize()
    gn = int(it_k)
    check(same_bits(kp_k, kp_e) and torch.equal(ok_k, ok_e) and gn == int(it_e)
          and same_bits(bk_k, bk_e) and torch.equal(okb_k, okb_e),
          f"K1 frame mode over {levels} levels differs from its plain version")
    n_valid = int(ok.sum())
    px = (klt_window_bytes(pyr0, cfg.scale, levels, ok, kp)
          + klt_window_bytes(pyr1, cfg.scale, levels, ok, kp, torch.where(ok_k[:, None], kp_k, kp)))
    nbytes = px + 2 * kp.numel() * 4 + ok.numel() + kp_k.numel() * 4 + ok_k.numel()
    per_iter, _, per_template = klt_flop()
    flop = gn * per_iter + n_valid * levels * per_template
    b_ms, b_kind = bound(flop, nbytes)
    ms = device_ms(lambda: klt_k.klt_pyramid_kernel(pyr0, pyr1, kp, kp, ok, cfg))
    print(f"K1 frame over {levels} levels of {tuple(pyr0[0].shape)} (the coarsest {tuple(pyr0[-1].shape)}): the plain "
          f"version's bits forward and backward on {kp.shape[0]} lanes ({n_valid} valid), success {int(ok_k.sum())}, "
          f"GN lane-iterations {gn}; kernel {ms:.5f} ms/launch (device), bound {b_ms:.6f} ms ({b_kind}: "
          f"{flop / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB) on {kind} ({smi})", flush=True)
    return {"levels": levels, "shape": list(pyr0[0].shape), "ms": ms, "bound_ms": b_ms, "bound_by": b_kind,
            "max_abs_err": float((kp_k - kp_e).abs().max()), "gn_lane_iterations": gn}


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
    # Each render worker holds ~4.7 GB on the H100 machine's host (96 GiB);
    # with 8 the render ran it out of memory in some calls, so 6.
    workers = max(1, min(6, os.cpu_count() or 1))
    scratch = tempfile.mkdtemp(prefix="legoslam_chip_smoke_")
    try:
        kitti_root = os.path.join(scratch, "07")
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as procs:
            gather = render_worlds(procs, workers)
            gather_kitti = start_soak_sequence(procs, workers, kitti_root, KITTI_FRAMES)
            with ThreadPoolExecutor() as pool:
                for line in pool.map(build, ("klt_anchored", "pose", "stereo")):
                    print(line, flush=True)
            worlds = gather()
            gather_kitti()
        frames, lap_frames = worlds["bench"], worlds[LAP]
        print(f"rendered {N_FRAMES} + {len(lap_frames)} frames of {SHAPE[0]}x{SHAPE[1]} and wrote {KITTI_FRAMES} "
              f"KITTI-format frames of {SOAK_SHAPE[0]}x{SOAK_SHAPE[1]} in {workers} processes, "
              f"{time.perf_counter() - t0:.1f} s with the build", flush=True)
        run_slices(dev, kind, smi, klt_k, pose_k, frames, lap_frames, kitti_root, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_slices(dev, kind, smi, klt_k, pose_k, frames, lap_frames, kitti_root, scratch) -> None:
    """Steps 3 to 17, then the result lines."""
    ds = bench_world(N_FRAMES)

    # --- 3. kernels against plain versions ---------------------------------

    results = []
    k1 = hold_klt_anchored(frames, dev, klt_k, 3, kind, smi)
    anchors, kp, pyr1, guess, valid, kcfg = klt_inputs(frames, dev)
    plain = wall_ms(lambda: klt_k.klt_pyramid_anchored_eager(anchors, kp, pyr1, guess, valid, kcfg), 20)
    print(f"K1 klt: plain {plain:.4f} ms/call (wall)", flush=True)
    results.append({"name": "klt_pyramid_anchored", "route": "cuda",
                    "source": "legoslam_tpu_torch/csrc/klt_anchored.cu",
                    "replaces": "legoslam_tpu/ops/klt_pallas.py:329,414",
                    "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": plain, "bound_ms": k1["bound_ms"],
                    "bound_by": k1["bound_by"],
                    "work": {"gn_lane_iterations": k1["gn_lane_iterations"], "plain": k1["gn_lane_iterations"]}})

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
    check(iagree >= POSE_INLIER_AGREE and int(n_k) == int(n_e), "K2 inliers disagree with the plain version")
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
    shared = pose_k.shared_edges(dev)
    print(f"K2 pose: the shared copy holds {shared} edges on this card; above that K2 reads global memory",
          flush=True)
    pose_configs = []
    for label, n, large in ((f"{POSE_MAX_EDGES} edges", POSE_MAX_EDGES, False),
                            (f"prior {POSE_LARGE_ANGLE} rad off", LANES, True),
                            *((f"{n} edges", n, False) for n in POSE_WIDE_EDGES)):
        args = pose_inputs(dev, n, large)[:5]
        at_k = torch.zeros((outer,), dtype=torch.int32, device=dev)
        at_e = torch.zeros((outer,), dtype=torch.int32, device=dev)
        T_k, in_k, n_k = pose_k.estimate_pose_kernel(*args, attempts=at_k)
        T_e, in_e, n_e = pose_k.estimate_pose_eager(*args, attempts=at_e)
        torch.cuda.synchronize()
        terr_x = float((T_k - T_e).abs().max())
        ms_x = device_ms(lambda args=args: pose_k.estimate_pose_kernel(*args))
        flop_x = (int(at_k.sum()) + outer) * int(args[4].sum()) * POSE_FLOP_PER_EDGE
        bound_x, kind_x = bound(flop_x, T_prior.numel() * 4 + n * (12 + 8 + 1) + T_k.numel() * 4 + n + 4)
        where = "global memory" if n > shared else "shared copy"
        print(f"K2 pose, {label} ({where}): max |dT| {terr_x:.2e} (bar {POSE_T_ATOL}), inliers equal "
              f"{torch.equal(in_k, in_e)}, n_in kernel {int(n_k)} plain {int(n_e)}, LM attempts per round kernel "
              f"{at_k.tolist()} plain {at_e.tolist()}; kernel {ms_x:.5f} ms/launch (device), bound {bound_x:.6f} ms "
              f"({kind_x}: {flop_x / 1e6:.3f} MFLOP) on {kind} ({smi})", flush=True)
        check(terr_x <= POSE_T_ATOL and torch.equal(in_k, in_e) and int(n_k) == int(n_e),
              f"K2 disagrees with the plain version at {label}")
        check(all(abs(x - y) <= POSE_ROUND_TOL for x, y in zip(at_k.tolist(), at_e.tolist())),
              f"K2 work count disagrees with the plain version at {label}")
        pose_configs.append({"case": label, "edges": n, "memory": where, "ms": ms_x, "bound_ms": bound_x,
                             "bound_by": kind_x, "max_abs_err": terr_x, "lm_attempts": int(at_k.sum())})
    check(POSE_WIDE_EDGES[0] <= shared < POSE_WIDE_EDGES[1], f"K2's shared copy holds {shared} edges")
    results[2]["work"]["configs"] = pose_configs
    results[0]["work"]["configs"] = [hold_klt_anchored(frames, dev, klt_k, h, kind, smi) for h in KLT_WIDE_HALF_PATCHES]
    results[1]["work"]["configs"] = [hold_klt_frame_levels(kitti_root, dev, klt_k, kind, smi)]
    results.append(hold_stereo(frames, dev, kind, smi))

    # --- 4. the BA-off slice -------------------------------------------------
    from legoslam_tpu_torch.kernels import stereo as stereo_k
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.state import Capacities
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    def reset_counts():
        klt_k.klt_pyramid_anchored_kernel.launches = 0
        klt_k.klt_pyramid_kernel.launches = 0
        pose_k.estimate_pose_kernel.launches = 0
        stereo_k.match_kernel.launches = 0

    def read_counts():
        return {"klt_pyramid_anchored": klt_k.klt_pyramid_anchored_kernel.launches,
                "klt_pyramid_frame": klt_k.klt_pyramid_kernel.launches,
                "estimate_pose": pose_k.estimate_pose_kernel.launches,
                "stereo_match": stereo_k.match_kernel.launches}

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
    check(launches_off["stereo_match"] == n_kf, f"{launches_off['stereo_match']} stereo launches, expected one a "
                                                f"keyframe ({n_kf})")
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
          f"ATE {ate_inline:.5f} m (bar {ATE_MAX}; JAX reference at bf16 {REF_INLINE_ATE} m)", flush=True)
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

    # The same slice again: the card must give the same bits, without
    # torch.use_deterministic_algorithms (BA sums in a fixed order).
    # This run also keeps a copy of each K2 launch's inputs, outputs and LM
    # attempts, and the plain version must give the same bits on them.
    check(not torch.are_deterministic_algorithms_enabled(), "deterministic algorithms are on")
    vo = VisualOdometry(config=config, dataset=FrameList(frames, ds.rig))
    check(vo.init(), "VisualOdometry.init failed (BA inline, second run)")
    pose_calls, dispatch = [], pose_k.estimate_pose

    def capturing_pose(intr, T_init, p_world, uv, valid, **kw):
        att = torch.zeros((kw.get("outer_iterations", 4),), dtype=torch.int32, device=T_init.device)
        out = dispatch(intr, T_init, p_world, uv, valid, attempts=att, **kw)
        pose_calls.append(((intr, T_init.clone(), p_world.clone(), uv.clone(), valid.clone()), kw,
                           tuple(o.clone() for o in out), att))
        return out

    pose_k.estimate_pose = capturing_pose
    try:
        reset_counts()
        while vo.step():
            pass
        launches_inline2 = read_counts()
    finally:
        pose_k.estimate_pose = dispatch
    digests = [hashlib.sha1(np.ascontiguousarray(T).tobytes()).hexdigest()[:12]
               for T in (T_wc, vo.trajectory_T_wc())]
    print(f"slice inline, run twice: trajectory sha1 {digests[0]} and {digests[1]}, bit-equal "
          f"{digests[0] == digests[1]}, launches {launches_inline2}", flush=True)
    check(digests[0] == digests[1], "two runs of the default path gave two trajectories")
    differ = []
    for i, (args, kw, (T_k, in_k, n_k), att_k) in enumerate(pose_calls):
        att_e = torch.zeros_like(att_k)
        T_e, in_e, n_e = pose_k.estimate_pose_eager(*args, attempts=att_e, **kw)
        if not (torch.equal(T_k, T_e) and torch.equal(in_k, in_e) and torch.equal(n_k, n_e)
                and torch.equal(att_k, att_e)):
            differ.append((i, float((T_k - T_e).abs().max()), att_k.tolist(), att_e.tolist()))
    print(f"slice inline: K2 against its plain version on each launch's own inputs: {len(pose_calls)} launches "
          f"({int(pose_calls[0][0][4].numel())} edges, {sum(int(c[3].sum()) for c in pose_calls)} LM attempts in "
          f"all), {len(differ)} differ {differ[:5]}", flush=True)
    check(len(pose_calls) == launches_inline2["estimate_pose"] == N_FRAMES - 1,
          f"{len(pose_calls)} K2 launches captured on {N_FRAMES - 1} tracking frames")
    check(not differ, "K2 and its plain version differ on the default path's inputs")
    inline = {"digest": digests[0], "ate": ate_inline, "ms_per_frame": float(np.mean(frame_ms[WARMUP:])),
              "tracking_median": float(np.median(track)), "keyframes": n_kf}

    # --- 6. window BA at full width, card against CPU -----------------------
    # At f32 under the bars, and at the default path's precision (bf16),
    # printed with the same quantities but held only to running on the card:
    # rounding each edge's cross terms to bfloat16 turns an ulp of float32
    # between card and CPU into a 2^-8 step in a few terms, which moves an
    # unconverged 10-iteration LM by a fraction of a percent in chi.  The
    # reference's own chi moves so across XLA's CPU instruction sets: 0.41%
    # in the 14-frame corridor's first window BA at bf16, 0.09% at f32
    # (`python -m tests.ba_parity_report --isa-spread`), so BA_CHI_RTOL cannot
    # hold at bf16.
    cfg_b, rig_b, wmap_b, ba_cfg_b = ba_calls[-1][1]
    check(cfg_b.caps == Capacities(), f"BA capacities {cfg_b.caps} are not the defaults")
    check(wmap_b.kf_pose.is_cuda, "the BA map is not on the card")
    check(ba_cfg_b.assembly_precision == "bf16", f"the default path assembles at {ba_cfg_b.assembly_precision}")
    valid = wmap_b.kf_valid.cpu().numpy()
    oldest = int(np.argmax(valid))

    def relative(T):
        T = T.double().cpu().numpy()
        return (T @ np.linalg.inv(T[oldest]))[valid]

    ba_runs = {}
    for precision in ("f32", "bf16"):
        ba_cfg_p = ba_cfg_b._replace(assembly_precision=precision)
        (map_g, st_g), host_reads = count_host_reads(lambda: backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_p))
        map_c, st_c = backend.ba_step(cfg_b, rig_b.to("cpu"), wmap_b.to("cpu"), ba_cfg_p)
        ms_ba = wall_ms(lambda: backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_p), 5)
        chi_g, chi_c = float(st_g.chi), float(st_c.chi)
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
        if precision == "f32":
            n_active, n_dropped = int(st_g.n_active_landmarks), int(st_g.n_dropped_landmarks)
            n_edges = int(backend.build_problem(cfg_b, rig_b, wmap_b)[0].graph.e_valid.sum())
            print(f"BA: K={cfg_b.caps.window} L={cfg_b.caps.active_landmarks} E={cfg_b.caps.ba_edges} lanes "
                  f"{cfg_b.caps.max_features} landmarks {cfg_b.caps.landmarks}; {int(valid.sum())} keyframes, "
                  f"{n_active} active landmarks, {n_dropped} dropped, {n_edges} edges", flush=True)
        bars = "" if precision == "f32" else ", no bars at bf16"
        print(f"BA ({precision}{bars}): chi card {chi_g:.6f} cpu {chi_c:.6f} (rtol {BA_CHI_RTOL}, relative "
              f"{abs(chi_g - chi_c) / abs(chi_c):.2e}); relative poses max |d| {pose_err:.2e} (bar {BA_POSE_ATOL}; "
              f"absolute {pose_abs:.2e}); masks agree {mask_agree} (bar {BA_MASK_AGREE}); lm_obs equal where they "
              f"agree: {obs_equal}; outliers card {int(st_g.n_outlier)} cpu {int(st_c.n_outlier)}", flush=True)
        print(f"BA ({precision}): {ms_ba:.3f} ms per ba_step (card wall, median of 5); LM iterations "
              f"{st_g.iterations} attempts {st_g.attempts} (cpu: {st_c.iterations} / {st_c.attempts}); host reads "
              f"{host_reads} on {kind} ({smi})", flush=True)
        if precision == "f32":
            check(abs(chi_g - chi_c) <= BA_CHI_RTOL * abs(chi_c), "BA chi disagrees between card and CPU")
            check(pose_err <= BA_POSE_ATOL, "BA poses disagree between card and CPU")
            check(min(mask_agree) >= BA_MASK_AGREE, "BA outlier verdicts disagree between card and CPU")
            check(obs_equal, "BA observation counts disagree where the verdicts agree")
        check(np.isfinite(chi_g) and st_g.iterations >= 1, f"BA did not run on the card ({precision})")
        check(map_g.lm_pos.is_cuda and st_g.chi.is_cuda, f"BA left the card ({precision})")
        ba_runs[precision] = (map_g, st_g, ms_ba)
    print(f"BA: chi bf16 {float(ba_runs['bf16'][1].chi):.6f} f32 {float(ba_runs['f32'][1].chi):.6f}; ms per ba_step "
          f"bf16 {ba_runs['bf16'][2]:.3f} f32 {ba_runs['f32'][2]:.3f} on {kind} ({smi})", flush=True)

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
          f"(tracking frames {n_track}), ATE {ate_modes:.5f} m (bar {ATE_MAX_MODES}; JAX reference at bf16 {REF_MODES_ATE} m)",
          flush=True)
    print(f"slice modes: {np.mean(frame_ms[WARMUP:]):.3f} ms/frame over frames {WARMUP}..{N_FRAMES - 1}; tracking "
          f"frames n={len(track)} median {np.median(track):.3f} ms; keyframe frames n={len(kfs)} median "
          f"{np.median(kfs):.3f} ms on {kind} ({smi})", flush=True)
    check(bool((statuses != FrontendStatus.LOST).all()), "a frame was LOST (reference modes)")
    check(bool((statuses[2:] == FrontendStatus.TRACKING_GOOD).all()), "not TRACKING_GOOD from frame 2 (reference modes)")
    check(launches_modes["klt_pyramid_frame"] == 2 * n_track + 2 * n_kf,
          f"{launches_modes['klt_pyramid_frame']} frame-mode launches, expected 2 per tracking frame and keyframe")
    check(launches_modes["klt_pyramid_anchored"] == 0 and launches_modes["estimate_pose"] == n_track
          and launches_modes["stereo_match"] == 0, "the reference-mode slice launched the wrong kernels")
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

        verify_poses, dispatch = [], pose_k.verify_pose

        def capturing_pose(intr, T_init, p_world, uv, valid, verify_poses=verify_poses, **kw):
            # the verification's K2 launches (`verify_pose`, the verifier's own entry)
            att = torch.zeros((kw.get("outer_iterations", 4),), dtype=torch.int32, device=T_init.device)
            out = dispatch(intr, T_init, p_world, uv, valid, attempts=att, **kw)
            verify_poses.append(((intr, T_init.clone(), p_world.clone(), uv.clone(), valid.clone()),
                                 dict(kw, verification=True), tuple(o.clone() for o in out), att))
            return out

        lc._verify, lc._verify_device, vo._register_keyframe = timed_verify, capturing_verify_device, counted_register
        pose_k.verify_pose = capturing_pose
        try:
            reset_counts()
            t0 = time.perf_counter()
            while vo.step():
                pass
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
        finally:
            pose_k.verify_pose = dispatch
        est = vo.trajectory_T_wc()
        ids, kf_T_cw = vo.keyframe_trajectory()
        arms[zncc] = {
            "full_ate": evaluation.ate_rmse(est[:, :3, 3], traj[: len(est), :3, 3]),
            "kf_ate": evaluation.ate_rmse(np.linalg.inv(kf_T_cw)[:, :3, 3], traj[ids][:, :3, 3]),
            "stats": dict(lc.stats), "statuses": vo.statuses(), "launches": counts, "records": len(ids),
            "ms_per_frame": 1e3 * dt / len(est), "verify_ms": verify_ms, "verify_reads": verify_reads,
            "register_reads": register_reads, "finite": bool(np.isfinite(est).all()), "captured": captured,
            "klt_cfg": lc.cfg.klt, "est": est, "verify_poses": verify_poses,
            "first_closure": lc.records[lc.loop_edges[0][0]].frame_id if lc.loop_edges else None,
        }
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
    calls = closed["verify_poses"]
    check(0 < len(closed["verify_ms"]) <= len(calls) <= 2 * len(closed["verify_ms"]),
          f"{len(calls)} K2 verification launches for {len(closed['verify_ms'])} verified candidates")
    differ = []
    for i, (args, kw, (T_k, in_k, n_k), att_k) in enumerate(calls[:LOOP_POSE_HELD]):
        att_e = torch.zeros_like(att_k)
        T_e, in_e, n_e = pose_k.estimate_pose_eager(*args, attempts=att_e, **kw)
        if not (torch.equal(T_k, T_e) and torch.equal(in_k, in_e) and torch.equal(n_k, n_e)
                and torch.equal(att_k, att_e)):
            differ.append((i, float((T_k - T_e).abs().max()), att_k.tolist(), att_e.tolist()))
    print(f"loop closed: K2's verification rounds against its plain version on the card, on the first "
          f"{min(len(calls), LOOP_POSE_HELD)} of {len(calls)} launches' own inputs ({int(calls[0][0][4].numel())} "
          f"edges): {len(differ)} differ {differ[:5]}", flush=True)
    check(not differ, "K2's verification rounds and their plain version differ")
    args, kw = calls[0][0], calls[0][1]
    ms_verify = device_ms(lambda: pose_k.estimate_pose_kernel(*args, **kw))
    print(f"loop closed: K2 verification launch {ms_verify:.5f} ms/launch (device) on the first launch's inputs "
          f"({int(args[4].numel())} edges, LM attempts {calls[0][3].tolist()})", flush=True)

    launches_kitti = run_kitti_steps(kind, smi, kitti_root, scratch, reset_counts, read_counts)
    launches_more = run_chunk_async_graph_dist(dev, kind, smi, frames, ds, config, inline, ba_calls[-1][1],
                                               ba_runs["f32"][:2], reset_counts, read_counts)
    check_stage_fixture(kind, smi)
    launches_wide = run_widened(dev, kind, smi, frames, ds, kitti_root, klt_k, pose_k, reset_counts, read_counts)
    results[0]["work"]["instantiations"] = {f"half_patch {over['klt_half_patch']}": sl["klt_pyramid_anchored"]
                                            for over, sl in zip(WIDE_BENCH.values(), launches_wide)}
    results[1]["work"]["instantiations"] = {f"{WIDE_KITTI['klt_pyramid_levels']} levels":
                                            launches_wide[-1]["klt_pyramid_frame"]}
    results[2]["work"]["instantiations"] = {"edges in global memory": sum(sl["estimate_pose"]
                                                                          for sl in launches_wide[:-1])}

    # library_ms: no single PyTorch call computes any of the four functions.
    slices = (launches_off, launches_inline, launches_inline2, launches_modes, launches_marg, arms[1.1]["launches"],
              closed["launches"], launches_kitti, *launches_more, *launches_wide)
    launches = {k: sum(sl[k] for sl in slices) for k in launches_off}
    check(all(n > 0 for n in launches.values()), f"a kernel was never launched on the main paths: {launches}")
    n_frames_all = (8 + len(WIDE_BENCH)) * N_FRAMES + 2 * len(traj) + KITTI_FRAMES + WIDE_KITTI_FRAMES
    results[1]["max_abs_err"] = max(results[1]["max_abs_err"], err_loop)  # klt_pyramid_frame
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"], "replaces": r["replaces"],
                "launches": launches[r["name"]], "launches_per_frame": launches[r["name"]] / n_frames_all,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bound_kind": r["bound_by"],
                "library_ms": None, "work": r["work"]} for r in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


def run_chunk_async_graph_dist(dev, kind, smi, frames, ds, config, inline, ba_args, ba_card, reset_counts,
                               read_counts):
    """Steps 12 to 15; returns the kernel launches of the chunk and of the two
    async runs."""
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.visual_odometry import (FrontendStatus, VisualOdometry, initial_carry,
                                                             process_chunk)
    from legoslam_tpu_torch.utils import evaluation

    def digest(T_wc):
        return hashlib.sha1(np.ascontiguousarray(T_wc).tobytes()).hexdigest()[:12]

    # --- 12. process_chunk over step 5's frames, already on the card ----------
    vo = VisualOdometry(config=config, dataset=FrameList(frames, ds.rig))
    check(vo.init(), "VisualOdometry.init failed (chunk)")
    imgs_l = torch.from_numpy(np.stack([f[0] for f in frames]).astype(np.float32)).to(dev)
    imgs_r = torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.float32)).to(dev)
    carry = initial_carry(vo.frontend_cfg, SHAPE, torch.float32, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    carry, outs = process_chunk(vo.frontend_cfg, vo.rig, carry, imgs_l, imgs_r, np.arange(N_FRAMES), vo.ba_cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_chunk = read_counts()
    T_wc = np.linalg.inv(outs.T_cw.cpu().numpy())
    statuses, kf = outs.status.cpu().numpy(), outs.kf_inserted.cpu().numpy()
    n_track = N_FRAMES - 1
    print(f"chunk: process_chunk over the {N_FRAMES} frames of step 5 on the card: trajectory sha1 {digest(T_wc)} "
          f"(step 5: {inline['digest']}), keyframes {int(kf.sum())}, {1e3 * dt / N_FRAMES:.3f} ms/frame over all "
          f"{N_FRAMES} frames (step 5, frames {WARMUP}..: {inline['ms_per_frame']:.3f}), launches {launches_chunk} "
          f"on {kind} ({smi})", flush=True)
    check(digest(T_wc) == inline["digest"], "process_chunk differs from step 5's stepwise run")
    check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), "a frame did not track (chunk)")
    check(all(launches_chunk[k] >= n_track for k in MAIN_KERNELS), "a kernel was not launched on every tracking "
          "frame (chunk)")

    # --- 13. ba_mode async, twice -----------------------------------------------
    launches_async = []
    for run in (1, 2):
        vo = VisualOdometry(config=config.override(ba_mode="async", ba_async_device="auto"),
                            dataset=FrameList(frames, ds.rig))
        check(vo.init(), "VisualOdometry.init failed (async)")
        ab = vo.async_backend
        check(ab.ba_device is None and ab._stream is not None and torch.cuda.device_count() == 1,
              "async BA on one card is not the side stream of the same device")
        merged_at, do_merge = [], ab._do_merge

        def recording_merge(wmap, do_merge=do_merge, merged_at=merged_at, vo=vo):
            merged_at.append(len(vo.outputs))  # the frame about to be processed
            return do_merge(wmap)

        ab._do_merge = recording_merge
        main = torch.cuda.current_stream(dev)
        frame_ms, in_flight = [], []
        reset_counts()
        for _ in range(N_FRAMES):
            job, merged = ab.pending, ab.stats["merged"]
            t0 = time.perf_counter()
            check(vo.step(), "the dataset ended early")
            main.synchronize()  # this frame's work; a solve on the side stream goes on
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            in_flight.append(job is not None and ab.stats["merged"] == merged)
        t0 = time.perf_counter()
        vo.flush_ba()
        torch.cuda.synchronize()
        flush_ms = 1e3 * (time.perf_counter() - t0)
        launches_async.append(read_counts())
        statuses, kf = vo.statuses(), vo.keyframe_flags()
        T_wc = vo.trajectory_T_wc()
        ate = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:N_FRAMES, :3, 3])
        st = dict(ab.stats)
        track_busy = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if not kf[i] and in_flight[i]]
        track_free = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if not kf[i] and not in_flight[i]]
        kfs = [frame_ms[i] for i in range(WARMUP, N_FRAMES) if kf[i]]
        med = lambda x: f"{np.median(x):.3f}" if x else "none"  # noqa: E731
        print(f"async run {run} (ba_async_device auto: the side stream of {dev}): statuses all TRACKING_GOOD "
              f"{bool((statuses == FrontendStatus.TRACKING_GOOD).all())}, keyframes {int(kf.sum())}, stats {st}, "
              f"solves merged before frames {merged_at}, chi {[round(float(x.chi), 4) for x in ab.merged_stats]}, "
              f"ATE {ate:.5f} m (bar {ATE_MAX}), trajectory sha1 {digest(T_wc)} on {kind} ({smi})", flush=True)
        print(f"async run {run}: {np.mean(frame_ms[WARMUP:]):.3f} ms/frame over frames {WARMUP}..{N_FRAMES - 1} "
              f"(each ends in a synchronize of the main stream), final flush {flush_ms:.3f} ms; tracking frames "
              f"with a solve in flight n={len(track_busy)} median {med(track_busy)} ms, without n={len(track_free)} "
              f"median {med(track_free)} ms; keyframe frames n={len(kfs)} median {med(kfs)} ms; step 5 inline: "
              f"{inline['ms_per_frame']:.3f} ms/frame, tracking median {inline['tracking_median']:.3f} ms, ATE "
              f"{inline['ate']:.5f} m; launches {launches_async[-1]} on {kind} ({smi})", flush=True)
        check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), f"a frame did not track (async run {run})")
        check(ate < ATE_MAX, f"ATE {ate:.4f} m (async run {run})")
        check(st["merged"] == st["dispatched"] >= 1 and ab.pending is None, f"async BA did not settle: {st}")
        check(all(launches_async[-1][k] >= n_track for k in MAIN_KERNELS),
              f"a kernel was not launched on every tracking frame (async run {run})")

    # --- 14. the device pose graph, card against CPU ------------------------------
    from legoslam_tpu_torch.geometry import se3
    from legoslam_tpu_torch.solver import lm, pose_graph

    PG_CFG = lm.LMConfig(iterations=PG_ITERATIONS, diff_chi_threshold=PG_STOP)
    rng = np.random.default_rng(SEED)
    n = PG_POSES
    step = se3.se3_exp(torch.tensor([0.0, 0.0, 0.5, 0.0, 2 * np.pi / n, 0.0]))
    gt = [torch.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    e_i, e_j, meas, est = [], [], [], [gt[0]]
    for i in range(1, n):
        rel = se3.se3_exp(torch.from_numpy(rng.normal(scale=0.02, size=6).astype(np.float32))) @ (
            gt[i] @ torch.linalg.inv(gt[i - 1]))
        e_i.append(i), e_j.append(i - 1), meas.append(rel), est.append(rel @ est[-1])
    for i, j in PG_LOOPS:
        e_i.append(i), e_j.append(j), meas.append(gt[i] @ torch.linalg.inv(gt[j]))
    E = len(e_i)
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    graph = pose_graph.PoseGraph(e_i=torch.tensor(e_i), e_j=torch.tensor(e_j), T_meas=torch.stack(meas),
                                 weight=torch.tensor([1.0] * (n - 1) + [100.0] * len(PG_LOOPS)),
                                 valid=torch.ones(E, dtype=torch.bool), fixed=fixed)
    card = pose_graph.PoseGraph(*(x.to(dev) for x in graph[:6]))
    P0 = torch.stack(est)
    (P1, r1), (P2, r2) = (pose_graph.optimize(P0.to(dev), card, cfg=PG_CFG) for _ in range(2))
    Pc, rc = pose_graph.optimize(P0, graph, cfg=PG_CFG)
    ms_pg = wall_ms(lambda: pose_graph.optimize(P0.to(dev), card, cfg=PG_CFG), 5)
    drift = lambda P: float(np.linalg.norm(  # noqa: E731
        np.linalg.inv(P.cpu().double().numpy())[:, :3, 3] - np.linalg.inv(torch.stack(gt).double().numpy())[:, :3, 3],
        axis=1).max())
    chi_rel = abs(float(r1.chi) - float(rc.chi)) / abs(float(rc.chi))
    dP = float((P1.cpu() - Pc).abs().max())
    print(f"pose graph: {n} poses, {E} edges ({len(PG_LOOPS)} loop); chi card {float(r1.chi):.7f} cpu "
          f"{float(rc.chi):.7f} (relative {chi_rel:.2e}, bar {PG_RTOL}), poses max |d| {dP:.2e} (bar {PG_RTOL}), two "
          f"card runs bit-equal {bool(torch.equal(P1, P2) and torch.equal(r1.chi, r2.chi))}; LM iterations "
          f"{r1.iterations} attempts {r1.attempts}; largest position error {drift(P0):.4f} m before, {drift(P1):.4f} m "
          f"after; {ms_pg:.3f} ms per optimize (card wall, median of 5) on {kind} ({smi})", flush=True)
    check(torch.equal(P1, P2) and torch.equal(r1.chi, r2.chi), "two card runs of the pose graph differ")
    check(chi_rel <= PG_RTOL and dP <= PG_RTOL, "the pose graph differs between card and CPU")
    check(drift(P1) < drift(P0), "the pose graph did not reduce the drift")

    # --- 15. distributed BA over NCCL at world size 1, through ba_step's seam ----
    # The sharded solve assembles at f32 whatever the config says (the
    # reference's parallel/dist_ba.py:130), so it is held to step 6's f32 solve.
    import socket

    import torch.distributed as dist

    from legoslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod

    cfg_b, rig_b, wmap_b, ba_cfg_b = ba_args
    map_g, st_g = ba_card
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh()
        solve_fn = dist_ba.make_dist_solve_fn(mesh)
        (map_d, st_d), reads = count_host_reads(lambda: backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_b,
                                                                        solve_fn=solve_fn))
        ms_d = wall_ms(lambda: backend.ba_step(cfg_b, rig_b, wmap_b, ba_cfg_b, solve_fn=solve_fn), 5)
        backend_name = dist.get_backend()
    finally:
        dist.destroy_process_group()
    alive = map_g.lm_alive
    chi_rel = abs(float(st_d.chi) - float(st_g.chi)) / abs(float(st_g.chi))
    dpose = float((map_d.kf_pose - map_g.kf_pose).abs().max())
    dpts = float((map_d.lm_pos - map_g.lm_pos)[alive].abs().max())
    print(f"dist BA: {backend_name} at world size {mesh.world_size} on {mesh.device}, step 6's map through "
          f"backend.ba_step(solve_fn=make_dist_solve_fn(mesh)): chi {float(st_d.chi):.6f} against lm.solve_ba's at f32 "
          f"{float(st_g.chi):.6f} (relative {chi_rel:.2e}, bar {DIST_CHI_RTOL}), poses max |d| {dpose:.2e} (bar "
          f"{DIST_POSE_ATOL}), points max |d| {dpts:.2e} (bar {DIST_POINT_ATOL}); LM attempts {st_d.attempts} "
          f"(single {st_g.attempts}), host reads {reads}; {ms_d:.3f} ms per ba_step (card wall, median of 5) on "
          f"{kind} ({smi})", flush=True)
    check(chi_rel <= DIST_CHI_RTOL, "distributed BA's chi disagrees with the single solve")
    check(dpose <= DIST_POSE_ATOL and dpts <= DIST_POINT_ATOL, "distributed BA disagrees with the single solve")
    check(map_d.lm_pos.is_cuda and st_d.chi.is_cuda, "distributed BA left the card")
    return [launches_chunk, *launches_async]


# Step 16: the quantities the card must compute as the CPU does, bit for bit.
STAGE_BIT_EQUAL = ("prior/T", "track/uv", "track/valid", "pose/T", "pose/lm", "pose/n_in", "stereo/uv_r",
                   "stereo/has_right")


def check_stage_fixture(kind, smi) -> None:
    """16. Frame 5 of the KITTI soak stage by stage from the reference's
    carry (tests/data/kitti_soak_stages_f5.npz, through tests/kitti_stages.py,
    which needs no JAX), on the card and on the CPU: every stage and one
    whole step within tests/test_torch_kitti_stages.py's bars of every XLA
    setting, and the prior, tracking, pose and scanline stereo bit for bit
    the CPU's."""
    import importlib.util

    repo = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("kitti_stages", os.path.join(repo, "tests", "kitti_stages.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    path = os.path.join(repo, "tests", "data", "kitti_soak_stages_f5.npz")
    t0 = time.perf_counter()
    runs = {}
    for device in ("cuda", "cpu"):
        fx = ks.load_stage_fixture(path, device)
        runs[device] = ks.run_stage_fixture(fx)
    torch.cuda.synchronize()
    settings = fx["settings"]
    spread = ks.fixture_spread(settings)
    quantities = [q for qs in ks.FIXTURE_STAGES.values() for q in qs] + list(ks.ONE_STEP)
    past = []
    for device, run in runs.items():
        for name in ks.FIXTURE_SETTINGS:
            gaps = ks.fixture_gaps(run, settings[name])
            past += [(device, name, q, gaps[q], ks.bar(q, spread[q])) for q in quantities
                     if gaps[q] > ks.bar(q, spread[q])]
    card, cpu = runs["cuda"]["stages"], runs["cpu"]["stages"]
    differ = [(k, tuple(np.shape(cpu[k])), float(np.abs(np.asarray(card[k], np.float64)
                                                      - np.asarray(cpu[k], np.float64)).max()))
              for k in STAGE_BIT_EQUAL if not np.array_equal(card[k], cpu[k])]
    card_cpu = ks.fixture_gaps(runs["cuda"], runs["cpu"])
    print(f"stages f5: frame {fx['h']} of the KITTI soak on the card and on the CPU, "
          f"{time.perf_counter() - t0:.1f} s; card against CPU: "
          + ", ".join(f"{q} {card_cpu[q]:.3g}" for q in quantities) + f"; on {kind} ({smi})", flush=True)
    print(f"stages f5: past the bars of tests/test_torch_kitti_stages.py: {past}; card and CPU differ in "
          f"{differ} of {list(STAGE_BIT_EQUAL)}", flush=True)
    check(not past, "a stage of frame 5 is past its bar")
    check(not differ, "the card's prior, tracking, pose or stereo differs from the CPU's")


def run_widened(dev, kind, smi, frames, ds, kitti_root, klt_k, pose_k, reset_counts, read_counts):
    """17. The main path at the configurations the kernels widened to take:
    WIDE_BENCH's runs over step 5's frames (BA inline at its defaults) and
    WIDE_KITTI's over the KITTI sequence's first WIDE_KITTI_FRAMES frames
    at 376x1240.  Each: every frame TRACKING_GOOD, the bench runs' ATE under
    ATE_MAX, the kernels the run needs launched, and on the last frame each
    launch's inputs kept and the plain version run on them, which must give
    the kernel's bits.  Returns each run's launches."""
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    repo = os.path.dirname(os.path.abspath(__file__))
    kitti_config = Config.from_yaml(os.path.join(repo, "config", "kitti_00.yaml")).override(**WIDE_KITTI)
    bench = {"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0}
    runs = [(f"({k}) {over}", Config({**bench, **over}), lambda: FrameList(frames, ds.rig), N_FRAMES,
             ds.gt_T_wc[:N_FRAMES]) for k, over in WIDE_BENCH.items()]
    gt = KittiDataset(kitti_root, use_native=False)
    check(gt.init(), "the KITTI sequence does not open")
    runs.append((f"(c) {WIDE_KITTI}", kitti_config, lambda: KittiDataset(kitti_root, scale=WIDE_KITTI["image_scale"]),
                 WIDE_KITTI_FRAMES, gt.ground_truth[:WIDE_KITTI_FRAMES]))
    dispatch = {"klt_pyramid_anchored": (klt_k, "klt_pyramid_anchored", klt_k.klt_pyramid_anchored_eager),
                "klt_pyramid_frame": (klt_k, "klt_pyramid", klt_k.klt_pyramid_eager),
                "estimate_pose": (pose_k, "estimate_pose", pose_k.estimate_pose_eager)}
    out = []
    for label, config, dataset, n, gt_T_wc in runs:
        vo = VisualOdometry(config=config, dataset=dataset())
        check(vo.device.type == "cuda", f"VisualOdometry runs on {vo.device} {label}")
        check(vo.init(), f"VisualOdometry.init failed {label}")
        kept, keep = [], [False]

        def keeping(name, fn):
            def call(*args, **kw):
                res = fn(*args, **kw)
                if keep[0]:
                    kept.append((name, tuple(clone(a) for a in args), kw, tuple(r.clone() for r in res)))
                return res
            return call

        saved = {name: getattr(mod, attr) for name, (mod, attr, _) in dispatch.items()}
        for name, (mod, attr, _) in dispatch.items():
            setattr(mod, attr, keeping(name, saved[name]))
        try:
            reset_counts()
            frame_ms = []
            for i in range(n):
                keep[0] = i == n - 1
                t0 = time.perf_counter()
                check(vo.step(), f"the frames ended early {label}")
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.perf_counter() - t0))
            launches = read_counts()
        finally:
            for name, (mod, attr, _) in dispatch.items():
                setattr(mod, attr, saved[name])
        statuses, kf = vo.statuses(), vo.keyframe_flags()
        T_wc = vo.trajectory_T_wc()
        ate = evaluation.ate_rmse(T_wc[:, :3, 3], gt_T_wc[:, :3, 3])
        differ, held = [], []
        for name, args, kw, res in kept:
            plain = dispatch[name][2](*args, **kw)
            same = all(same_bits(a, b) if a.dtype == torch.float32 else torch.equal(a, b) for a, b in zip(res, plain))
            held.append(name)
            if not same:
                differ.append(name)
        edges = [a[2].shape[0] for name, a, _, _ in kept if name == "estimate_pose"]
        levels = [a[5].levels for name, a, _, _ in kept if name == "klt_pyramid_frame"]
        patches = [a[5].half_patch for name, a, _, _ in kept if name in ("klt_pyramid_anchored", "klt_pyramid_frame")]
        n_track, n_kf = n - 1, int(kf.sum())
        track = [frame_ms[i] for i in range(WARMUP, n) if not kf[i]]
        print(f"widened {label}: statuses {statuses.tolist()}", flush=True)
        print(f"widened {label}: keyframes {n_kf}, launches {launches} (tracking frames {n_track}), ATE {ate:.5f} m; "
              f"on frame {n - 1} the plain versions on each launch's own inputs ({held}; half-patches {patches}, "
              f"levels {levels}, pose edges {edges}, the shared copy holds {pose_k.shared_edges(dev)}) differ in "
              f"{differ}; {np.mean(frame_ms[WARMUP:]):.3f} ms/frame, tracking frames median {np.median(track):.3f} ms "
              f"on {kind} ({smi})", flush=True)
        check(bool((statuses == FrontendStatus.TRACKING_GOOD).all()), f"a frame did not track {label}")
        check(bool(np.isfinite(T_wc).all()), f"non-finite trajectory {label}")
        check(held and not differ, f"a kernel and its plain version differ {label}: {differ}")
        check(launches["estimate_pose"] >= n_track, f"K2 was not launched on every tracking frame {label}")
        if config["track_mode"] == "frame":
            check(launches["klt_pyramid_frame"] >= n_track and levels and min(levels) == config["klt_pyramid_levels"],
                  f"K1's frame entry did not run over {config['klt_pyramid_levels']} levels {label}")
        else:
            check(launches["klt_pyramid_anchored"] >= n_track and patches and set(patches) == {config["klt_half_patch"]},
                  f"K1 did not run at half-patch {config['klt_half_patch']} {label}")
            check(edges and min(edges) > pose_k.shared_edges(dev), f"K2 did not read its edges from global memory {label}")
            check(ate < ATE_MAX, f"ATE {ate:.4f} m {label}")
        out.append(launches)
    return out


def kitti_errors(T_wc, gt):
    """(ATE rigidly aligned, drift in m per 100 m as the JAX soak measures it:
    the last frame's error over the path length, evaluation.drift_rate)."""
    from legoslam_tpu_torch.utils import evaluation

    pos, gt_pos = T_wc[:, :3, 3], gt[: len(T_wc), :3, 3]
    path = np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum()
    return (evaluation.ate_rmse(pos, gt_pos), 100.0 * np.linalg.norm(pos[-1] - gt_pos[-1]) / path,
            evaluation.drift_rate(T_wc, gt[: len(T_wc)]))


def run_kitti_steps(kind, smi, kitti_root, scratch, reset_counts, read_counts):
    """Steps 10 and 11; returns the kernel launches of step 11's API run."""
    import re

    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    repo = os.path.dirname(os.path.abspath(__file__))
    config_file = os.path.join(repo, "config", "kitti_00.yaml")

    # --- 10. KITTI through the command line, at full size ----------------------
    out_dir = os.path.join(scratch, "out")
    cmd = [sys.executable, "-m", "legoslam_tpu_torch.apps.run_kitti", "--config_file", config_file,
           "--dataset_dir", kitti_root, "--out_dir", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=repo)
    cli_s = time.perf_counter() - t0
    log = proc.stderr
    check(proc.returncode == 0, f"the KITTI command line exited {proc.returncode}: {log[-3000:]}")
    traj_path = os.path.join(out_dir, "trajectory_kitti.txt")
    T_cli = np.stack(evaluation.load_kitti_trajectory(traj_path))
    decoder = re.search(r"decoder (\w+)", log)
    timing = re.search(r"processed (\d+) frames, \d+ active keyframes, ([\d.]+) ms \(([\d.]+) ms/frame\)", log)
    ate_line = re.search(r"ATE RMSE: ([\d.]+) m \| RPE: ([\d.]+) m / ([\d.]+) deg", log)
    dropped = re.search(r"BA dropped (\d+)", log)
    gt = KittiDataset(kitti_root, use_native=False)
    check(gt.init() and gt.ground_truth is not None, "the KITTI sequence has no ground truth")
    gt = gt.ground_truth
    ate, drift, drift_seg = kitti_errors(T_cli, gt)
    print(f"kitti cli: `python -m legoslam_tpu_torch.apps.run_kitti --config_file config/kitti_00.yaml "
          f"--dataset_dir <seq> --out_dir <tmp>` on the soak's first {KITTI_FRAMES} frames "
          f"({SOAK_SHAPE[0]}x{SOAK_SHAPE[1]} PNGs, read at {SOAK_SHAPE[0] // 2}x{SOAK_SHAPE[1] // 2}): exit "
          f"{proc.returncode}, {cli_s:.1f} s in all, decoder {decoder and decoder.group(1)}, "
          f"{len(T_cli)} poses", flush=True)
    print(f"kitti cli: {timing and timing.group(2)} ms for {timing and timing.group(1)} frames "
          f"({timing and timing.group(3)} ms/frame, host clock, the first frames' warm-up included); its log: "
          f"ATE {ate_line and ate_line.group(1)} m, RPE {ate_line and ate_line.group(2)} m / "
          f"{ate_line and ate_line.group(3)} deg per frame; BA slots dropped {dropped.group(1) if dropped else 0}",
          flush=True)
    print(f"kitti cli: ATE {ate:.5f} m (bar {KITTI_ATE_MAX}; JAX reference at bf16 {REF_KITTI_ATE} m), drift {drift:.4f} m "
          f"per 100 m (bar {KITTI_DRIFT_MAX}; JAX reference at bf16 {REF_KITTI_DRIFT}), drift_rate {drift_seg:.4f} on {kind} "
          f"({smi})", flush=True)
    check(decoder is not None and timing is not None and ate_line is not None, "the command line's log is incomplete")
    check(len(T_cli) == KITTI_FRAMES and int(timing.group(1)) == KITTI_FRAMES,
          f"{len(T_cli)} poses for {KITTI_FRAMES} frames")
    check(bool(np.isfinite(T_cli).all()) and ate < KITTI_ATE_MAX, f"ATE {ate:.4f} m (KITTI command line)")
    check(drift < KITTI_DRIFT_MAX, f"drift {drift:.4f} m per 100 m (KITTI command line)")

    # --- 11. the same frames through the API, then resume ----------------------
    config = Config.from_yaml(config_file)
    check(config["max_active_landmarks"] == 4096, "config/kitti_00.yaml's BA width is not 4096")

    def kitti_vo():
        vo = VisualOdometry(config=config, dataset=KittiDataset(kitti_root, scale=config["image_scale"]))
        check(vo.device.type == "cuda", f"VisualOdometry runs on {vo.device} (KITTI)")
        check(vo.init(), "VisualOdometry.init failed (KITTI)")
        return vo

    ba_step, ba_calls = backend.ba_step, []

    def timed_ba_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ba_step(*args)
        torch.cuda.synchronize()
        ba_calls.append((1e3 * (time.perf_counter() - t0), args[0].caps.active_landmarks))
        return out

    vo = kitti_vo()
    backend.ba_step = timed_ba_step
    try:
        reset_counts()
        frame_ms = []
        while True:
            t0 = time.perf_counter()
            more = vo.step()
            torch.cuda.synchronize()
            if not more:
                break
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        launches = read_counts()
    finally:
        backend.ba_step = ba_step
    statuses, kf = vo.statuses(), vo.keyframe_flags()
    n_kf = int(kf.sum())
    T_api = vo.trajectory_T_wc()
    dropped_api = int(torch.stack([o.ba.n_dropped_landmarks for o in vo.outputs]).sum())
    evaluation.save_kitti_trajectory(os.path.join(scratch, "api.txt"), T_api)
    with open(traj_path) as a, open(os.path.join(scratch, "api.txt")) as b:
        same_text = a.read() == b.read()
    track = [frame_ms[i] for i in range(WARMUP, len(frame_ms)) if not kf[i]]
    kfs = [frame_ms[i] for i in range(WARMUP, len(frame_ms)) if kf[i]]
    ba_ms = [c[0] for c in ba_calls[1:]]
    ate_api, drift_api, _ = kitti_errors(T_api, gt)
    print(f"kitti api: {len(statuses)} frames, keyframes {n_kf} (JAX reference {REF_KITTI_KEYFRAMES}), lost "
          f"{int((statuses == FrontendStatus.LOST).sum())}, statuses other than TRACKING_GOOD "
          f"{int((statuses != FrontendStatus.TRACKING_GOOD).sum())}, launches {launches}; its trajectory file equals "
          f"the command line's: {same_text}; ATE {ate_api:.5f} m, drift {drift_api:.4f} m per 100 m", flush=True)
    print(f"kitti api: {np.mean(frame_ms[WARMUP:]):.3f} ms/frame over frames {WARMUP}..{len(frame_ms) - 1} (each "
          f"ends in a synchronize); tracking frames n={len(track)} median {np.median(track):.3f} ms; keyframe "
          f"frames n={len(kfs)} median {np.median(kfs):.3f} ms; window BA at L={ba_calls[-1][1]} median "
          f"{np.median(ba_ms):.3f} ms (n={len(ba_ms)}, the first call apart), max {np.max(ba_ms):.3f} ms; BA "
          f"slots dropped {dropped_api} on {kind} ({smi})", flush=True)
    check(not (statuses == FrontendStatus.LOST).any(), "a KITTI frame was LOST")
    check(all(c[1] == 4096 for c in ba_calls) and len(ba_calls) == n_kf, "window BA did not run at L=4096")
    check(abs(n_kf - REF_KITTI_KEYFRAMES) <= KITTI_KEYFRAME_TOL,
          f"{n_kf} keyframes, JAX reference {REF_KITTI_KEYFRAMES}")
    check(same_text, "the API run and the command line gave two trajectories")
    check(all(launches[k] >= len(statuses) - 1 for k in MAIN_KERNELS),
          "a kernel was not launched on every tracking frame (KITTI)")

    full = kitti_vo()
    for _ in range(RESUME_FRAMES):
        check(full.step(), "the KITTI sequence ended early")
    first = kitti_vo()
    for _ in range(RESUME_AT):
        check(first.step(), "the KITTI sequence ended early")
    ckpt = os.path.join(scratch, "resume.npz")
    t0 = time.perf_counter()
    ckpt = first.save_checkpoint(ckpt)
    save_ms = 1e3 * (time.perf_counter() - t0)
    resumed = kitti_vo()
    t0 = time.perf_counter()
    resumed.load_checkpoint(ckpt)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    at = resumed.dataset.current_index
    for _ in range(RESUME_FRAMES - RESUME_AT):
        check(resumed.step(), "the KITTI sequence ended early after the resume")
    T_full, T_res = full.trajectory_T_cw(), resumed.trajectory_T_cw()
    equal = T_full.shape == T_res.shape and bool((T_full == T_res).all())
    same_prefix = bool((T_full == vo.trajectory_T_cw()[:RESUME_FRAMES]).all())
    print(f"resume: {RESUME_FRAMES} frames uninterrupted against {RESUME_AT} + checkpoint + {RESUME_FRAMES - RESUME_AT} "
          f"in a fresh VisualOdometry: trajectories bit-equal {equal}, frame ids equal "
          f"{resumed.frame_ids == full.frame_ids}, dataset index {at} after the load and "
          f"{resumed.dataset.current_index} at the end; the uninterrupted run equals the first {RESUME_FRAMES} "
          f"frames of step 11's: {same_prefix}; checkpoint {os.path.getsize(ckpt)} bytes, saved in {save_ms:.1f} ms, "
          f"loaded in {load_ms:.1f} ms (host clock) on {kind} ({smi})", flush=True)
    check(at == RESUME_AT and resumed.dataset.current_index == RESUME_FRAMES, "the dataset did not seek")
    check(resumed.frame_ids == full.frame_ids == list(range(RESUME_FRAMES)), "frame ids differ after the resume")
    check(equal, "the resumed run differs from the uninterrupted one")
    check(same_prefix, "two API runs of the KITTI sequence differ")
    return launches


if __name__ == "__main__":
    main()
