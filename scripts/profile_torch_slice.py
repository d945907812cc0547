"""Where a frame's time goes in the PyTorch/CUDA port (the default path,
window BA inline), on one GPU.

    python3 scripts/profile_torch_slice.py [--frames 21] [--warmup 4]

Renders the bench plane world (bench.py's sequence at 188x620), runs
`VisualOdometry(device="cuda")` over it and prints:
1. wall time per frame (host clock, each frame ends in a synchronize), split
   into tracking-only frames and keyframe frames, and keyframe frames into
   window BA (`backend.ba_step`, timed between two synchronizes) and the
   rest; four runs in turn, with BA off, inline, inline, off, so the two
   paths are compared within one call;
2. a torch.profiler table over the frames after warm-up (a second run), with
   the device-busy share: summed device time of all kernels over the
   window's wall time, the kernel launches per frame, and the device time
   per launch of the two hand-written kernels;
3. one `ba_step` on the map of the last keyframe, profiled alone: its wall
   time, kernel launches, device time, and host reads (CUDA's sync debug
   mode counts them).
4. the frame-mode and loop-closure path: the same frames with `track_mode:
   frame`, `stereo_matcher: klt` and `use_loop_closure` (the closer's
   `min_gap` cut to 2 keyframes, so that the revisit-free bench world still
   verifies candidates), under the profiler: ms/frame, device-busy share,
   kernel launches per frame, the frame-mode KLT kernel's launches and
   device time per launch, and the closer's stats.
Every number is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legoslam_tpu_torch.pipeline import backend  # noqa: E402
from legoslam_tpu_torch.pipeline.dataset import StereoFrame, SyntheticPlanesDataset  # noqa: E402
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry  # noqa: E402
from legoslam_tpu_torch.utils.config import Config  # noqa: E402


class _Frames:
    def __init__(self, frames, rig):
        self.frames, self.rig, self.i = frames, rig, 0

    def init(self):
        self.i = 0
        return True

    def next_frame(self):
        if self.i >= len(self.frames):
            return None
        self.i += 1
        return StereoFrame(self.i - 1, *self.frames[self.i - 1])


def _vo(frames, rig, ba_mode="inline", **overrides):
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0, **overrides})
    vo = VisualOdometry(config=config, dataset=_Frames(frames, rig), ba_mode=ba_mode, device="cuda")
    if not vo.init():
        raise RuntimeError("VisualOdometry.init failed")
    return vo


def _launches(events) -> int:
    return sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=21)
    ap.add_argument("--warmup", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ds = SyntheticPlanesDataset(n_frames=args.frames, shape=(188, 620), focal=360.0, baseline=0.54,
                                speed=0.12, half_width=10.0, length=200.0)
    ds.init()
    frames = [(f.left, f.right) for f in iter(ds.next_frame, None)]

    # Each ba_step of the driver timed between two synchronizes; the
    # arguments of the last one are kept for step 3.
    ba_step = backend.ba_step
    ba_calls = []

    def timed_ba_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ba_step(*a)
        torch.cuda.synchronize()
        ba_calls.append((1e3 * (time.perf_counter() - t0), a))
        return out

    print(f"card: {smi}")
    backend.ba_step = timed_ba_step
    try:
        for ba_mode in ("off", "inline", "inline", "off"):
            vo = _vo(frames, ds.rig, ba_mode)
            for _ in range(args.warmup):
                vo.step()
            torch.cuda.synchronize()
            track_ms, kf_ms, kf_ba_ms = [], [], []
            while True:
                n_ba = len(ba_calls)
                t0 = time.perf_counter()
                if not vo.step():
                    break
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                if vo.outputs[-1].kf_inserted:
                    kf_ms.append(ms)
                    kf_ba_ms.append(sum(c[0] for c in ba_calls[n_ba:]))
                else:
                    track_ms.append(ms)
            rest = np.asarray(kf_ms) - np.asarray(kf_ba_ms)
            print(f"BA {ba_mode}: tracking frames n={len(track_ms)} median {np.median(track_ms):.3f} ms "
                  f"(min {np.min(track_ms):.3f}, max {np.max(track_ms):.3f}); keyframe frames n={len(kf_ms)} "
                  f"median {np.median(kf_ms):.3f} ms (min {np.min(kf_ms):.3f}, max {np.max(kf_ms):.3f}) = "
                  f"window BA median {np.median(kf_ba_ms):.3f} ms + the rest median {np.median(rest):.3f} ms "
                  f"({smi})")
    finally:
        backend.ba_step = ba_step

    vo = _vo(frames, ds.rig)
    for _ in range(args.warmup):
        vo.step()
    torch.cuda.synchronize()
    n = args.frames - args.warmup
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        while vo.step():
            pass
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # Kernel rows only: an aten op's row repeats the time of its kernels.
    device_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    launches = _launches(events)
    print(f"profiled {n} frames: wall {wall_us / n / 1e3:.3f} ms/frame (profiler on), device busy "
          f"{device_us / n / 1e3:.3f} ms/frame = {100.0 * device_us / wall_us:.1f}% of wall, "
          f"{launches / n:.0f} kernel launches/frame ({smi})")
    for name in ("klt_pyramid_anchored_kernel", "estimate_pose_kernel"):
        rows = [e for e in events if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in rows)
        us = sum(e.self_device_time_total for e in rows)
        print(f"{name}: {count} launches, {us / max(count, 1):.3f} us/launch of device time ({smi})")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))

    # 3. one ba_step alone, on the map just before the last keyframe's BA.
    ba_args = ba_calls[-1][1]
    ba_step(*ba_args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, stats = ba_step(*ba_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        ba_step(*ba_args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    n_launch = _launches(events)
    print(f"ba_step alone: wall {wall_ms:.3f} ms (profiler on), {n_launch} kernel launches "
          f"({n_launch / max(stats.attempts, 1):.1f} per LM attempt), device busy {device_ms:.3f} ms "
          f"({100.0 * device_ms / wall_ms:.1f}%), LM iterations {stats.iterations} attempts {stats.attempts}, "
          f"host reads {reads}, {int(stats.n_active_landmarks)} active landmarks ({smi})")
    print(events.table(sort_by="self_device_time_total", row_limit=15))

    # 4. the frame-mode + loop-closure path.
    vo = _vo(frames, ds.rig, track_mode="frame", stereo_matcher="klt", use_loop_closure=True, loop_min_gap=2,
             loop_zncc_min=0.3)
    for _ in range(args.warmup):
        vo.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        while vo.step():
            pass
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    rows = [e for e in events if e.device_type == DeviceType.CUDA and "klt_pyramid_frame_kernel" in e.key]
    count = sum(e.count for e in rows)
    print(f"frame mode + klt stereo + loop closure, profiled {n} frames: wall {wall_us / n / 1e3:.3f} ms/frame "
          f"(profiler on), device busy {100.0 * device_us / wall_us:.1f}% of wall, {_launches(events) / n:.0f} kernel "
          f"launches/frame; klt_pyramid_frame_kernel {count} launches ({count / n:.2f} per frame), "
          f"{sum(e.self_device_time_total for e in rows) / max(count, 1):.3f} us/launch of device time; keyframes "
          f"{int(vo.keyframe_flags().sum())}, closer stats {vo.loop_closer.stats} ({smi})")


if __name__ == "__main__":
    main()
