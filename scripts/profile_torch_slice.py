"""Where a frame's time goes in the PyTorch/CUDA port (window BA off), on one GPU.

    python3 scripts/profile_torch_slice.py [--frames 16] [--warmup 4]

Renders the bench plane world (bench.py's sequence at 188x620), runs
`VisualOdometry(ba_mode="off", device="cuda")` over it and prints:
1. wall time per frame (host clock, the frame ends in a device read), split
   into tracking-only frames and keyframe frames;
2. a torch.profiler table over the frames after warm-up (a second run), with
   the device-busy share: summed device time of all kernels over the
   window's wall time, the kernel launches per frame, and the device time
   per launch of the two hand-written kernels.
Every number is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


def _vo(frames, rig):
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    vo = VisualOdometry(config=config, dataset=_Frames(frames, rig), ba_mode="off", device="cuda")
    if not vo.init():
        raise RuntimeError("VisualOdometry.init failed")
    return vo


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
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

    vo = _vo(frames, ds.rig)
    for _ in range(args.warmup):
        vo.step()
    torch.cuda.synchronize()
    track_ms, kf_ms = [], []
    while True:
        t0 = time.perf_counter()
        if not vo.step():
            break
        torch.cuda.synchronize()
        (kf_ms if vo.outputs[-1].kf_inserted else track_ms).append(1e3 * (time.perf_counter() - t0))
    print(f"card: {smi}")
    print(f"tracking frames: n={len(track_ms)} median {np.median(track_ms):.3f} ms, "
          f"min {np.min(track_ms):.3f}, max {np.max(track_ms):.3f}")
    if kf_ms:
        print(f"keyframe frames: n={len(kf_ms)} median {np.median(kf_ms):.3f} ms, "
              f"min {np.min(kf_ms):.3f}, max {np.max(kf_ms):.3f}")

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
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
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


if __name__ == "__main__":
    main()
