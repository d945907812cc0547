"""Tracking-frame wall time of two trees of the port, in turns on one GPU.

    python3 scripts/ab_tracking_torch.py TREE_A TREE_B      # e.g. an unpacked parent commit and .

Renders chip_smoke.py's 40-frame bench world once (6 processes), then runs
the default path (`VisualOdometry`, BA inline) over it twice per turn in a
process of its own for each tree, in turns A B B A, each frame ending in a
synchronize; prints per turn the median and mean wall ms of the tracking
frames (frames 4..39 without a keyframe), the keyframe frames' median, and
the pose kernel's device time on chip_smoke's pose inputs.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree: str, frames_path: str) -> dict:
    """One turn, in this process (started by `main` with the tree first on
    sys.path)."""
    import torch

    import chip_smoke as cs
    from legoslam_tpu_torch.kernels import pose as pose_k
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    d = np.load(frames_path)
    frames = [(d[f"l{i}"], d[f"r{i}"]) for i in range(cs.N_FRAMES)]
    ds = cs.bench_world(cs.N_FRAMES)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    out = {"tree": tree}
    for run in range(2):
        vo = VisualOdometry(config=config, dataset=cs.FrameList(frames, ds.rig))
        assert vo.init()
        ms = []
        for _ in range(cs.N_FRAMES):
            t0 = time.perf_counter()
            vo.step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        kf = vo.keyframe_flags()
        track = [ms[i] for i in range(cs.WARMUP, cs.N_FRAMES) if not kf[i]]
        out[f"run{run}"] = {"tracking_median_ms": float(np.median(track)), "tracking_mean_ms": float(np.mean(track)),
                            "keyframe_median_ms": float(np.median([ms[i] for i in range(cs.WARMUP, cs.N_FRAMES)
                                                                   if kf[i]]))}
    intr, T_prior, P, uv, valid, _ = cs.pose_inputs(torch.device("cuda:0"))
    out["pose_kernel_device_us"] = 1e3 * cs.device_ms(lambda: pose_k.estimate_pose_kernel(intr, T_prior, P, uv, valid))
    return out


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        tree = os.path.abspath(sys.argv[2])
        sys.path.insert(0, tree)
        os.chdir(tree)
        print(json.dumps(run_tree(sys.argv[2], sys.argv[3])), flush=True)
        return
    trees = sys.argv[1:3]
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    with ProcessPoolExecutor(6, mp_context=multiprocessing.get_context("spawn")) as pool:
        frames = cs.render_worlds(pool, 6, kinds=("bench",))()["bench"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npz")
        np.savez(path, **{f"l{i}": f[0] for i, f in enumerate(frames)}, **{f"r{i}": f[1] for i, f in enumerate(frames)})
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"ab tracking: {trees[0]} against {trees[1]} on {smi}", flush=True)
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree, path],
                                  capture_output=True, text=True)
            print(proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 else proc.stderr[-2000:], flush=True)


if __name__ == "__main__":
    main()
