"""The JAX package's 1,000-frame KITTI-format soak (tests/test_kitti_soak.py)
through the port's command line, on one GPU.

    python3 scripts/kitti_soak_torch.py [--frames 1000] [--workers 8] [--cache DIR]

Renders the soak's sequence (376x1240, focal 720, baseline 0.54 m, the
S-curve at 0.3 m/frame, 6 occluders, photometric noise 1.5) with the port's
own dataset code (`chip_smoke.soak_world`) as KITTI lays a sequence out,
in worker processes, and keeps it under `--cache` (default: the system's
temporary directory) so that a second run skips the render.  Then runs
`python -m legoslam_tpu_torch.apps.run_kitti --dataset_dir <seq> --out_dir
<tmp> --log_every 1` (default config, as the JAX soak runs
`apps/run_kitti.py`) and prints the frames that were not TRACKING_GOOD (from
the per-frame log), the path length, ATE, the last frame's error and the
drift in m per 100 m (the last frame's error over the path), against the
JAX soak's bar of 2.0 (tests/test_kitti_soak.py:147).  Exits non-zero where
the run fails or the drift is over the bar.

The S-curve leaves the 12 m half-width corridor at frame 460 (x = 12.02 m,
26.4 m at most), and the JAX package's run, like the port's, loses track
at frame 461; so the drift is also printed over the frames before the
camera leaves the corridor.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

DRIFT_BAR = 2.0  # m per 100 m, tests/test_kitti_soak.py:147


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=chip_smoke.SOAK_FRAMES)
    ap.add_argument("--workers", type=int, default=max(1, min(8, os.cpu_count() or 1)))
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "legoslam_torch_soak_v1"))
    args = ap.parse_args()
    root = os.path.join(args.cache, f"{args.frames}", "07")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(root, "COMPLETE")):
        with ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            chip_smoke.start_soak_sequence(pool, args.workers, root, args.frames)()
        with open(os.path.join(root, "COMPLETE"), "w") as f:
            f.write("ok\n")
        print(f"soak: wrote {args.frames} frames to {root} in {time.perf_counter() - t0:.1f} s "
              f"({args.workers} processes)", flush=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if shutil.which("nvidia-smi") else "")

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "legoslam_tpu_torch.apps.run_kitti", "--dataset_dir", root,
                               "--out_dir", out_dir, "--log_every", "1"], capture_output=True, text=True, cwd=REPO)
        run_s = time.perf_counter() - t0
        print("\n".join(line for line in proc.stderr.splitlines() if "legoslam.app]" in line or "VO:" in line),
              flush=True)
        statuses = re.findall(r"frame (\d+): (\w+) tracked=", proc.stderr)
        off = [(int(i), st) for i, st in statuses if st != "TRACKING_GOOD"]
        print(f"soak: {len(statuses)} frames logged, not TRACKING_GOOD: {len(off)} {off[:40]}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            return proc.returncode
        est = np.loadtxt(os.path.join(out_dir, "trajectory_kitti.txt")).reshape(-1, 3, 4)
    gt = chip_smoke.soak_trajectory()[: args.frames]
    pos, gt_pos = est[:, :, 3], gt[:, :3, 3]
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    final = float(np.linalg.norm(pos[-1] - gt_pos[-1]))
    drift = 100.0 * final / path
    ate = float(np.sqrt(np.mean(np.sum((pos - gt_pos) ** 2, axis=1))))
    outside = np.nonzero(np.abs(gt_pos[:, 0]) > chip_smoke.SOAK_HALF_WIDTH)[0]
    k = int(outside[0]) if len(outside) else len(gt_pos)
    path_in = float(np.linalg.norm(np.diff(gt_pos[:k], axis=0), axis=1).sum())
    print(f"soak: inside the corridor (frames 0..{k - 1}, {path_in:.1f} m): final error "
          f"{np.linalg.norm(pos[k - 1] - gt_pos[k - 1]):.4f} m, drift "
          f"{100.0 * np.linalg.norm(pos[k - 1] - gt_pos[k - 1]) / path_in:.4f} m per 100 m", flush=True)
    print(f"soak: {len(est)} frames in {run_s:.1f} s (the command line, start-up included), path {path:.1f} m, "
          f"ATE {ate:.4f} m (unaligned, as the JAX soak), final error {final:.4f} m, drift {drift:.4f} m per "
          f"100 m (bar {DRIFT_BAR}) on {smi or 'a host without nvidia-smi'}", flush=True)
    return 0 if len(est) == args.frames and drift < DRIFT_BAR else 1


if __name__ == "__main__":
    sys.exit(main())
