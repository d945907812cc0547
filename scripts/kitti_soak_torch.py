"""The JAX package's 1,000-frame KITTI-format soak (tests/test_kitti_soak.py)
through the port's command line, on one GPU.

    python3 scripts/kitti_soak_torch.py [--frames 1000] [--course s_curve|level|clear] [--workers 8] [--cache DIR]
                                        [--device cpu]
                                        [--app jax [--xla-isa AVX2]] [--save-trajectory OUT]
                                        [--against TRAJ ...] [--config_file YAML] [--set KEY=VALUE ...]

Renders the soak's sequence (376x1240, focal 720, baseline 0.54 m, the
S-curve at 0.3 m/frame, 6 occluders, photometric noise 1.5) with the port's
own dataset code (`chip_smoke.soak_world`) as KITTI lays a sequence out,
in worker processes, and keeps it under `--cache` (default: the system's
temporary directory) so that a second run skips the render.  Then runs
`python -m legoslam_tpu_torch.apps.run_kitti --dataset_dir <seq> --out_dir
<tmp> --log_every 1` (default config, as the JAX soak runs
`apps/run_kitti.py`; `--config_file` and `--set key=value`, the latter
written over the former into a temporary YAML, go to either command, e.g.
`--set ba_assembly_precision=f32`) and prints the frames that were not TRACKING_GOOD (from
the per-frame log), the path length, ATE, the last frame's error and the
drift in m per 100 m (the last frame's error over the path), against the
JAX soak's bar of 2.0 (tests/test_kitti_soak.py:147).  Exits non-zero where
the run fails or the drift is over the bar.  `--device cpu` runs the port's
command on the CPU; `--app jax` runs the JAX package's command
(`apps/run_kitti.py`, on the CPU) on the same frames instead, with
`--xla_cpu_max_isa` set to `--xla-isa` where given (the reference's
trajectory moves with XLA's CPU instruction set, ROADMAP C17).
`--save-trajectory OUT` keeps the run's `trajectory_kitti.txt` and
`--save-log OUT` its per-frame log (read by `scripts/ba_chi_logs.py`);
`--load-trajectory TRAJ` evaluates such a file instead of running a
command; `--against TRAJ ...` prints, for each such file of an earlier run
on the same frames, the largest distance between the two runs' camera positions
per 50 frames, the first frame at which it passes 0.05, 0.1 and 0.2 m, and
the largest distance between their frame-to-frame motions.

`--course` picks the camera's path through the same world
(`chip_smoke.soak_trajectory`).  "s_curve" (the default) is the JAX soak's:
its heading swings between 0 and +0.18 rad, so it leaves the 12 m
half-width corridor at frame 460 (x = 12.02 m, 26.4 m at most), and the
JAX package's run, like the port's, loses track at frame 461; so the drift
is also printed over the frames before the camera leaves the corridor.
"level" turns by 0.0018 cos(2 pi k / 320) a frame where the S-curve turns
by 0.0018 sin(2 pi k / 320): the same speed, world, occluders and noise,
with a heading of +-0.092 rad about the corridor's axis, so the camera
stays within 3.02 m of it for all 1,000 frames; but it drives through
occluder 3 at frame 61 and occluder 2 at frame 264, where the tracked set
collapses.  "clear" turns by 0.0018 cos(2 pi k / 320 + 2.847): the same
family, within 9.50 m of the axis, every occluder passed at 1.51 m or more
(ROADMAP C14).  Before it runs anything the script prints the course's
largest |x| and its clearance from each occluder it reaches.
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
from legoslam_tpu_torch.utils import evaluation  # noqa: E402

DRIFT_BAR = 2.0  # m per 100 m, tests/test_kitti_soak.py:147


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=chip_smoke.SOAK_FRAMES)
    ap.add_argument("--course", choices=chip_smoke.SOAK_COURSES, default="s_curve")
    ap.add_argument("--workers", type=int, default=max(1, min(8, os.cpu_count() or 1)))
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "legoslam_torch_soak_v1"))
    ap.add_argument("--device", default="cuda", help="the port's --device")
    ap.add_argument("--app", choices=("port", "jax"), default="port")
    ap.add_argument("--xla-isa", default="", help="with --app jax: XLA's --xla_cpu_max_isa")
    ap.add_argument("--save-trajectory", default=None, metavar="OUT")
    ap.add_argument("--save-log", default=None, metavar="OUT", help="keep the command's log (scripts/ba_chi_logs.py)")
    ap.add_argument("--against", nargs="*", default=[], metavar="TRAJ")
    ap.add_argument("--config_file", default=None, help="YAML config for the command (default: none)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config keys over --config_file's, values read as YAML")
    ap.add_argument("--load-trajectory", default=None, metavar="TRAJ",
                    help="evaluate a run saved with --save-trajectory instead of running a command")
    args = ap.parse_args()
    pos = chip_smoke.soak_trajectory(course=args.course)[: args.frames, :3, 3]
    x = np.abs(pos[:, 0])
    print(f"soak: course {args.course}, {args.frames} frames, largest |x| {x.max():.4f} m at frame {int(np.argmax(x))} "
          f"(corridor half width {chip_smoke.SOAK_HALF_WIDTH} m); {occluder_clearance(pos)}", flush=True)
    if args.load_trajectory:
        est = np.loadtxt(args.load_trajectory).reshape(-1, 3, 4)
        return evaluate(args, est, None, f"the run saved in {args.load_trajectory}")
    # the S-curve keeps the cache layout it had before the courses
    root = os.path.join(args.cache, *(() if args.course == "s_curve" else (args.course,)), f"{args.frames}", "07")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(root, "COMPLETE")):
        with ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            chip_smoke.start_soak_sequence(pool, args.workers, root, args.frames, args.course)()
        with open(os.path.join(root, "COMPLETE"), "w") as f:
            f.write("ok\n")
        print(f"soak: wrote {args.frames} frames to {root} in {time.perf_counter() - t0:.1f} s "
              f"({args.workers} processes)", flush=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if shutil.which("nvidia-smi") else "")

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        cmd, env = [sys.executable, "-m", "legoslam_tpu_torch.apps.run_kitti", "--device", args.device], None
        if args.app == "jax":
            flags = os.environ.get("XLA_FLAGS", "") + (f" --xla_cpu_max_isa={args.xla_isa}" if args.xla_isa else "")
            cmd, env = [sys.executable, "apps/run_kitti.py"], {**os.environ, "JAX_PLATFORMS": "cpu",
                                                             "XLA_FLAGS": flags.strip()}
        config_file = args.config_file
        if args.set:
            import yaml

            values = {}
            if config_file:
                with open(config_file) as f:
                    values = yaml.safe_load(f) or {}
            for item in args.set:
                key, sep, value = item.partition("=")
                if not sep:
                    ap.error(f"--set expects KEY=VALUE, got {item!r}")
                values[key] = yaml.safe_load(value)
            config_file = os.path.join(out_dir, "config.yaml")
            with open(config_file, "w") as f:
                yaml.safe_dump(values, f)
        config = ["--config_file", os.path.abspath(config_file)] if config_file else []
        proc = subprocess.run(cmd + config + ["--dataset_dir", root, "--out_dir", out_dir, "--log_every", "1"],
                              capture_output=True, text=True, cwd=REPO, env=env)
        run_s = time.perf_counter() - t0
        if args.save_log:
            with open(args.save_log, "w") as f:
                f.write(proc.stderr)
        print("\n".join(line for line in proc.stderr.splitlines() if "legoslam.app]" in line or "VO:" in line),
              flush=True)
        statuses = re.findall(r"frame (\d+): (\w+) tracked=", proc.stderr)
        off = [(int(i), st) for i, st in statuses if st != "TRACKING_GOOD"]
        print(f"soak: {len(statuses)} frames logged, not TRACKING_GOOD: {len(off)} {off[:40]}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            return proc.returncode
        est = np.loadtxt(os.path.join(out_dir, "trajectory_kitti.txt")).reshape(-1, 3, 4)
        if args.save_trajectory:
            shutil.copyfile(os.path.join(out_dir, "trajectory_kitti.txt"), args.save_trajectory)
    where = smi if args.app == "port" and args.device != "cpu" else "the CPU"
    return evaluate(args, est, run_s, f"{args.app} on {where}")


def occluder_clearance(pos) -> str:
    """Where the camera path (T_wc positions) crosses each occluder's plane,
    its distance from the occluder's rectangle (negative: through it)."""
    out = []
    for i, (xc, yc, zc, w, h, _, _) in enumerate(chip_smoke.soak_world(1).occluders):
        k = int(np.argmin(np.abs(pos[:, 2] - zc)))
        if abs(pos[k, 2] - zc) <= 0.3:  # the path reaches the plane (0.3 m per frame)
            gap = max(abs(pos[k, 0] - xc) - w / 2, abs(pos[k, 1] - yc) - h / 2)
            out.append((gap, k, i))
    if not out:
        return "no occluder on the path"
    through = [f"occluder {i} at frame {k}" for gap, k, i in sorted(out) if gap < 0]
    gap, k, i = min(out)
    return (f"closest occluder {i}: {gap:.2f} m at frame {k}"
            + (f"; the camera passes through {', '.join(through)}" if through else ""))


def evaluate(args, est, run_s, what) -> int:
    """Print the run's distance from the `--against` runs and its errors
    against the ground truth; 0 where it has every frame and drifts under
    the bar."""
    for path in args.against:
        other = np.loadtxt(path).reshape(-1, 3, 4)
        gap = np.linalg.norm(est[:, :, 3] - other[:, :, 3], axis=1)
        firsts = {bar: int(np.argmax(gap > bar)) if (gap > bar).any() else None for bar in (0.05, 0.1, 0.2)}

        def steps(T):
            R, t = T[:, :, :3], T[:, :, 3]
            return np.einsum("nji,nj->ni", R[:-1], t[1:] - t[:-1])  # frame k+1's position in frame k's camera

        step_gap = np.linalg.norm(steps(est) - steps(other), axis=1)
        print(f"soak against {path}: largest position distance per 50 frames "
              f"{[round(float(gap[i:i + 50].max()), 4) for i in range(0, len(gap), 50)]}; first frame past "
              f"0.05 / 0.1 / 0.2 m: {firsts[0.05]} / {firsts[0.1]} / {firsts[0.2]}; frame-to-frame motion apart by "
              f"{float(step_gap.max()):.4f} m at most (frame {int(np.argmax(step_gap))})", flush=True)
    gt = chip_smoke.soak_trajectory(course=args.course)[: args.frames]
    pos, gt_pos = est[:, :, 3], gt[:, :3, 3]
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    final = float(np.linalg.norm(pos[-1] - gt_pos[-1]))
    drift = 100.0 * final / path
    ate = float(np.sqrt(np.mean(np.sum((pos - gt_pos) ** 2, axis=1))))
    ate_aligned = evaluation.ate_rmse(pos, gt_pos)
    outside = np.nonzero(np.abs(gt_pos[:, 0]) > chip_smoke.SOAK_HALF_WIDTH)[0]
    k = int(outside[0]) if len(outside) else len(gt_pos)
    path_in = float(np.linalg.norm(np.diff(gt_pos[:k], axis=0), axis=1).sum())
    print(f"soak: inside the corridor (frames 0..{k - 1}, {path_in:.1f} m): final error "
          f"{np.linalg.norm(pos[k - 1] - gt_pos[k - 1]):.4f} m, drift "
          f"{100.0 * np.linalg.norm(pos[k - 1] - gt_pos[k - 1]) / path_in:.4f} m per 100 m", flush=True)
    took = f" in {run_s:.1f} s (the command line, start-up included)" if run_s is not None else ""
    print(f"soak: {len(est)} frames{took}, path {path:.1f} m, "
          f"ATE {ate:.4f} m (unaligned, as the JAX soak; {ate_aligned:.6f} m rigidly aligned, as chip_smoke.py's "
          f"step 10), final error {final:.4f} m, drift {drift:.4f} m per "
          f"100 m (bar {DRIFT_BAR}); course {args.course}; {what}"
          f"{f', --xla_cpu_max_isa={args.xla_isa}' if args.xla_isa else ''}"
          f"{f', --config_file {args.config_file}' if args.config_file else ''}"
          f"{f', --set {' '.join(args.set)}' if args.set else ''}", flush=True)
    return 0 if len(est) == args.frames and drift < DRIFT_BAR else 1


if __name__ == "__main__":
    sys.exit(main())
