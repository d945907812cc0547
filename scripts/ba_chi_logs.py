"""Window BA's chi per keyframe in two sets of runs of one sequence, from
their per-frame logs (`--log_every 1`, as `scripts/kitti_soak_torch.py
--save-log` keeps them), and the first keyframe at which a run leaves the
reference runs' own spread.

    python3 scripts/ba_chi_logs.py --reference REF.log [REF.log ...] --runs RUN.log [RUN.log ...]

Both packages log `frame N: STATUS ... KF ... | BA chi=X ...` on keyframe
frames.  The reference runs (e.g. the JAX package under XLA's CPU
instruction sets, ROADMAP C17) give, at each keyframe frame they share, a
spread: (largest chi - smallest) / smallest.  A run leaves that spread at
a keyframe where its chi lies further from the nearest reference chi, in
relative terms, than the spread itself.  Prints the first frame at which
the keyframe flags differ, the first keyframe each run leaves the spread,
and a table of chi per keyframe up to `--rows` rows past the first
departure.
"""

from __future__ import annotations

import argparse
import re
import sys


def read_log(path: str):
    """{frame: (status, keyframe, chi or None)} of one run's log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.search(r"frame (\d+): (\w+) tracked=", line)
            if not m:
                continue
            chi = re.search(r"\| BA chi=(\S+)", line)
            out[int(m.group(1))] = (m.group(2), " KF " in line, float(chi.group(1)) if chi else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", nargs="+", required=True, metavar="LOG")
    ap.add_argument("--runs", nargs="+", required=True, metavar="LOG")
    ap.add_argument("--rows", type=int, default=8, help="table rows past the first departure")
    args = ap.parse_args()
    refs = [read_log(p) for p in args.reference]
    runs = [read_log(p) for p in args.runs]
    frames = sorted(set.intersection(*(set(r) for r in refs + runs)))
    if not frames:
        print("ba_chi_logs: the logs share no frame")
        return 1
    kf_sets = [{k for k in frames if r[k][1]} for r in refs + runs]
    differ = [k for k in frames if len({r[k][1] for r in refs + runs}) > 1]
    print(f"ba_chi_logs: {len(frames)} frames in every log; keyframes {[len(s) for s in kf_sets]} "
          f"(reference runs first); keyframe flags first differ at frame {differ[0] if differ else None}")
    shared = [k for k in frames if all(r[k][1] and r[k][2] is not None and r[k][2] > 0 for r in refs + runs)]
    # The first BA holds one keyframe and ends at a chi at the rounding level.
    shared = [k for k in shared if min(r[k][2] for r in refs) > 1e-3]
    rows, first = [], {}
    for k in shared:
        ref = [r[k][2] for r in refs]
        spread = (max(ref) - min(ref)) / min(ref)
        gaps = [min(abs(run[k][2] - c) / c for c in ref) for run in runs]
        for i, g in enumerate(gaps):
            if g > spread and i not in first:
                first[i] = k
        rows.append((k, ref, spread, [run[k][2] for run in runs], gaps))
    for i, path in enumerate(args.runs):
        print(f"ba_chi_logs: {path} first leaves the reference runs' spread at keyframe frame {first.get(i)} "
              f"(of {len(shared)} keyframe frames shared by every log)")
    end = min(first.values(), default=shared[-1] if shared else 0)
    print("  frame  reference chi (each run)  spread  | run chi (each) / relative distance from the nearest")
    for k, ref, spread, chi, gaps in [r for r in rows if r[0] <= end] + [r for r in rows if r[0] > end][:args.rows]:
        print(f"  {k:5d}  {' '.join(f'{c:9.2f}' for c in ref)}  {spread:7.4f}  | "
              + " ".join(f"{c:9.2f} / {g:.4f}{' *' if g > spread else ''}" for c, g in zip(chi, gaps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
