"""Where the pose kernel's time goes, on one GPU: cycles by phase, and its
device time against another tree's pose kernel.

    python3 scripts/pose_kernel_cycles.py [--against TREE]

Builds legoslam_tpu_torch/csrc/pose.cu with POSE_CYCLES defined (its
CYCLES_* hooks: clock64 reads around each phase, summed by shared-memory
atomics) and runs it on chip_smoke.py's pose inputs (512 edges, 10% gross
outliers), then prints the cycles of each phase: per chunk the
producers' terms, per pass the chain warps' spans (b's, H's, chi's) and
their waits for a unit, the producers' waits for a ring slot and for the
pose, per LM attempt warp 0's span, its speculative candidate and its wait
for chi, and per accepted step warp 0's wait for b after its LU factor and
its serial step (the triangular solves and the retraction).  The counts
are per SM cycle and include the instrumentation's own atomics; the
compiler does not keep a clock read in place around a barrier, so a span
that ends at one is approximate (device_ms is the measure of record).
The kernel's output is not checked here (chip_smoke.py does that).

With --against TREE (e.g. the parent commit unpacked with `git archive`
into a gitignored directory), builds TREE's csrc/pose.cu beside this
tree's and times both (`chip_smoke.device_ms`) in turns A B B A on
chip_smoke's 512 edges, on 4096 edges and on the prior 0.3 rad off, after
checking that the two give the same pose, inliers and LM attempts.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from legoslam_tpu_torch.kernels import _build  # noqa: E402
from legoslam_tpu_torch.kernels import pose as pose_k  # noqa: E402

# g_cycles slots of csrc/pose.cu's CYCLES_* hooks: (name, divisor).  The
# divisors: "chunk" chunks produced (slot 15), "pass" passes, "attempt"
# LM attempts, "step" accepted steps that continue (slot 13); slot 16
# counts the rejected attempts.
SLOTS = {
    0: ("producer: one chunk's terms (lane 0)", "chunk"),
    1: ("producers: waiting for a free slot", "pass"),
    2: ("producer 0: waiting for the pose", "pass"),
    3: ("b warp: waiting for a unit", "pass"),
    4: ("H warp: waiting for a unit", "pass"),
    5: ("chi warp: waiting for a unit", "pass"),
    6: ("b warp: its chain, unit 0 in to sums out", "pass"),
    7: ("H warp: its chains and combine", "pass"),
    8: ("chi warp: its chain", "pass"),
    9: ("warp 0: waiting for chi", "attempt"),
    10: ("warp 0: waiting for b after its LU", "step"),
    11: ("warp 0: solves and retraction after b", "step"),
    12: ("warp 0: the rejection's candidate", "attempt"),
    14: ("warp 0: one attempt, publish to publish", "attempt"),
}
COUNT_STEPS, COUNT_CHUNKS, COUNT_REJECTS = 13, 15, 16
NSLOTS = 17
READER = '''
extern "C" int legoslam_pose_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[17] = {0};
    return (int)cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_cycles, 17 * sizeof(unsigned long long));
}
'''


def instrumented_source(src: str = None) -> str:
    """csrc/pose.cu with its cycle hooks on, and an entry that reads them."""
    if src is None:
        src = (_build.CSRC / "pose.cu").read_text()
    if "#ifdef POSE_CYCLES" not in src or "g_cycles" not in src:
        raise ValueError("pose.cu has no POSE_CYCLES hooks")
    return "#define POSE_CYCLES\n" + src + READER


def build(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), *_build._flags("pose"), "-Xptxas", "-v", "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    usage = [line.strip() for line in proc.stderr.splitlines() if "registers" in line or "stack frame" in line]
    print(f"built {name}: {' | '.join(usage)}", flush=True)
    return ctypes.CDLL(so)


def cycles(tmp: str, smi: str) -> None:
    lib = build(instrumented_source(), tmp, "pose_cycles")
    _build._loaded["pose"] = lib  # the wrapper now launches the instrumented kernel
    dev = torch.device("cuda:0")
    intr, T_prior, P, uv, valid, _ = chip_smoke.pose_inputs(dev)
    attempts = torch.zeros(4, dtype=torch.int32, device=dev)
    pose_k.estimate_pose_kernel(intr, T_prior, P, uv, valid, attempts=attempts)  # warm up
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * NSLOTS)()
    lib.legoslam_pose_cycles(buf, 1)
    pose_k.estimate_pose_kernel(intr, T_prior, P, uv, valid)
    torch.cuda.synchronize()
    lib.legoslam_pose_cycles(buf, 0)
    n_att = int(attempts.sum())
    per = {"pass": n_att + len(attempts), "attempt": n_att, "step": max(1, buf[COUNT_STEPS]),
           "chunk": max(1, buf[COUNT_CHUNKS])}
    print(f"pose kernel: {int(valid.shape[0])} edges, LM attempts per round {attempts.tolist()}, {per['pass']} "
          f"passes, {buf[COUNT_REJECTS]} rejected attempts, {buf[COUNT_STEPS]} accepted steps that continue, "
          f"{buf[COUNT_CHUNKS]} chunks on {smi}", flush=True)
    for slot, (name, unit) in SLOTS.items():
        print(f"  {name:44s} {buf[slot] / per[unit]:9.0f} cycles per {unit}", flush=True)


def against(tree: str, tmp: str) -> None:
    mine = build((_build.CSRC / "pose.cu").read_text(), tmp, "pose_this")
    other = build((Path(tree) / "legoslam_tpu_torch" / "csrc" / "pose.cu").read_text(), tmp, "pose_other")
    dev = torch.device("cuda:0")
    cases = {"512 edges": chip_smoke.pose_inputs(dev)[:5],
             f"{chip_smoke.POSE_MAX_EDGES} edges": chip_smoke.pose_inputs(dev, chip_smoke.POSE_MAX_EDGES)[:5],
             f"prior {chip_smoke.POSE_LARGE_ANGLE} rad off": chip_smoke.pose_inputs(dev, large_angle=True)[:5]}
    for label, args in cases.items():
        outs = []
        for lib in (mine, other):
            _build._loaded["pose"] = lib
            att = torch.zeros(4, dtype=torch.int32, device=dev)
            outs.append((*pose_k.estimate_pose_kernel(*args, attempts=att), att))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        times = []
        for name, lib in (("A", other), ("B", mine), ("B", mine), ("A", other)):
            _build._loaded["pose"] = lib
            times.append(f"{name} {chip_smoke.device_ms(lambda: pose_k.estimate_pose_kernel(*args)) * 1e3:.2f}")
        print(f"K2 {label}: A = {tree}, B = this tree; same outputs {same}, LM attempts {outs[0][3].tolist()}; "
              f"µs per launch (device) in turns: {', '.join(times)}", flush=True)
        if not same:
            raise SystemExit(f"pose_kernel_cycles: the two kernels differ at {label}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="TREE", help="time this tree's pose kernel against TREE's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pose_kernel_cycles: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="pose_cycles_")
    cycles(tmp, smi)
    if args.against:
        against(args.against, tmp)


if __name__ == "__main__":
    main()
