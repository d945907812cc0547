"""Variants of the pose kernel, timed against it in one process on one GPU.

    python3 scripts/pose_variants.py

Each variant is csrc/pose.cu with a few lines replaced (VARIANTS below): a
schedule the kernel tried and dropped, a sizing it could take, or, for
the critical path, a fixed delay in one place (`delay`: ~2,000 cycles of
dependent multiply-adds whose result guards a shared store that never
happens, so the compiler keeps them and no output changes; `sleep`: a
__nanosleep, which takes no issue slot from the warps beside it).
Builds every variant, checks that each gives its plain version's pose on
chip_smoke's 512 edges, and prints each one's device time per launch
(`chip_smoke.device_ms`) in two turns, the second in reverse order.  A
variant whose lines are no longer in the source is reported and skipped.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from legoslam_tpu_torch.kernels import _build  # noqa: E402
from legoslam_tpu_torch.kernels import pose as pose_k  # noqa: E402

_spec = importlib.util.spec_from_file_location("pose_kernel_cycles", os.path.join(REPO, "scripts",
                                                                                    "pose_kernel_cycles.py"))
cycles = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cycles)


def delay(seed: str, n: int = 250) -> str:
    """~2,000 cycles (n dependent FMUL, FADD pairs) seeded by `seed`, a value
    of this pass, kept by a shared store that never happens."""
    return ("{ float dz = __int_as_float(__float_as_int(" + seed + ") & 1); for (int dq = 0; dq < " + str(n) +
            "; ++dq) dz = dz * 0.999f + 1e-3f; if (dz == 3.0f) *reinterpret_cast<volatile float*>(&s.chi) = dz; }\n")


def sleep(ns: int = 1000) -> str:
    """A delay that issues nothing while it lasts (~1 µs, ~2,000 cycles),
    so the warps beside it keep their issue slots."""
    return "__nanosleep(" + str(ns) + ");\n"


CHI = "        const float acc = seq_chain_pass<8, 1, 5, false>(ring, kSlotChi, lane == 0, s, full, u, nu, pass);\n"
STEP = "          lu_solve(A, piv, b, dx);\n          retract(Tc, dx, cand);\n"
SPEC = "        retract(Tc, dx_spec, spec);\n"
CHI_TERMS = "        __syncwarp();\n        if (lane == 0) mbar_arrive(&s.chi_full[unit_slot(u)]);\n"
REST = "        produce_rest(ep, k, robust, prm.chi2_th, slot, lane);\n"
SLOT_WAIT = ("        CYCLES_START(t_empty);\n        mbar_spin(&s.empty[unit_slot(u)], unit_parity(u) ^ 1);\n"
             "        if (lane == 0) CYCLES_ADD(1, t_empty);\n")

VARIANTS = {
    "the kernel": [],
    "units of 2 chunks": [("constexpr int kUnit = 4;", "constexpr int kUnit = 2;")],
    "units of 8 chunks": [("constexpr int kUnit = 4;", "constexpr int kUnit = 8;")],
    "chi in groups of 16 adds": [(CHI, CHI.replace("<8, 1, 5, false>", "<4, 2, 5, false>"))],
    "chi reads the skip flag": [(CHI, CHI.replace("5, false>", "5, true>"))],
    "H loaded 3 groups ahead": [("constexpr int kHDepth = 2;", "constexpr int kHDepth = 4;")],
    "producers 6, 7 beside warp 0 take chunks 6, 7": [
        ("  const int p = warp - kFirstProducer;", "  const int p = 2 * ((warp + 3) % 4) + (warp >= 8 ? 1 : 0);")],
    "delay: producer's chi terms +2k cycles": [(CHI_TERMS, delay("ep.e2") + CHI_TERMS)],
    "delay: producer's rest +2k cycles": [(REST, REST + delay("ep.e2"))],
    "delay: chi's chain +2k cycles": [(CHI, CHI + delay("acc"))],
    "delay: warp 0's rejection candidate +2k cycles": [(SPEC, SPEC + delay("spec[0]"))],
    "delay: warp 0's accepted step +2k cycles": [(STEP, STEP + delay("cand[0]"))],
    "delay: producer's slot wait +2k cycles": [(SLOT_WAIT, SLOT_WAIT + delay("T[0]"))],
    "sleep: producer's chi terms +~1 µs": [(CHI_TERMS, sleep() + CHI_TERMS)],
    "sleep: chi's chain +~1 µs": [(CHI, CHI + sleep())],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pose_variants: no CUDA device")
    base = (_build.CSRC / "pose.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="pose_variants_")
    dev = torch.device("cuda:0")
    args = chip_smoke.pose_inputs(dev)[:5]
    T_plain = pose_k.estimate_pose_eager(*args)[0]
    libs = {}
    for name, reps in VARIANTS.items():
        src = base
        missing = [a for a, _ in reps if a not in src]
        if missing:
            print(f"{name}: does not apply to this pose.cu (missing {missing[0][:60]!r})", flush=True)
            continue
        for a, b in reps:
            src = src.replace(a, b)
        libs[name] = cycles.build(src, tmp, "v" + str(len(libs)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            _build._loaded["pose"] = libs[name]
            att = torch.zeros(4, dtype=torch.int32, device=dev)
            T = pose_k.estimate_pose_kernel(*args, attempts=att)[0]
            if not torch.equal(T, T_plain):
                raise SystemExit(f"pose_variants: {name} disagrees with the plain version")
            times[name].append(chip_smoke.device_ms(lambda: pose_k.estimate_pose_kernel(*args)) * 1e3)
    print(f"pose kernel variants on chip_smoke's 512 edges (LM attempts {att.tolist()}), µs per launch (device), "
          f"two turns, on {smi}:", flush=True)
    for name, ts in times.items():
        print(f"  {name:52s} {ts[0]:8.2f} {ts[1]:8.2f}", flush=True)


if __name__ == "__main__":
    main()
