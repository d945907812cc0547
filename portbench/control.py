"""The control and the program's readings behind each limit of `correct`.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, one run of the cell at its own size and load (a window of
`--seconds`), then per number compared: the program's reading (the port
against the reference, as a benchmark run compares) and the control's (the
reference computed in TF32 in the port's place, `reference/lowp.py`), on
the same samples.  One JSON line per seed on standard output; the limits
in the configuration files are set from these readings (PERF.md).  Needs a
CUDA card.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench import check, harness

    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                               log=lambda m: print(m, file=sys.stderr, flush=True), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "program": check.worst(res["per_sample"]), "control": res["control"],
                          "samples": len(res["per_sample"]), "values": res["values"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
