"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Drives `legoslam_tpu_torch`'s `VisualOdometry.step()` over a corridor drive
rendered on the card from the seed, after a warm-up that fills the keyframe
window, for `--seconds` of closed-loop or open-loop frames; then compares
sampled frames' stages with the plain reference (portbench/reference) and
prints one JSON line.  With `--trace 1` a slice of the window runs under
torch.profiler and the line carries the cell's per-layer metrics instead of
its end-to-end ones.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = _args(argv)
    # Build and kernel caches at fixed places inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "portbench_cache" / sub)
    from portbench import harness

    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"portbench: the cell needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                           out_dir=ROOT / "portbench_out", log=_log)
    if res["forbidden"]:
        _log(f"portbench: JAX or the JAX package was loaded: {', '.join(res['forbidden'])}")
        return 3
    if args.trace:
        metrics = {m["name"]: {"value": res["per_layer"][m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in res["per_layer"]}
    else:
        metrics = {m["name"]: {"value": res["values"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak"], **res["device_extra"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if args.trace and res["breakdown"] is not None:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in res["checks"]}
    for r in res["checks"]:
        _log(f"check {r['name']}: {r['value']!r} (limit {r['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
