"""The traced slice's Chrome trace (torch.profiler's `export_chrome_trace`),
reduced to what the per-layer readers take: the device's operations and
the benchmark's spans, in microseconds on the trace's one clock."""

from __future__ import annotations

import gzip
import json
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    start: float  # us
    end: float    # us


class Trace(NamedTuple):
    device: List[Event]               # every kernel, copy and fill on the device, by start
    kernels: List[Event]              # kernels alone
    spans: Dict[str, List[Event]]     # "portbench.<tag>" spans by tag, by start

    def kernels_in(self, start: float, end: float) -> List[Event]:
        return [k for k in self.kernels if k.start >= start and k.end <= end]

    def device_intervals(self, start: float, end: float) -> List[Tuple[float, float]]:
        return [(max(e.start, start), min(e.end, end)) for e in self.device if e.end > start and e.start < end]


def load(path: str) -> Trace:
    """A trace as `export_chrome_trace` writes it, gzipped where the name
    ends in .gz."""
    with (gzip.open(path, "rt") if str(path).endswith(".gz") else open(path)) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return parse(events)


def parse(events) -> Trace:
    device, kernels, spans = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ev = Event(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(ev)
            if cat == "kernel":
                kernels.append(ev)
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            spans.setdefault(e["name"][len("portbench."):], []).append(ev)
    for lst in (device, kernels, *spans.values()):
        lst.sort(key=lambda x: x.start)
    return Trace(device, kernels, spans)
