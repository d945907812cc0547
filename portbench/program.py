"""The program's own spans (`legoslam_tpu_torch.utils.timer`'s record), as
the per-layer readers take them: the spans inside the traced frames' host
window, their parents, and their place on the trace's clock.

A program without a record (before it kept one) gives no spans, and the
readers then find nothing to read."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def spans(ctx) -> List:
    """The program's spans that lie inside the traced frames' host window
    (the first frame's start to the last one's end), in the order they
    closed; empty where the program keeps no record."""
    from legoslam_tpu_torch.utils import timer

    records = getattr(timer, "records", None)
    if records is None or not ctx.frames:
        return []
    lo, hi = 1e9 * ctx.frames[0]["start"], 1e9 * ctx.frames[-1]["done"]
    return [s for s in records() if s.t0_ns >= lo and s.t1_ns <= hi]


def named(record: List, name: str, **attrs) -> List:
    return [s for s in record if s.name == name and all(s.attrs.get(k) == v for k, v in attrs.items())]


def children(record: List) -> Dict[int, List]:
    """Each span's id to the spans whose parent it is."""
    out: Dict[int, List] = {}
    for s in record:
        out.setdefault(s.parent, []).append(s)
    return out


def under(record: List, name: str, ancestor: str) -> List:
    """The spans named `name` with a span named `ancestor` above them."""
    by_id = {s.id: s for s in record}

    def inside(s) -> bool:
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == ancestor:
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in named(record, name) if inside(s)]


def on_trace(ctx, s) -> Optional[Tuple[float, float]]:
    """The span's (start, end) in microseconds on the trace's clock, placed
    by the anchor of the traced frame it lies in (that frame's benchmark
    span's start less its host start); None outside every frame."""
    starts = [f["start"] for f in ctx.frames]
    k = bisect.bisect_right(starts, 1e-9 * s.t0_ns) - 1
    if k < 0 or 1e-9 * s.t1_ns > ctx.frames[k]["done"]:
        return None
    f = ctx.frames[k]
    anchor = f["span"].start - 1e6 * f["start"]
    return 1e-3 * s.t0_ns + anchor, 1e-3 * s.t1_ns + anchor
