"""What the per-layer readers (metrics/<name>.py) are handed: the traced
slice's trace, its frames, and the K1 and K2 calls it made."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench import stats, tracefile

KERNEL_NAMES = {"k1_anchored": "klt_pyramid_anchored_kernel", "k1_frame": "klt_pyramid_frame_kernel",
                "k2": "estimate_pose_kernel"}


class Context:
    def __init__(self, path, rows: List[dict], kernel_log: List[tuple]):
        self.trace = tracefile.load(str(path))
        spans = self.trace.spans.get("frame", [])
        # Each traced frame with its span on the trace's clock.
        self.frames = [dict(r, span=s) for r, s in zip(rows, spans)]
        self.kernel_log = kernel_log
        if self.frames:
            self.start, self.end = self.frames[0]["span"].start, self.frames[-1]["span"].end
        else:
            self.start = self.end = 0.0
        self.window_s = 1e-6 * (self.end - self.start)
        self.busy_s = 1e-6 * stats.union_length(self.trace.device_intervals(self.start, self.end))

    def tracking_frames(self) -> List[dict]:
        return [f for f in self.frames if not f["kf"]]

    def spans_in(self, tag: str, frame: dict) -> List[tracefile.Event]:
        s = frame["span"]
        return [e for e in self.trace.spans.get(tag, []) if e.start >= s.start and e.end <= s.end]

    def launches(self, tag: str) -> List[Tuple[tuple, tracefile.Event]]:
        """The slice's calls of `tag` ("k1_anchored", "k1_frame", "k2"),
        each with its kernel's event, paired in order; empty where the
        counts differ."""
        calls = [c for c in self.kernel_log if c[0] == tag]
        events = [k for k in self.trace.kernels_in(self.start, self.end) if KERNEL_NAMES[tag] in k.name]
        if len(calls) != len(events):
            return []
        return list(zip(calls, events))

    def _innermost(self):
        """The slice cut at every span's ends: each piece's start and the
        innermost benchmark span over it ("between frames" where none)."""
        spans = [(e.start, e.end, tag) for tag, lst in self.trace.spans.items() for e in lst
                 if e.end > self.start and e.start < self.end]
        cuts = sorted({self.start, *[max(s, self.start) for s, _, _ in spans], *[min(e, self.end) for _, e, _ in spans]})
        owner = []
        for a, b in zip(cuts, cuts[1:] + [self.end]):
            mid = 0.5 * (a + b)
            inside = [(e - s, tag) for s, e, tag in spans if s <= mid <= e]
            owner.append(min(inside)[1] if inside else "between frames")
        return cuts, owner

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps by
        the innermost benchmark span the host was in."""
        by_op: Dict[str, float] = {}
        for e in self.trace.device:
            if e.end > self.start and e.start < self.end:
                by_op[e.name] = by_op.get(e.name, 0.0) + 1e-6 * (min(e.end, self.end) - max(e.start, self.start))
        by_gap: Dict[str, float] = {}
        cuts, owner = self._innermost()
        for g0, g1 in stats.gaps(self.trace.device_intervals(self.start, self.end), self.start, self.end):
            k = max(bisect.bisect_right(cuts, g0) - 1, 0)
            t = g0
            while t < g1:
                nxt = min(cuts[k + 1] if k + 1 < len(cuts) else g1, g1)
                by_gap[owner[k]] = by_gap.get(owner[k], 0.0) + 1e-6 * (nxt - t)
                t, k = nxt, k + 1
        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(by_op), "idle_gaps": first(by_gap)}


def median_ms(events) -> Optional[float]:
    if not events:
        return None
    return 1e-3 * stats.percentile([e.end - e.start for e in events], 50)
