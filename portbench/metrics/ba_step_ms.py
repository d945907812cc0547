"""Median span of `backend.ba_step` in the traced slice, ending in a
synchronize (layer: window BA)."""

from portbench.traced import median_ms


def read(ctx):
    return median_ms([e for e in ctx.trace.spans.get("ba", []) if ctx.start <= e.start <= ctx.end])
