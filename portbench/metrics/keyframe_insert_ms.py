"""Median span of `frontend.insert_keyframe` in the traced slice, ending
in a synchronize (layer: keyframe branch)."""

from portbench.traced import median_ms


def read(ctx):
    return median_ms([e for e in ctx.trace.spans.get("insert", []) if ctx.start <= e.start <= ctx.end])
