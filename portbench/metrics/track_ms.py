"""Median over the traced tracking frames of the spans around
`frontend.track_last_frame` and `frontend.estimate_current_pose` (each
ending in a synchronize), summed per frame (layer: tracking)."""

from portbench import stats


def read(ctx):
    per_frame = []
    for f in ctx.tracking_frames():
        spans = ctx.spans_in("track", f) + ctx.spans_in("pose", f)
        if spans:
            per_frame.append(sum(e.end - e.start for e in spans))
    return 1e-3 * stats.percentile(per_frame, 50) if per_frame else None
