"""Median of the program's `pose_graph` spans in the traced slice: the
float64 keyframe pose graph over every record, solved on the host at each
verified closure (layer: loop closer)."""

from portbench import program, stats


def read(ctx):
    spans = program.named(program.spans(ctx), "pose_graph")
    return 1e-6 * stats.percentile([s.t1_ns - s.t0_ns for s in spans], 50) if spans else None
