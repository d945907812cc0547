"""Median of the program's `loop_verify` spans in the traced slice: one
candidate's geometric verification, KLT there and back and the pose's
verification rounds, both ways where the first has the inliers
(layer: loop closer)."""

from portbench import program, stats


def read(ctx):
    spans = program.named(program.spans(ctx), "loop_verify")
    return 1e-6 * stats.percentile([s.t1_ns - s.t0_ns for s in spans], 50) if spans else None
