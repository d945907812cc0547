"""Median over the traced tracking frames of the host time outside K1's and
K2's calls and the reads: the program's `pyramid`, `prior` and `motion`
spans and the `frame` span's own time outside its children
(layer: tracking)."""

from portbench import program, stats

GLUE = ("pyramid", "prior", "motion")


def read(ctx):
    record = program.spans(ctx)
    kids = program.children(record)
    per_frame = []
    for f in program.named(record, "frame", branch="track"):
        sub = kids.get(f.id, [])
        own = f.t1_ns - f.t0_ns - sum(c.t1_ns - c.t0_ns for c in sub)
        per_frame.append(own + sum(c.t1_ns - c.t0_ns for c in sub if c.name in GLUE))
    return 1e-6 * stats.percentile(per_frame, 50) if per_frame else None
