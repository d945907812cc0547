"""Median over window BA's LM attempts of the program's `lm_attempt` span
less its `read` span: the host's time issuing an attempt's work
(layer: window BA)."""

from portbench import program, stats


def read(ctx):
    record = program.spans(ctx)
    kids = program.children(record)
    per_attempt = [a.t1_ns - a.t0_ns - sum(c.t1_ns - c.t0_ns for c in kids.get(a.id, []) if c.name == "read")
                   for a in program.under(record, "lm_attempt", "ba")]
    return 1e-6 * stats.percentile(per_attempt, 50) if per_attempt else None
