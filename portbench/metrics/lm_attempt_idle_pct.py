"""The share of window BA's LM attempts (the program's `lm_attempt` spans,
placed on the trace's clock by their frame's anchor) in which nothing ran
on the device (layer: window BA)."""

from portbench import program, stats


def read(ctx):
    length = busy = 0.0
    for a in program.under(program.spans(ctx), "lm_attempt", "ba"):
        iv = program.on_trace(ctx, a)
        if iv is not None:
            length += iv[1] - iv[0]
            busy += stats.union_length(ctx.trace.device_intervals(*iv))
    return 100.0 * (1.0 - busy / length) if length > 0 else None
