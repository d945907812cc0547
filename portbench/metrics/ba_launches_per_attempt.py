"""Device kernels inside the traced `backend.ba_step` spans over the LM
attempts those solves made (`BAStats.attempts`) (layer: window BA)."""


def read(ctx):
    launches = attempts = 0
    for f in ctx.frames:
        spans = ctx.spans_in("ba", f)
        if spans:
            launches += sum(len(ctx.trace.kernels_in(e.start, e.end)) for e in spans)
            attempts += f["attempts"]
    return launches / attempts if attempts else None
