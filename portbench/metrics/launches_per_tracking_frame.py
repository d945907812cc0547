"""Device kernels launched in the traced slice's tracking frames, per
tracking frame (layer: driver)."""


def read(ctx):
    frames = ctx.tracking_frames()
    if not frames:
        return None
    n = sum(len(ctx.trace.kernels_in(f["span"].start, f["span"].end)) for f in frames)
    return n / len(frames)
