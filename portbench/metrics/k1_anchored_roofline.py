"""K1's anchored entry (`klt_pyramid_anchored_kernel<h>`): the least time
for the work of the traced slice's launches over their device time, in %
(layer: kernels).  The work is counted from each launch's inputs: the GN
lane-iterations, which the main path does not count, from the reference's
plain KLT on the same inputs (the kernel gives its bits), and the bytes
its windows touch (portbench/roofline.py)."""

import numpy as np
import torch

from portbench import roofline
from portbench.reference import klt

MAX_LAUNCHES = 12


def read(ctx):
    pairs = ctx.launches("k1_anchored")[:MAX_LAUNCHES]
    if not pairs:
        return None
    least = spent = 0.0
    for (_, args, kw, out), ev in pairs:
        anchors, anchor_uv, pyr2, guess, valid, cfg = args[:6]
        min_zncc = kw.get("min_zncc", args[6] if len(args) > 6 else 0.5)
        kcfg = klt.KLTConfig(**cfg._asdict())
        gn = torch.zeros((1,), dtype=torch.int32)
        klt.klt_pyramid_anchored(torch.as_tensor(anchors), torch.as_tensor(anchor_uv),
                                 tuple(torch.as_tensor(p) for p in pyr2), torch.as_tensor(guess),
                                 torch.as_tensor(valid), kcfg, min_zncc, gn)
        kp, ok = out
        flop, nbytes = roofline.k1_anchored_work(valid.shape[0], valid, int(gn), [p.shape for p in pyr2], kcfg.scale,
                                                 kcfg.levels, anchors.shape[-1], guess, kp, ok, kcfg.half_patch)
        least += roofline.bound(flop, nbytes)[0]
        spent += 1e-6 * (ev.end - ev.start)
    return 100.0 * least / spent
