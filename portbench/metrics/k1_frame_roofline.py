"""K1's frame entry (`klt_pyramid_frame_kernel<h>`): the least time for
the work of the traced slice's launches over their device time, in %
(layer: kernels); the GN lane-iterations from the reference's plain KLT on
the same inputs, the bytes from the windows (portbench/roofline.py)."""

import torch

from portbench import roofline
from portbench.reference import klt

MAX_LAUNCHES = 12


def read(ctx):
    pairs = ctx.launches("k1_frame")[:MAX_LAUNCHES]
    if not pairs:
        return None
    least = spent = 0.0
    for (_, args, kw, out), ev in pairs:
        pyr1, pyr2, kp1, guess, valid, cfg = args[:6]
        kcfg = klt.KLTConfig(**cfg._asdict())
        gn = torch.zeros((1,), dtype=torch.int32)
        klt.klt_pyramid(tuple(torch.as_tensor(p) for p in pyr1), tuple(torch.as_tensor(p) for p in pyr2),
                        torch.as_tensor(kp1), torch.as_tensor(guess), torch.as_tensor(valid), kcfg, gn)
        kp, ok = out
        flop, nbytes = roofline.k1_frame_work(valid.shape[0], valid, int(gn), [p.shape for p in pyr2], kcfg.scale,
                                              kcfg.levels, kp1, guess, kp, ok, kcfg.half_patch)
        least += roofline.bound(flop, nbytes)[0]
        spent += 1e-6 * (ev.end - ev.start)
    return 100.0 * least / spent
