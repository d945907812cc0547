"""K2 (`estimate_pose_kernel`): the least time for the work of the traced
slice's launches over their device time, in % (layer: kernels).  The
main path passes K2 no `attempts` tensor, so each launch's LM passes come
from the reference's plain pose on the same inputs (the kernel gives its
bits and its attempts); the work is POSE_FLOP_PER_EDGE per valid edge and
pass (portbench/roofline.py)."""

import torch

from portbench import roofline
from portbench.reference import lm, reprojection

MAX_LAUNCHES = 12


def read(ctx):
    pairs = ctx.launches("k2")[:MAX_LAUNCHES]
    if not pairs:
        return None
    least = spent = 0.0
    for (_, args, kw, out), ev in pairs:
        intr, T_init, p_world, uv, valid = args[:5]
        outer = int(kw.get("outer_iterations", 4))
        at = torch.zeros((outer,), dtype=torch.int32)
        lm.estimate_pose(reprojection.Intrinsics(*intr), torch.as_tensor(T_init), torch.as_tensor(p_world),
                         torch.as_tensor(uv), torch.as_tensor(valid), chi2_th=kw.get("chi2_th", 5.991),
                         outer_iterations=outer, exclude_outliers=kw.get("exclude_outliers", True),
                         cfg=lm.LMConfig(**kw["cfg"]._asdict()), attempts=at)
        flop, nbytes = roofline.k2_work(valid.shape[0], int(valid.sum()), int(at.sum()) + outer)
        least += roofline.bound(flop, nbytes)[0]
        spent += 1e-6 * (ev.end - ev.start)
    return 100.0 * least / spent
