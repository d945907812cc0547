"""Float32 rounding the port takes over from the reference's compiled code.

The JAX reference runs as XLA programs; on a CPU, XLA fixes some
associations and rewrites that PyTorch does otherwise, the same under every
`--xla_cpu_max_isa` setting (unset, AVX2, SSE4_2), so the reference's own
spread across settings is smaller than what they move the port by.  On the
KITTI soak these moved tracked lanes by up to 3.8e-3 px and triangulated
points by up to 7e-4 m from every setting (ROADMAP C15).  Measured bit for
bit against the reference's jitted functions, and used by the KLT, the
ZNCC gates, scanline stereo and `Camera.pixel2camera`:

- a reduction of (..., P, P) over its last two axes adds the elements one
  at a time in row-major order (`patch_sum`);
- a division by a compile-time constant (a rig intrinsic closed over by the
  jitted step, a patch's element count, `jnp.mean`'s count) is a multiply
  by the constant's float32 reciprocal (`div_const`); a division by a
  traced value stays a division.

`ops/prefix.py` (the 16-wide cumsum) and `ops/interp.py` (the fused row
pass of its one-hot matmul on some image shapes) hold the others.
"""

from __future__ import annotations

import numpy as np
import torch


def patch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes, one element at a time in row-major order.
    Stack several sums on leading axes: the loop is one add per element."""
    flat = x.reshape(*x.shape[:-2], -1)
    acc = flat[..., 0]
    for k in range(1, flat.shape[-1]):
        acc = acc + flat[..., k]
    return acc


def patch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes: `patch_sum` times the reciprocal of the
    count, as `jnp.mean` compiles."""
    return div_const(patch_sum(x), x.shape[-1] * x.shape[-2])


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c, as x times the float32 reciprocal of c."""
    return x * float(np.float32(1.0) / np.float32(c))
