# Frozen copy of legoslam_tpu_torch/ops/prefix.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Float32 prefix sums with the reference's rounding.

`jnp.cumsum` on XLA's CPU backend scans in chunks of 16: a sequential
float32 scan inside each chunk, the chunk totals scanned the same way
(recursively), and each chunk's exclusive carry added to its local scan.
`torch.cumsum` accumulates differently (in double on the CPU), and over a
whole image the two differ by ~1e-4 relative, which is enough to flip a
near-tie between adjacent corner responses.  Every add here is one float32
add, so the result is the reference's bit for bit on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CHUNK = 16


def _sequential(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _CHUNK:
        return _sequential(x)
    xp = F.pad(x, (0, (-n) % _CHUNK))
    lead = xp.shape[:-1]
    k = xp.shape[-1] // _CHUNK
    local = _sequential(xp.reshape(*lead, k, _CHUNK))
    carry = _scan_last(local[..., -1])
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], dim=-1)
    return (local + carry[..., None]).reshape(*lead, k * _CHUNK)[..., :n]


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum of `x` along `dim`."""
    return _scan_last(x.movedim(dim, -1)).movedim(-1, dim)
