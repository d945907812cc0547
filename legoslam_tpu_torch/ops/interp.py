"""Bilinear patch sampling, batched over keypoints (twin of
legoslam_tpu/ops/interp.py).

The reference samples with one-hot MXU matmuls, a TPU idiom; here each tap is
a direct gather.  Border behaviour is the reference's (`GetPixelValue`,
algorithm.h:42-45): per axis the sample position is clamped to
[0, size - 1], the first tap is its floor and the second tap
`min(i0 + 1, size - 1)`; rows are interpolated first, then columns.
"""

from __future__ import annotations

from typing import Tuple

import torch


def axis_taps(start: torch.Tensor, size: int, count: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Taps along one axis for `count` unit-spaced samples from `start`.

    Args:
      start: (N,) first sample coordinate (can be fractional / out of range).

    Returns (i0, i1 (N, count) int64, frac (N, count)).
    """
    offs = torch.arange(count, dtype=start.dtype, device=start.device)
    pos = torch.clamp(start[:, None] + offs[None, :], 0.0, size - 1.0)
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=size - 1), frac


def sample_grid(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(N, rows, cols) bilinear samples of `img` (H, W) on the unit grid whose
    first sample sits at (x0, y0) per lane."""
    H, W = img.shape
    yi0, yi1, fy = axis_taps(y0, H, rows)
    xi0, xi1, fx = axis_taps(x0, W, cols)
    fy = fy[:, :, None]
    r0 = img[yi0[:, :, None], xi0[:, None, :]]
    r1 = img[yi1[:, :, None], xi0[:, None, :]]
    s0 = img[yi0[:, :, None], xi1[:, None, :]]
    s1 = img[yi1[:, :, None], xi1[:, None, :]]
    left = (1.0 - fy) * r0 + fy * r1
    right = (1.0 - fy) * s0 + fy * s1
    fx = fx[:, None, :]
    return (1.0 - fx) * left + fx * right


def sample_patches(img: torch.Tensor, centers: torch.Tensor, patch: int) -> torch.Tensor:
    """Bilinear-sample (patch x patch) windows centered at `centers` (N, 2)
    as (x, y); rows indexed by y, columns by x."""
    half = (patch - 1) / 2.0
    return sample_grid(img, centers[:, 1] - half, centers[:, 0] - half, patch, patch)
