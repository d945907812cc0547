"""Bilinear patch sampling, batched over keypoints (twin of
legoslam_tpu/ops/interp.py).

The reference samples with one-hot MXU matmuls, a TPU idiom; here each tap is
a direct gather.  Border behaviour is the reference's (`GetPixelValue`,
algorithm.h:42-45): per axis the sample position is clamped to
[0, size - 1], the first tap is its floor and the second tap
`min(i0 + 1, size - 1)`; rows are interpolated first, then columns.

Rounding is the reference's too.  XLA's CPU backend computes the row pass
(`Ry @ img`, two nonzero weights a row) as w0*a + w1*b with each product
rounded, except on images of the shapes in FUSED_ROW_SHAPES, where it
rounds it as one fused multiply-add, fma(w1, b, round(w0*a)); the column
pass has every product rounded.  Which shapes is XLA's choice, the same
under `--xla_cpu_max_isa` unset, AVX2 and SSE4_2 and for any lane count,
measured bit for bit on each pyramid level the repo's worlds build
(188x620, 160x240, 120x200 and their levels; 376x1240).  On KITTI at half
resolution that is level 1 (94x310), where the port's plain products moved
a tracked lane by up to 3.8e-3 px from every setting, which agree to 6.1e-5
px (ROADMAP C15).
"""

from __future__ import annotations

from typing import Tuple

import torch

from legoslam_tpu_torch.ops import rounding

# (H, W) of the images whose row pass the reference rounds as a fused
# multiply-add (the module docstring); every other measured level
# (188x620, 47x155, 23x77, 160x240, 20x30, 120x200, 60x100, 15x25,
# 376x1240) rounds each product.
FUSED_ROW_SHAPES = frozenset({(94, 310), (80, 120), (40, 60), (30, 50)})


def fused_rows(shape) -> bool:
    """Whether the row pass on an image of `shape` is rounded as an FMA."""
    return tuple(shape) in FUSED_ROW_SHAPES


def _lerp(w0: torch.Tensor, a: torch.Tensor, w1: torch.Tensor, b: torch.Tensor, fused: bool) -> torch.Tensor:
    """w0*a + w1*b in float32: each product rounded, or (`fused`) rounded as
    fma(w1, b, round(w0*a)) (`rounding.fma`)."""
    if not fused:
        return w0 * a + w1 * b
    return rounding.fma(w1, b, w0 * a)


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
    fused = fused_rows(img.shape)
    left = _lerp(1.0 - fy, r0, fy, r1, fused)
    right = _lerp(1.0 - fy, s0, fy, s1, fused)
    fx = fx[:, None, :]
    return (1.0 - fx) * left + fx * right


def sample_patches(img: torch.Tensor, centers: torch.Tensor, patch: int) -> torch.Tensor:
    """Bilinear-sample (patch x patch) windows centered at `centers` (N, 2)
    as (x, y); rows indexed by y, columns by x."""
    half = (patch - 1) / 2.0
    return sample_grid(img, centers[:, 1] - half, centers[:, 0] - half, patch, patch)
