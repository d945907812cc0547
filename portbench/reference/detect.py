# Frozen copy of legoslam_tpu_torch/ops/detect.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Shi-Tomasi (GFTT) corner detection (twin of legoslam_tpu/ops/detect.py).

Sobel gradients -> 3x3 box-summed structure tensor -> min-eigenvalue
response -> quality threshold -> max-pool NMS -> top-k, with a fixed output
capacity and a validity mask.  Written with slices and cumulative sums (no
convolution), so no TF32 path can touch it on a GPU; the box sums' prefix
sums round as the reference's do (ops/prefix.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import prefix, rounding


class GFTTConfig(NamedTuple):
    max_corners: int = 150       # num_features (frontend_g2o.cpp:16)
    quality_level: float = 0.01
    min_distance: int = 20
    block_size: int = 3          # OpenCV GFTT default
    border: int = 4              # keep KLT halo patches inside the image


def _sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients with replicate padding, via separable passes."""
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sx = p[:, 2:] - p[:, :-2]
    ix = sx[:-2, :] + 2.0 * sx[1:-1, :] + sx[2:, :]
    sy = p[2:, :] - p[:-2, :]
    iy = sy[:, :-2] + 2.0 * sy[:, 1:-1] + sy[:, 2:]
    return ix, iy


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box sum with zero padding (same shape), from 2-D prefix sums."""
    r = k // 2
    c = prefix.cumsum(prefix.cumsum(F.pad(x, (r, r, r, r)), dim=0), dim=1)
    c = F.pad(c, (1, 0, 1, 0))
    H, W = x.shape
    return c[k : k + H, k : k + W] - c[0:H, k : k + W] - c[k : k + H, 0:W] + c[0:H, 0:W]


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max over a "SAME" window (-inf outside the image)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    p = F.pad(x[None, None], (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(p, k, stride=1)[0, 0]


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min eigenvalue of the structure tensor (cv::cornerMinEigenVal)."""
    ix, iy = _sobel(img)
    sxx = _box_sum(ix * ix, block_size)
    syy = _box_sum(iy * iy, block_size)
    sxy = _box_sum(ix * iy, block_size)
    tr = 0.5 * (sxx + syy)
    det_part = rounding.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy, min=0.0))
    return tr - det_part


def occupancy_mask(shape: Tuple[int, int], positions: torch.Tensor, valid: torch.Tensor, half: int) -> torch.Tensor:
    """(H, W) bool mask, True inside +-half boxes around valid positions
    (frontend_g2o.cpp:280-284).  Only valid lanes are written, so an invalid
    lane can never clear a valid lane's pixel (the reference's `.at[].max`)."""
    H, W = shape
    xi = torch.clamp(torch.round(positions[:, 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(positions[:, 1]).long(), 0, H - 1)
    ind = torch.zeros((H, W), dtype=torch.float32, device=positions.device)
    ind[yi[valid], xi[valid]] = 1.0
    return _maxpool(ind, 2 * half + 1) > 0.5


def detect(
    img: torch.Tensor, cfg: GFTTConfig = GFTTConfig(), exclude_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detect up to `cfg.max_corners` corners: (positions (K, 2) as (x, y), valid (K,))."""
    H, W = img.shape
    resp = min_eig_response(img, cfg.block_size)
    b = cfg.border
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    ok = (row >= b) & (row < H - b) & (col >= b) & (col < W - b)
    if exclude_mask is not None:
        ok = ok & ~exclude_mask
    resp = torch.where(ok, resp, float("-inf"))
    thr = cfg.quality_level * resp.max()
    # NMS over half the min-distance radius (see the reference for why).
    nms = resp >= _maxpool(resp, cfg.min_distance + 1)
    resp = torch.where(nms & (resp > thr) & torch.isfinite(resp), resp, float("-inf"))
    vals, idx = torch.topk(resp.reshape(-1), cfg.max_corners)
    ys = torch.div(idx, W, rounding_mode="floor").to(img.dtype)
    xs = (idx % W).to(img.dtype)
    return torch.stack([xs, ys], dim=-1), torch.isfinite(vals)
