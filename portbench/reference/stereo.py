# Frozen copy of legoslam_tpu_torch/ops/stereo.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Scanline stereo matching for a rectified rig (twin of
legoslam_tpu/ops/stereo.py, `match`).

Per keypoint: sample a (P x S) strip of the right image whose rows align
with the keypoint's row and whose columns span the disparity range; ZNCC
over all integer-disparity windows from prefix sums; a uniqueness gate;
parabolic subpixel; then Gauss-Newton on the continuous disparity inside
the strip.  The reference reads the strip and the GN windows with one-hot
matmuls (a TPU workaround); here both are direct gathers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from portbench.reference import interp, prefix, rounding
from portbench.reference.rounding import div_const, patch_mean, patch_sum, rows_sum


class ScanlineConfig(NamedTuple):
    half_patch: int = 3
    refine_iterations: int = 6
    uniqueness: float = 0.85     # best/second-best (1-ZNCC) ratio gate (< passes)
    min_zncc: float = 0.75       # final acceptance score at the refined match


def _zncc(pl: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Zero-mean normalized cross-correlation over the last two axes."""
    pl0 = pl - patch_mean(pl)[..., None, None]
    pr0 = pr - patch_mean(pr)[..., None, None]
    num, ql, qr = patch_sum(torch.stack([pl0 * pr0, pl0 * pl0, pr0 * pr0]))
    den = rounding.sqrt(ql * qr + 1e-6)
    return num / den


def match(
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    kp: torch.Tensor,
    valid: torch.Tensor,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scanline match of left keypoints kp (N, 2) in the right image.

    d_min, d_max: static disparity range (from the rig's depth gates).
    Returns (uv_right (N, 2), ok (N,))."""
    img_l, img_r = pyr_l[0], pyr_r[0]
    P = 2 * cfg.half_patch + 1
    half = cfg.half_patch
    d_lo = int(math.floor(d_min)) - 1
    d_hi = int(math.ceil(d_max)) + 1
    D = d_hi - d_lo + 1              # integer disparity candidates
    S = D + P - 1 + 2                # strip width (+1 halo col each side)
    n = kp.shape[0]

    patch_l = interp.sample_patches(img_l, kp, P)          # (N, P, P)
    # Strip column j holds x = kp_x + x0 + j; the window whose left column
    # sits at strip col 1 + j has integer disparity d = d_hi - j.
    x0 = -(d_hi + half + 1)
    strip = interp.sample_grid(img_r, kp[:, 1] - (P - 1) / 2.0, kp[:, 0] + float(x0), P, S)

    pl0 = patch_l - patch_mean(patch_l)[..., None, None]
    norm_l = rounding.sqrt(patch_sum(pl0 * pl0))
    # Every sum over a patch's rows runs in one fixed order (`rows_sum`: a
    # CPU's torch.sum order, as elementwise ops), so a card and a CPU give
    # the same bits.
    cross = 0
    for k in range(P):
        cross = cross + rows_sum(pl0[:, :, k : k + 1] * strip[:, :, 1 + k : 1 + k + D])
    zero = torch.zeros((n, 1), dtype=strip.dtype, device=strip.device)
    cum = torch.cat([zero, prefix.cumsum(rows_sum(strip), dim=1)], dim=1)
    cumq = torch.cat([zero, prefix.cumsum(rows_sum(strip * strip), dim=1)], dim=1)
    win_sum = cum[:, 1 + P : 1 + P + D] - cum[:, 1 : 1 + D]
    win_sq = cumq[:, 1 + P : 1 + P + D] - cumq[:, 1 : 1 + D]
    var_r = torch.clamp(win_sq - div_const(win_sum * win_sum, P * P), min=0.0)
    den = norm_l[:, None] * rounding.sqrt(var_r) + 1e-6
    cost = 1.0 - cross / den                                # (N, D)

    c_best, best_j = torch.min(cost, dim=1)
    # Uniqueness: second-best outside +-2 px of the winner.
    jj = torch.arange(D, device=kp.device)[None, :]
    near = (jj - best_j[:, None]).abs() <= 2
    c_second = torch.where(near, float("inf"), cost).min(dim=1).values
    ambiguous = c_best > cfg.uniqueness * c_second

    # Parabolic subpixel seed.
    cp = torch.gather(cost, 1, torch.clamp(best_j - 1, 0, D - 1)[:, None])[:, 0]
    cn = torch.gather(cost, 1, torch.clamp(best_j + 1, 0, D - 1)[:, None])[:, 0]
    denom = cp - 2.0 * c_best + cn
    off = torch.where(denom.abs() > 1e-9, 0.5 * (cp - cn) / torch.where(denom != 0, denom, 1.0), 0.0)
    off = torch.clamp(off, -1.0, 1.0)
    u0 = 1.0 + best_j.to(kp.dtype) + off

    # Gauss-Newton on u inside the strip (x-only GN, algorithm.cpp:58-115).
    col2 = torch.arange(P + 2, dtype=kp.dtype, device=kp.device)[None, :]

    def sample_halo(u):
        pos = torch.clamp(u[:, None] + col2 - 1.0, 0.0, S - 2.0)   # (N, P+2)
        i0 = torch.floor(pos)
        f = (pos - i0)[:, None, :]
        i0 = i0.long()[:, None, :].expand(n, P, P + 2)
        v0 = torch.gather(strip, 2, i0)
        v1 = torch.gather(strip, 2, i0 + 1)
        return (1.0 - f) * v0 + f * v1                              # (N, P, P+2)

    u = u0
    last_cost = torch.full((n,), float("inf"), dtype=kp.dtype, device=kp.device)
    active = valid & ~ambiguous
    ok0 = active
    i = 0
    while i < cfg.refine_iterations and bool(active.any()):
        halo = sample_halo(u)
        win = halo[:, :, 1:-1]
        gx = 0.5 * (halo[:, :, 2:] - halo[:, :, :-2])
        err = patch_l - win
        c, h, b = patch_sum(torch.stack([err * err, gx * gx, err * gx]))
        upd = torch.where(h > 1e-9, b / torch.where(h > 0, h, 1.0), 0.0)
        apply = active & ~(last_cost < c) & torch.isfinite(upd)
        u = torch.where(apply, u + upd, u)
        last_cost = torch.where(apply, c, last_cost)
        active = apply & (upd.abs() >= 1e-2)
        i += 1

    d = (1.0 + d_hi) - u
    score = 1.0 - _zncc(patch_l, sample_halo(u)[:, :, 1:-1])
    x_r = kp[:, 0] - d
    W = img_r.shape[1]
    in_range = (d > d_min * 0.5) & (d < d_max * 1.5) & (x_r >= 0) & (x_r < W)
    ok = ok0 & (score < 1.0 - cfg.min_zncc) & in_range
    return torch.stack([x_r, kp[:, 1]], dim=-1), ok
