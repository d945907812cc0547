"""Scanline stereo: the CUDA kernel (csrc/stereo.cu) and its plain PyTorch
version.

`match_kernel` launches the kernel (CUDA tensors only); `match_eager` is the
same function written with the ported ops (any device: the CPU's bits on
both, since every sum is a chain of one-element adds); `match` picks one by
the device alone: the kernel for CUDA tensors, the plain version for CPU
tensors, with no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from legoslam_tpu_torch.kernels import _build
from legoslam_tpu_torch.ops import interp, prefix, rounding
from legoslam_tpu_torch.ops.rounding import div_const, patch_mean, patch_sum, rows_sum
from legoslam_tpu_torch.ops.stereo import ScanlineConfig
from legoslam_tpu_torch.utils import timer

# csrc/stereo.cu takes half-patches 0..MAX_HALF_PATCH (as K1) and strips up
# to MAX_STRIP columns (S = D + 2 h + 2: at half-patch 3 a disparity range of
# 2,038 px).
MAX_HALF_PATCH = 9
MAX_STRIP = 2048


def disparities(d_min: float, d_max: float) -> Tuple[int, int]:
    """(d_hi, D): the largest integer disparity a window is scored at and
    the number of them, from the static range [d_min, d_max] with one
    candidate of margin on each side."""
    d_lo = int(math.floor(d_min)) - 1
    d_hi = int(math.ceil(d_max)) + 1
    return d_hi, d_hi - d_lo + 1


def _zncc(pl: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Zero-mean normalized cross-correlation over the last two axes."""
    pl0 = pl - patch_mean(pl)[..., None, None]
    pr0 = pr - patch_mean(pr)[..., None, None]
    num, ql, qr = patch_sum(torch.stack([pl0 * pr0, pl0 * pl0, pr0 * pr0]))
    den = rounding.sqrt(ql * qr + 1e-6)
    return num / den


def _sample_halo(strip: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The (N, P, P+2) window of the (N, P, S) strip whose column c sits at
    u + c - 1, linearly interpolated inside the strip."""
    n, P, S = strip.shape
    col2 = torch.arange(P + 2, dtype=u.dtype, device=u.device)[None, :]
    pos = torch.clamp(u[:, None] + col2 - 1.0, 0.0, S - 2.0)   # (N, P+2)
    i0 = torch.floor(pos)
    f = (pos - i0)[:, None, :]
    i0 = i0.long()[:, None, :].expand(n, P, P + 2)
    v0 = torch.gather(strip, 2, i0)
    v1 = torch.gather(strip, 2, i0 + 1)
    return (1.0 - f) * v0 + f * v1                              # (N, P, P+2)


def _refine(strip: torch.Tensor, patch_l: torch.Tensor, u: torch.Tensor, active: torch.Tensor,
            iterations: int) -> torch.Tensor:
    """Gauss-Newton on u inside the strip (x-only GN, algorithm.cpp:58-115),
    every lane at once until none is active or `iterations` have run; a
    stopped lane's u never changes."""
    last_cost = torch.full(u.shape, float("inf"), dtype=u.dtype, device=u.device)
    i = 0
    while i < iterations and timer.read(active.any(), "stereo_refine"):
        halo = _sample_halo(strip, u)
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
    return u


def match_eager(
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    kp: torch.Tensor,
    valid: torch.Tensor,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scanline match (twin of legoslam_tpu/ops/stereo.py
    `match`, whose strip and GN windows are one-hot matmuls, a TPU
    workaround; here both are direct gathers).  Same contract as
    `ops.stereo.match`."""
    img_l, img_r = pyr_l[0], pyr_r[0]
    P = 2 * cfg.half_patch + 1
    half = cfg.half_patch
    d_hi, D = disparities(d_min, d_max)   # D integer disparity candidates
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

    ok0 = valid & ~ambiguous
    u = _refine(strip, patch_l, u0, ok0, cfg.refine_iterations)

    d = (1.0 + d_hi) - u
    score = 1.0 - _zncc(patch_l, _sample_halo(strip, u)[:, :, 1:-1])
    x_r = kp[:, 0] - d
    W = img_r.shape[1]
    in_range = (d > d_min * 0.5) & (d < d_max * 1.5) & (x_r >= 0) & (x_r < W)
    ok = ok0 & (score < 1.0 - cfg.min_zncc) & in_range
    return torch.stack([x_r, kp[:, 1]], dim=-1), ok


def _lib():
    lib = _build.load("stereo")
    fn = lib.legoslam_stereo_match
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i, i, i, p, i, i, i, p, p, i, i, i, i, i, f, f, f, f, p, p, p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stereo kernel: {msg}")


def f32(x: float) -> float:
    """A Python float rounded to float32, as a float32 tensor compares with it."""
    return float(np.float32(x))


def match_kernel(
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    kp: torch.Tensor,
    valid: torch.Tensor,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/stereo.cu for every lane: the plain version's bits
    and no host read.  Same contract as `match_eager`; CUDA tensors only,
    the images (the pyramids' level 0) contiguous 2-D float32."""
    dev = kp.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    n = kp.shape[0]
    img_l, img_r = pyr_l[0], pyr_r[0]
    for name, img in (("left", img_l), ("right", img_r)):
        _require(img.dim() == 2 and img.dtype == torch.float32 and img.device == dev and img.is_contiguous()
                 and img.shape[0] > 0 and img.shape[1] > 0,
                 f"the {name} image must be a non-empty contiguous 2-D float32 tensor on {dev}")
    _require(kp.shape == (n, 2) and kp.dtype == torch.float32, "kp must be (N, 2) float32")
    _require(valid.shape == (n,) and valid.dtype == torch.bool and valid.device == dev, "valid must be (N,) bool")
    _require(0 <= cfg.half_patch <= MAX_HALF_PATCH,
             f"half_patch {cfg.half_patch}: the kernel takes 0..{MAX_HALF_PATCH}")
    d_hi, D = disparities(d_min, d_max)
    S = D + 2 * cfg.half_patch + 2
    _require(S <= MAX_STRIP, f"a strip of {S} columns (disparities {d_min:g}..{d_max:g} px at half-patch "
                             f"{cfg.half_patch}); the kernel takes {MAX_STRIP}")
    _require(cfg.refine_iterations >= 0, "refine_iterations must be >= 0")
    kp, valid = kp.contiguous(), valid.contiguous()
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.legoslam_stereo_match(
        img_l.data_ptr(), img_l.shape[0], img_l.shape[1], int(interp.fused_rows(img_l.shape)),
        img_r.data_ptr(), img_r.shape[0], img_r.shape[1], int(interp.fused_rows(img_r.shape)),
        kp.data_ptr(), valid.data_ptr(), n, cfg.half_patch, d_hi, D, cfg.refine_iterations,
        f32(cfg.uniqueness), f32(1.0 - cfg.min_zncc), f32(d_min * 0.5), f32(d_max * 1.5),
        uv.data_ptr(), ok.data_ptr(), stream,
    )
    _build.check(lib, rc, "match_kernel")
    match_kernel.launches += 1
    return uv, ok


match_kernel.launches = 0


def match(
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    kp: torch.Tensor,
    valid: torch.Tensor,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kind = kp.device.type
    if kind == "cuda":
        return match_kernel(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    if kind == "cpu":
        return match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    raise RuntimeError(f"scanline stereo has no path for {kind} tensors")
