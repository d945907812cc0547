# Frozen copy of legoslam_tpu_torch/ops/klt.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Pyramid KLT, batched over keypoints (twin of legoslam_tpu/ops/klt.py):
the anchored tracker and the frame-to-frame one.

Per keypoint: Gauss-Newton LK of a fixed template (a 7x7 patch with a 1-px
gradient ring, "halo") against the second image, at most 10 iterations,
central-difference gradients, a 2x2 normal-equation solve, stop on cost
increase, convergence at |update| < eps, and the inverse-compositional
variant that freezes J and H from the template.  Anchored tracking takes the
template from stored keyframe patches; frame mode (`klt_level`,
`klt_pyramid`, `track`) samples it from the first image at every level.

This module holds the plain PyTorch formulation.  `klt_pyramid_anchored` and
`klt_pyramid` dispatch on `KLTConfig.backend` and the tensors' device to the
CUDA kernels (csrc/klt_anchored.cu) or to their plain versions
(kernels/klt.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from portbench.reference import interp, pyramid, rounding
from portbench.reference.rounding import patch_mean, patch_sum


class KLTConfig(NamedTuple):
    half_patch: int = 3        # algorithm.cpp:40 (7x7 window)
    iterations: int = 10       # algorithm.cpp:42
    eps: float = 1e-2          # algorithm.cpp:113 convergence threshold
    levels: int = 4            # algorithm.cpp:135
    scale: float = 0.5         # algorithm.cpp:136
    inverse: bool = False      # forward mode default (frontend_g2o.cpp:473)
    # "auto": CUDA kernel for CUDA tensors, plain PyTorch for CPU tensors;
    # "kernel" / "eager" force one (kernels/klt.py).
    backend: str = "auto"


def _gn_loop(iterations: int, body, state, counter: Optional[torch.Tensor] = None):
    """Run the per-lane GN body until every lane is inactive or the cap.

    Inactive lanes are frozen by the body, so exiting when the last lane
    stops gives what a per-lane `break` gives.  `counter`, if given, gains
    the number of lane-iterations (lanes active at the start of each pass)."""
    i = 0
    while i < iterations and bool(state[3].any()):
        if counter is not None:
            counter += state[3].sum(dtype=counter.dtype)
        state = body(state)
        i += 1
    return state


def _grad_patches(big: torch.Tensor):
    """Split a (N, P+2, P+2) halo patch into value/grad-x/grad-y (N, P, P)."""
    val = big[:, 1:-1, 1:-1]
    gx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    gy = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    return val, gx, gy


def extract_anchors(pyr: Sequence[torch.Tensor], kp: torch.Tensor, cfg: KLTConfig = KLTConfig()) -> torch.Tensor:
    """Sample per-level halo patches around kp: (N, levels, P+2, P+2)."""
    halo = 2 * cfg.half_patch + 3
    out = [interp.sample_patches(pyr[level], kp * cfg.scale**level, halo) for level in range(cfg.levels)]
    return torch.stack(out, dim=1)


def klt_level_anchored(
    anchor: torch.Tensor,
    img2: torch.Tensor,
    kp1: torch.Tensor,
    kp2: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level GN flow against fixed template patches.

    `anchor` is (N, P+2, P+2) halo patches; `kp1` anchors the flow origin
    (kp2 = kp1 + d).  `gn_iterations`, if given, gains the GN iterations
    summed over lanes.  Returns (kp2_out (N, 2), success (N,))."""
    halo = 2 * cfg.half_patch + 3
    H, W = img2.shape
    eps2 = cfg.eps * cfg.eps
    p1, gx1, gy1 = _grad_patches(anchor)
    if cfg.inverse:
        Jx_fix, Jy_fix = -gx1, -gy1
        H00, H01, H11 = patch_sum(torch.stack([Jx_fix * Jx_fix, Jx_fix * Jy_fix, Jy_fix * Jy_fix]))

    def body(st):
        d, last_cost, succ, active = st
        p2, gx2, gy2 = _grad_patches(interp.sample_patches(img2, kp1 + d, halo))
        err = p1 - p2
        if cfg.inverse:
            Jx, Jy = Jx_fix, Jy_fix
            cost, bx, by = patch_sum(torch.stack([err * err, -err * Jx, -err * Jy]))
            h00, h01, h11 = H00, H01, H11
        else:
            Jx, Jy = -gx2, -gy2
            cost, h00, h01, h11, bx, by = patch_sum(torch.stack([err * err, Jx * Jx, Jx * Jy, Jy * Jy, -err * Jx,
                                                             -err * Jy]))
        det = h00 * h11 - h01 * h01
        inv_det = torch.where(det.abs() > 1e-12, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
        upd = torch.stack([(h11 * bx - h01 * by) * inv_det, (h00 * by - h01 * bx) * inv_det], dim=-1)
        bad = ~torch.all(torch.isfinite(upd), dim=-1) | (det.abs() <= 1e-12)
        diverged = last_cost < cost
        apply = active & ~bad & ~diverged
        d = torch.where(apply[:, None], d + upd, d)
        last_cost = torch.where(apply, cost, last_cost)
        succ = torch.where(active & bad, False, torch.where(apply, True, succ))
        converged = torch.sum(upd * upd, dim=-1) < eps2
        active = apply & ~converged
        return d, last_cost, succ, active

    inf = torch.full(kp1.shape[:1], float("inf"), dtype=kp1.dtype, device=kp1.device)
    d, _, succ, _ = _gn_loop(cfg.iterations, body, (kp2 - kp1, inf, valid, valid), gn_iterations)
    kp2_out = kp1 + d
    in_img = (kp2_out[:, 0] >= 0) & (kp2_out[:, 0] < W) & (kp2_out[:, 1] >= 0) & (kp2_out[:, 1] < H)
    return kp2_out, succ & in_img & valid


def klt_level(
    img1: torch.Tensor,
    img2: torch.Tensor,
    kp1: torch.Tensor,
    kp2: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level GN flow between two images (algorithm.cpp:37-125): the
    template is `img1`'s halo window at `kp1`, the GN loop that of
    `klt_level_anchored`.  Returns (kp2_out (N, 2), success (N,))."""
    anchor = interp.sample_patches(img1, kp1, 2 * cfg.half_patch + 3)
    return klt_level_anchored(anchor, img2, kp1, kp2, valid, cfg, gn_iterations)


def zncc_gate(core: torch.Tensor, img: torch.Tensor, kp: torch.Tensor, min_zncc: float) -> torch.Tensor:
    """ZNCC of template cores (N, P, P) against the patches at kp in img > min_zncc."""
    cur = interp.sample_patches(img, kp, core.shape[-1])
    c0 = core - patch_mean(core)[:, None, None]
    c1 = cur - patch_mean(cur)[:, None, None]
    num, q0, q1 = patch_sum(torch.stack([c0 * c1, c0 * c0, c1 * c1]))
    den = rounding.sqrt(q0 * q1 + 1e-6)
    return num / den > min_zncc


def klt_pyramid_anchored(
    anchors: torch.Tensor,
    anchor_uv: torch.Tensor,
    pyr2: Sequence[torch.Tensor],
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    min_zncc: float = 0.5,
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch anchored pyramid (ops/klt.py:325-380 of the reference).
    `gn_iterations`, if given, is filled with the GN iterations summed over
    lanes and levels."""
    levels = cfg.levels
    if gn_iterations is not None:
        gn_iterations.zero_()
    scale_top = cfg.scale ** (levels - 1)
    kp1 = anchor_uv * scale_top
    kp2 = kp2_init * scale_top
    guess = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        # Each level gets the original `valid`, not the previous success.
        kp2, success = klt_level_anchored(anchors[:, level], pyr2[level], kp1, kp2, valid, cfg,
                                                  gn_iterations)
        if level > 0:
            kp1 = kp1 / cfg.scale
            guess = guess / cfg.scale
            # Failed lanes restart from the initial guess at the next level.
            kp2 = torch.where(success[:, None], kp2 / cfg.scale, guess)
    if min_zncc > 0:
        success = success & zncc_gate(anchors[:, 0, 1:-1, 1:-1], pyr2[0], kp2, min_zncc)
    return kp2, success


def klt_pyramid(
    pyr1: Sequence[torch.Tensor],
    pyr2: Sequence[torch.Tensor],
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch frame-mode pyramid (ops/klt.py:179-226 of the
    reference).  `gn_iterations`, if given, is filled with the GN iterations
    summed over lanes and levels."""
    levels = cfg.levels
    if gn_iterations is not None:
        gn_iterations.zero_()
    scale_top = cfg.scale ** (levels - 1)
    kp1_pyr = kp1 * scale_top
    kp2_pyr = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        kp2_pyr, success = klt_level(pyr1[level], pyr2[level], kp1_pyr, kp2_pyr, valid, cfg,
                                             gn_iterations)
        if level > 0:
            # Upscale; failed lanes restart from kp1 at the next level.
            kp1_pyr = kp1_pyr / cfg.scale
            kp2_pyr = torch.where(success[:, None], kp2_pyr / cfg.scale, kp1_pyr)
    return kp2_pyr, success


def track(
    img1: torch.Tensor,
    img2: torch.Tensor,
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience: build both pyramids and track (LKOpticalFlow4Layer)."""
    pyr1 = tuple(pyramid.build_pyramid(img1, cfg.levels))
    pyr2 = tuple(pyramid.build_pyramid(img2, cfg.levels))
    return klt_pyramid(pyr1, pyr2, kp1, kp2_init, valid, cfg)
