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

from legoslam_tpu_torch.ops import interp, pyramid


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


def _psum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(1, 2))


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
        H00 = _psum(Jx_fix * Jx_fix)
        H01 = _psum(Jx_fix * Jy_fix)
        H11 = _psum(Jy_fix * Jy_fix)

    def body(st):
        d, last_cost, succ, active = st
        p2, gx2, gy2 = _grad_patches(interp.sample_patches(img2, kp1 + d, halo))
        err = p1 - p2
        cost = _psum(err * err)
        if cfg.inverse:
            Jx, Jy = Jx_fix, Jy_fix
            h00, h01, h11 = H00, H01, H11
        else:
            Jx, Jy = -gx2, -gy2
            h00 = _psum(Jx * Jx)
            h01 = _psum(Jx * Jy)
            h11 = _psum(Jy * Jy)
        bx = _psum(-err * Jx)
        by = _psum(-err * Jy)
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
    c0 = core - core.mean(dim=(1, 2), keepdim=True)
    c1 = cur - cur.mean(dim=(1, 2), keepdim=True)
    num = _psum(c0 * c1)
    den = torch.sqrt(_psum(c0 * c0) * _psum(c1 * c1) + 1e-6)
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
    """Coarse-to-fine tracking of anchored templates, then the ZNCC gate.

    Args:
      anchors: (N, >= levels, P+2, P+2) from `extract_anchors` (finest first).
      anchor_uv: (N, 2) template positions in the anchor image (flow origin).
      pyr2: current-image pyramid (finest first, >= cfg.levels levels).
      kp2_init: (N, 2) initial guesses in the current image.
      valid: (N,) lanes to track.
      min_zncc: final appearance gate (0 disables).
      gn_iterations: optional (1,) int32 tensor on the device, filled with
        the GN iterations summed over lanes and levels (the work count).

    Dispatches per `cfg.backend` and the device (kernels/klt.py)."""
    from legoslam_tpu_torch.kernels import klt as klt_kernels

    return klt_kernels.klt_pyramid_anchored(anchors, anchor_uv, pyr2, kp2_init, valid, cfg, min_zncc,
                                            gn_iterations)


def klt_pyramid(
    pyr1: Sequence[torch.Tensor],
    pyr2: Sequence[torch.Tensor],
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine frame-to-frame tracking (algorithm.cpp:128-206).

    Args:
      pyr1, pyr2: image pyramids (finest first, >= cfg.levels levels).
      kp1: (N, 2) keypoints in pyr1 level 0.
      kp2_init: (N, 2) initial guesses in pyr2 level 0.
      valid: (N,) lanes to track.
      gn_iterations: optional (1,) int32 work count, as in
        `klt_pyramid_anchored`.

    Every level gets `valid`; a lane that fails a level restarts the next
    one from kp1; there is no appearance gate.  Dispatches per `cfg.backend`
    and the device (kernels/klt.py).  Returns (kp2 (N, 2), success (N,))."""
    from legoslam_tpu_torch.kernels import klt as klt_kernels

    return klt_kernels.klt_pyramid(pyr1, pyr2, kp1, kp2_init, valid, cfg, gn_iterations)


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
