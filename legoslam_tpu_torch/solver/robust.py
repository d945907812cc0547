"""Robust cost kernels, vectorized over edge batches (twin of
legoslam_tpu/solver/robust.py; `lego::CostFunction` and the robust-edge
weighting of `BaseEdge`, base_edge.cpp:31-64)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from legoslam_tpu_torch.ops import rounding

TRIVIAL = "trivial"
HUBER = "huber"
CAUCHY = "cauchy"
TUKEY = "tukey"


def rho(kind: str, e2: torch.Tensor, delta: float):
    """(rho0, rho1, rho2) for chi2 batch `e2`; compared against delta^2.

    delta and delta^2 are the float32 values the reference computes with."""
    delta = float(np.float32(delta))
    d2 = float(np.float32(delta * delta))
    if kind == TRIVIAL:
        return e2, torch.ones_like(e2), torch.zeros_like(e2)
    if kind == HUBER:
        sqrte = rounding.sqrt(torch.clamp(e2, min=1e-20))
        inlier = e2 <= d2
        # a division, as the reference's (`delta / t` would multiply by t's reciprocal)
        d_over = torch.full_like(sqrte, delta) / sqrte
        rho0 = torch.where(inlier, e2, 2.0 * sqrte * delta - d2)
        rho1 = torch.where(inlier, torch.ones_like(e2), d_over)
        rho2 = torch.where(inlier, torch.zeros_like(e2), -0.5 * d_over / torch.clamp(e2, min=1e-20))
        return rho0, rho1, rho2
    if kind == CAUCHY:
        aux = e2 / d2 + 1.0
        rho1 = 1.0 / aux
        return d2 * torch.log(aux), rho1, -(rho1 * rho1) / d2
    if kind == TUKEY:
        e = rounding.sqrt(torch.clamp(e2, min=0.0))
        aux = e2 / d2
        inlier = e <= delta
        rho0 = torch.where(inlier, d2 * (1.0 - (1.0 - aux) ** 3) / 3.0, torch.full_like(e2, d2 / 3.0))
        rho1 = torch.where(inlier, (1.0 - aux) ** 2, torch.zeros_like(e2))
        rho2 = torch.where(inlier, -2.0 * (1.0 - aux) / d2, torch.zeros_like(e2))
        return rho0, rho1, rho2
    raise ValueError(f"unknown robust kernel: {kind}")


def chi2(residual: torch.Tensor, information: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain chi-square ``r^T Λ r`` over (..., D) residuals."""
    if information is None:
        return torch.sum(residual * residual, dim=-1)
    wr = (information * residual[..., None, :]).sum(-1)
    return torch.sum(residual * wr, dim=-1)


def robust_chi2(kind: str, residual: torch.Tensor, delta: float, information=None) -> torch.Tensor:
    """rho(chi2) per edge (base_edge.cpp:33-42)."""
    return rho(kind, chi2(residual, information), delta)[0]


def robust_information(kind: str, residual: torch.Tensor, delta: float, information=None):
    """(drho (...,), W (..., D, D)): ``W = rho' Λ + 2 rho'' (Λ r)(Λ r)^T``,
    the rank-1 term dropped unless ``rho' + 2 rho'' e2 > 1e-5 rho'`` (the
    reference's fp-robust form of base_edge.cpp:55's PSD guard)."""
    d = residual.shape[-1]
    if information is None:
        information = torch.eye(d, dtype=residual.dtype, device=residual.device).expand(residual.shape + (d,))
        wr = residual
    else:
        wr = (information * residual[..., None, :]).sum(-1)
    e2 = torch.sum(residual * wr, dim=-1)
    _, rho1, rho2 = rho(kind, e2, delta)
    rank1 = 2.0 * rho2[..., None, None] * wr[..., :, None] * wr[..., None, :]
    keep = (rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1)[..., None, None]
    W = rho1[..., None, None] * information + torch.where(keep, rank1, 0.0)
    return rho1, W
