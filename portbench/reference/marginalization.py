# Frozen copy of legoslam_tpu_torch/solver/marginalization.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Marginalization / prior factors (twin of
legoslam_tpu/solver/marginalization.py).

`lego::Problem::marginalize` (problem.cpp:617-781) and the prior bookkeeping
it feeds (`H_prior_` / `b_prior_`, applied at problem.cpp:338-355 and
first-order-updated at :447-454) as pure functions: Schur elimination of the
marginalized block, an eigenvalue-thresholded pseudo-inverse (:746-749), and
the square-root re-linearization form J = S^1/2 V^T with err = -J^-T b
(:760-772).  The eigendecompositions are `torch.linalg.eigh`, as the
reference's are `jnp.linalg.eigh` outside any kernel; eigenvector signs and
the basis inside a repeated eigenvalue are not unique, so `sqrt_J` and `err`
agree between implementations only through J^T J and J^T err.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class PriorFactor(NamedTuple):
    """Linearized prior on the kept variables.

    H = J^T J and b are applied to the kept block of the next problem
    (problem.cpp:353-354); `sqrt_J` and `err` support the first-order prior
    update after state changes (:447-453)."""

    H: torch.Tensor        # (n, n)
    b: torch.Tensor        # (n,)
    sqrt_J: torch.Tensor   # (n, n) J with H = J^T J
    err: torch.Tensor      # (n,) linearized residual


def _thresholded_inverse(w: torch.Tensor, eps: float) -> torch.Tensor:
    keep = w > eps
    return torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)


def _psd_pinv(A: torch.Tensor, eps: float) -> torch.Tensor:
    """Eigenvalue-thresholded pseudo-inverse of a symmetric matrix
    (problem.cpp:746-749)."""
    w, V = torch.linalg.eigh(0.5 * (A + A.T))
    return (V * _thresholded_inverse(w, eps)[None, :]) @ V.T


def marginalize(H: torch.Tensor, b: torch.Tensor, marg_mask: torch.Tensor, m: int,
                eps: float = 1e-8) -> PriorFactor:
    """Marginalize `m` coordinates (marked by `marg_mask`) out of (H, b).

    Args:
      H: (n, n) information matrix of the current linearization.
      b: (n,) information vector.
      marg_mask: (n,) bool, True for the coordinates to marginalize; exactly
        `m` True entries (m is a Python int, e.g. 6 for one keyframe pose).

    Returns a PriorFactor over all n coordinates, with zero rows and columns
    at the marginalized ones: the caller masks it onto the next problem's
    ordering."""
    n = H.shape[0]
    k = n - m
    # Stable permutation: kept coordinates first, marginalized last.
    perm = torch.sort(marg_mask.to(torch.int32), stable=True).indices
    Hp = H[perm][:, perm]
    bp = b[perm]
    Arr, Arm, Amm = Hp[:k, :k], Hp[:k, k:], Hp[k:, k:]

    tempB = Arm @ _psd_pinv(Amm, eps)
    H_keep = Arr - tempB @ Arm.T
    b_keep = bp[:k] - tempB @ bp[k:]

    # Square-root form (problem.cpp:760-772).
    w, V = torch.linalg.eigh(0.5 * (H_keep + H_keep.T))
    S = torch.where(w > eps, w, 0.0)
    sqrt_J = torch.sqrt(S)[:, None] * V.T
    Jt_inv = torch.sqrt(_thresholded_inverse(w, eps))[:, None] * V.T
    err = -(Jt_inv @ b_keep)
    H_clean = sqrt_J.T @ sqrt_J
    H_clean = torch.where(H_clean.abs() > 1e-9, H_clean, 0.0)  # problem.cpp:771

    # Back to the original coordinate order, zero at the marginalized ones.
    inv_perm = torch.argsort(perm)

    def unpermute(M):
        M = torch.nn.functional.pad(M, (0, m) * M.dim())
        return M[inv_perm][:, inv_perm] if M.dim() == 2 else M[inv_perm]

    return PriorFactor(H=unpermute(H_clean), b=unpermute(b_keep), sqrt_J=unpermute(sqrt_J), err=unpermute(err))


def apply_prior(H: torch.Tensor, b: torch.Tensor, prior: PriorFactor,
                fixed_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add a prior factor to a new problem's (H, b) (problem.cpp:338-355),
    zeroing the prior's rows and columns of fixed coordinates."""
    Hp, bp = prior.H, prior.b
    if fixed_mask is not None:
        keep = (~fixed_mask).to(H.dtype)
        Hp = Hp * keep[:, None] * keep[None, :]
        bp = bp * keep
    return H + Hp, b + bp


def update_prior_b(prior: PriorFactor, dx: torch.Tensor) -> PriorFactor:
    """First-order prior update after a state change of dx
    (problem.cpp:447-453): b <- b - H dx."""
    return prior._replace(b=prior.b - prior.H @ dx)
