# Frozen copy of legoslam_tpu_torch/geometry/se3.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Batched SE(3) / SO(3) operations in PyTorch (twin of
legoslam_tpu/geometry/se3.py).

A pose is a plain ``(..., 4, 4)`` tensor (row-major homogeneous transform,
camera-from-world ``T_cw`` throughout the pipeline) and the tangent is
``(..., 6)`` ordered ``[rho, phi]`` (translation first, Sophus' convention).
All functions broadcast over leading batch dimensions and keep the input
dtype; small-angle branches are masked `where`s, as in the reference, so
both versions evaluate the same formulas.  Products and sums of three or
four terms are sequential and unfused, and divisions by constants are
reciprocal multiplies (ops/rounding.py): the same bits on a CPU and on a
card, where `@` and `.sum` would take cuBLAS's and CUDA's reductions.
"""

from __future__ import annotations

import torch

from portbench.reference import rounding
from portbench.reference.rounding import div_const, row_sum, small_matmul, small_matvec

# Below this rotation angle (radians) the Taylor expansions are used instead
# of the trig forms (sized for float32, see the reference module).
_SMALL_ANGLE = 0.05


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape[:-1] + (3, 3))


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``(..., 3)`` vectors -> ``(..., 3, 3)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _rot_coeffs(theta_sq: torch.Tensor):
    """Rodrigues coefficients A = sin t / t, B = (1 - cos t)/t^2,
    C = (t - sin t)/t^3, float32-stable (half-angle B, 4th-order Taylor
    below `_SMALL_ANGLE`)."""
    theta = rounding.sqrt(theta_sq)
    small = theta_sq < _SMALL_ANGLE**2
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * safe
    sinc = torch.sin(safe) / safe
    sinc_half = torch.sin(half) / half
    t2, t4 = theta_sq, theta_sq * theta_sq
    a = torch.where(small, 1.0 - div_const(t2, 6.0) + div_const(t4, 120.0), sinc)
    b = torch.where(small, 0.5 - div_const(t2, 24.0) + div_const(t4, 720.0), 0.5 * sinc_half * sinc_half)
    c = torch.where(small, div_const(1.0, 6.0) - div_const(t2, 120.0) + div_const(t4, 5040.0),
                    (1.0 - sinc) / (safe * safe))
    return a, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) for ``(..., 3)`` -> ``(..., 3, 3)``."""
    theta_sq = row_sum(phi * phi)
    a, b, _ = _rot_coeffs(theta_sq)
    K = hat(phi)
    KK = small_matmul(K, K)
    return _eye3(phi) + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3) for ``(..., 3, 3)`` -> ``(..., 3)``, accurate on
    [0, pi) with the symmetric-part formula near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    sin_t = torch.sin(safe)
    scale = torch.where(small, 1.0 + div_const(theta * theta, 6.0), safe / sin_t)
    phi = scale[..., None] * w
    near_pi = cos_t < -1.0 + 1e-6
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), min=0.0)
    axis = rounding.sqrt(axis_sq) * torch.where(w >= 0, 1.0, -1.0)
    phi_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3): ``(..., 6)`` [rho, phi] -> ``(..., 4, 4)``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = row_sum(phi * phi)
    a, b, c = _rot_coeffs(theta_sq)
    K = hat(phi)
    KK = small_matmul(K, K)
    eye = _eye3(phi)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return _rt_to_mat(R, small_matvec(V, rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3): ``(..., 4, 4)`` -> ``(..., 6)`` [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta_sq = row_sum(phi * phi)
    K = hat(phi)
    KK = small_matmul(K, K)
    theta = rounding.sqrt(theta_sq)
    small = theta_sq < _SMALL_ANGLE**2
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * safe
    half_cot = half * torch.cos(half) / torch.sin(half)
    coeff = torch.where(small, div_const(1.0, 12.0) + div_const(theta_sq, 720.0), (1.0 - half_cot) / (safe * safe))
    V_inv = _eye3(phi) - 0.5 * K + coeff[..., None, None] * KK
    return torch.cat([small_matvec(V_inv, t), phi], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of ``(..., 4, 4)`` rigid transforms without a general solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(Rt, -small_matvec(Rt, T[..., :3, 3]))


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble ``(..., 4, 4)`` from rotation ``(..., 3, 3)`` and translation."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 4, 4)`` transforms to ``(..., 3)`` points."""
    return small_matvec(T[..., :3, :3], p) + T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` of ``(..., 4, 4)`` transforms, rounded as the reference's
    4x4 product (`small_matmul` fused)."""
    return small_matmul(A, B, fused=True)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def so3_project(R: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """Project ``(..., 3, 3)`` near-rotations onto SO(3) by the Newton polar
    iteration ``R <- R (3I - R^T R) / 2``.

    Load-bearing, not cosmetic: float32 pose products shed ~1e-7 of
    orthonormality per frame and the rel/T_cur feedback of the frame step
    amplifies it ~2.4x per frame, so without this projection tracking
    collapses after ~15 frames (the reference's round-1 drift)."""
    eye = _eye3(R[..., 0])
    for _ in range(iterations):
        R = small_matmul(R, 1.5 * eye - 0.5 * small_matmul(R.transpose(-1, -2), R))
    return R


def se3_orthonormalize(T: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """Re-project the rotation block of ``(..., 4, 4)`` transforms onto SO(3)."""
    return _rt_to_mat(so3_project(T[..., :3, :3], iterations), T[..., :3, 3])


def retract(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative manifold update ``Exp(delta) @ T`` with the
    reference's NaN/Inf guard (a non-finite update leaves the pose
    unchanged), re-projected onto SE(3)."""
    finite = torch.all(torch.isfinite(delta), dim=-1)
    delta = torch.where(finite[..., None], delta, torch.zeros_like(delta))
    return se3_orthonormalize(compose(se3_exp(delta), T))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``(..., 4, 4)`` transforms for [rho, phi] tangents:
    Ad(T) = [[R, hat(t) R], [0, R]] (..., 6, 6)."""
    R = T[..., :3, :3]
    top = torch.cat([R, small_matmul(hat(T[..., :3, 3]), R)], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` -> unit quaternions ``(..., 4)`` (x, y, z, w).

    Shepperd-style selection of the numerically largest component, used for
    TUM-format trajectory export."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    qw = rounding.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    w0, x1, y2, z3 = qw.unbind(-1)
    cand = torch.stack([
        torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0), w0], dim=-1),
        torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1), (m21 - m12) / (4 * x1)], dim=-1),
        torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2), (m02 - m20) / (4 * y2)], dim=-1),
        torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3, (m10 - m01) / (4 * z3)], dim=-1),
    ], dim=-2)
    pivot = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cand, pivot[..., None, None].expand(*pivot.shape, 1, 4), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
