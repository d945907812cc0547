# Frozen copy of legoslam_tpu_torch/solver/reprojection.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Closed-form reprojection residuals and analytic Jacobians, batched per edge
(twin of legoslam_tpu/solver/reprojection.py; `EdgeProjectionPoseOnly`,
lego_types.h:117-185, and `EdgeProjection`, lego_types.h:188-261).

Conventions: residual = measurement - projection; the pose tangent is
[rho, phi] with the left-multiplicative update Exp(d) T."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import se3

_EPS = 1e-18  # the reference's divide guard (lego_types.h:143, 167)


class Intrinsics(NamedTuple):
    """Shared pinhole intrinsics as Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float


def project(intr: Intrinsics, p_cam: torch.Tensor) -> torch.Tensor:
    z = p_cam[..., 2] + _EPS
    return torch.stack(
        [intr.fx * p_cam[..., 0] / z + intr.cx, intr.fy * p_cam[..., 1] / z + intr.cy], dim=-1
    )


def _pose_jacobian(intr: Intrinsics, p_cam: torch.Tensor) -> torch.Tensor:
    """2x6 Jacobian of the residual wrt the pose tangent (lego_types.h:147-178)."""
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zinv = 1.0 / (Z + _EPS)
    zinv2 = zinv * zinv
    fx, fy = intr.fx, intr.fy
    zero = torch.zeros_like(X)
    row_u = torch.stack(
        [-fx * zinv, zero, fx * X * zinv2, fx * X * Y * zinv2, -fx - fx * X * X * zinv2, fx * Y * zinv], dim=-1
    )
    row_v = torch.stack(
        [zero, -fy * zinv, fy * Y * zinv2, fy + fy * Y * Y * zinv2, -fy * X * Y * zinv2, -fy * X * zinv], dim=-1
    )
    return torch.stack([row_u, row_v], dim=-2)


def pose_only_edge(intr: Intrinsics, T_cw: torch.Tensor, p_world: torch.Tensor, uv: torch.Tensor):
    """Batched `EdgeProjectionPoseOnly`: (residual (..., 2), J_pose (..., 2, 6))."""
    p_cam = se3.transform(T_cw, p_world)
    return uv - project(intr, p_cam), _pose_jacobian(intr, p_cam)


def projection_edge(intr: Intrinsics, T_cw: torch.Tensor, ext: torch.Tensor, p_world: torch.Tensor,
                    uv: torch.Tensor):
    """Batched `EdgeProjection` (pose + point, with the per-edge camera
    extrinsic `ext`, camera-from-rig): (residual (..., 2), J_pose (..., 2, 6),
    J_point (..., 2, 3)).  The pose Jacobian is taken at the post-extrinsic
    point, as the reference does (lego_types.h:232-248)."""
    p_cam = se3.transform(ext, se3.transform(T_cw, p_world))
    J_pose = _pose_jacobian(intr, p_cam)
    # J_point = J_pose[:, :3] @ R_ext @ R_T  (lego_types.h:251-253)
    R = ext[..., :3, :3] @ T_cw[..., :3, :3]
    return uv - project(intr, p_cam), J_pose, J_pose[..., :, :3] @ R
