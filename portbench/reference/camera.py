# Frozen copy of legoslam_tpu_torch/geometry/camera.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Pinhole stereo camera model (twin of legoslam_tpu/geometry/camera.py).

The intrinsics are kept twice: as Python floats, which host code needs (the
static disparity range of scanline stereo, the CUDA pose kernel's runtime
arguments), and as the tensors `K()` / `pose` on the rig's device.  Each
float is rounded to float32 first, so it equals the reference's float32
scalar exactly and both packages compute with the same constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import se3
from portbench.reference.rounding import div_const


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class Camera:
    """One pinhole camera of the rig.

    fx, fy, cx, cy, baseline: float32-rounded Python floats.
    pose: (4, 4) extrinsic camera-from-rig; pose_inv: rig-from-camera.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    pose: torch.Tensor
    pose_inv: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, baseline=0.0, pose=None, dtype=torch.float32, device="cpu") -> "Camera":
        if pose is None:
            pose = np.eye(4)
        pose = torch.as_tensor(np.asarray(pose), dtype=dtype, device=device)
        return Camera(
            fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy), baseline=_f32(baseline),
            pose=pose, pose_inv=se3.se3_inv(pose),
        )

    def to(self, device) -> "Camera":
        return Camera(self.fx, self.fy, self.cx, self.cy, self.baseline,
                      self.pose.to(device), self.pose_inv.to(device))

    def K(self) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=self.pose.dtype, device=self.pose.device,
        )

    # --- coordinate transforms (camera.cpp:8-34) -------------------------
    def world2camera(self, p_w: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
        return se3.transform(self.pose, se3.transform(T_cw, p_w))

    def camera2world(self, p_c: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
        return se3.transform(se3.se3_inv(T_cw), se3.transform(self.pose_inv, p_c))

    def camera2pixel(self, p_c: torch.Tensor) -> torch.Tensor:
        z = p_c[..., 2]
        return torch.stack(
            [self.fx * p_c[..., 0] / z + self.cx, self.fy * p_c[..., 1] / z + self.cy], dim=-1
        )

    def pixel2camera(self, p_p: torch.Tensor, depth=1.0) -> torch.Tensor:
        depth = torch.as_tensor(depth, dtype=p_p.dtype, device=p_p.device)
        return torch.stack(
            [
                div_const(p_p[..., 0] - self.cx, self.fx) * depth,
                div_const(p_p[..., 1] - self.cy, self.fy) * depth,
                torch.broadcast_to(depth, p_p[..., 0].shape),
            ],
            dim=-1,
        )

    def pixel2world(self, p_p: torch.Tensor, T_cw: torch.Tensor, depth=1.0) -> torch.Tensor:
        return self.camera2world(self.pixel2camera(p_p, depth), T_cw)

    def world2pixel(self, p_w: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
        return self.camera2pixel(self.world2camera(p_w, T_cw))


@dataclass(frozen=True)
class StereoRig:
    """Left + right camera pair (left camera frame == rig frame)."""

    left: Camera
    right: Camera

    def to(self, device) -> "StereoRig":
        return StereoRig(self.left.to(device), self.right.to(device))

    @staticmethod
    def from_kitti_projections(P0, P1, scale=1.0, dtype=torch.float32, device="cpu") -> "StereoRig":
        """A rig from two KITTI 3x4 projection matrices, as Dataset::Init
        (dataset.cpp:13-51) builds it: t = K^-1 P[:, 3], intrinsics scaled by
        `scale`, baseline = ||t||, extrinsic the pure translation t."""
        cams = []
        for P in (np.asarray(P0, np.float64), np.asarray(P1, np.float64)):
            K = P[:, :3]
            t = np.linalg.solve(K, P[:, 3])
            Ks = K * scale
            pose = np.eye(4)
            pose[:3, 3] = t
            cams.append(Camera.create(Ks[0, 0], Ks[1, 1], Ks[0, 2], Ks[1, 2], baseline=float(np.linalg.norm(t)),
                                      pose=pose, dtype=dtype, device=device))
        return StereoRig(left=cams[0], right=cams[1])
