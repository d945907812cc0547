"""The frame source handed to `VisualOdometry`: `init()`, `rig` and
`next_frame()`, as the port's `KittiDataset` has them.

The camera is a KITTI odometry sequence's (its P0 and P1 at full
resolution, from the configuration file), read at `image_scale` as the
port's KITTI reader reads it: intrinsics scaled, and the image decimated to
even rows and columns, which is what rendering at the scaled intrinsics
gives.  Frames are rendered on the device in set-up and kept on the host as
8-bit images; `next_frame` turns one pair into float32, as a decoded camera
frame would be.
"""

from __future__ import annotations

import numpy as np

from portbench.world import course, render


class DriveSource:
    """`n` frames at `speed` m/frame of the corridor drive described by `drive` (the traffic
    file's "drive" table) at the camera of `camera` (the configuration
    file's "camera" table), rendered from `seed` on `device`."""

    def __init__(self, camera: dict, drive: dict, speed: float, n: int, seed: int, device):
        from legoslam_tpu_torch.geometry.camera import StereoRig

        scale = float(camera["image_scale"])
        H, W = (int(s * scale) for s in camera["shape"])  # even rows and columns, as the KITTI reader keeps
        P0, P1 = (np.asarray(camera[k], np.float64).reshape(3, 4) for k in ("P0", "P1"))
        fx, fy, cx, cy = P0[0, 0] * scale, P0[1, 1] * scale, P0[0, 2] * scale, P0[1, 2] * scale
        baseline = float(np.linalg.norm(np.linalg.solve(P1[:, :3], P1[:, 3])))
        self.P0, self.P1, self.scale = P0, P1, scale
        self.shape = (H, W)
        self.rig = StereoRig.from_kitti_projections(P0, P1, scale=scale)
        self.ground_truth = course.poses(n, speed, drive["course"])
        world = {"half_width": float(drive["half_width_m"]), "ground_y": float(drive["ground_y_m"]),
                 "z_min": float(drive["z_min_m"]),
                 "length": float(self.ground_truth[-1, 2, 3]) + float(drive["far_wall_beyond_m"])}
        self.occluders = course.occluders(self.ground_truth, seed, float(drive["occluders_per_m"]),
                                          float(drive["occluder_clearance_m"]), world["half_width"],
                                          world["ground_y"])
        self.left, self.right = render.render(self.ground_truth, (fx, fy, cx, cy), baseline, (H, W), world,
                                              self.occluders, seed, float(drive["photometric_noise"]), device)
        self.index = 0

    def __len__(self) -> int:
        return self.left.shape[0]

    def init(self) -> bool:
        self.index = 0
        return True

    def next_frame(self):
        from legoslam_tpu_torch.pipeline.dataset import StereoFrame

        i = self.index
        if i >= len(self):
            return None
        self.index += 1
        return StereoFrame(i, self.left[i].astype(np.float32), self.right[i].astype(np.float32))
