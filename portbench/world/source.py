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


def world_of(drive: dict, T_wc: np.ndarray) -> dict:
    """The world of the traffic file's drive table around the course
    `T_wc`: for the lap, a box whose four walls stand `wall_margin_m`
    beyond the course's extent in x and z; for a forward course, the
    corridor, whose end wall stands `far_wall_beyond_m` past the last
    pose."""
    gy = float(drive["ground_y_m"])
    if (drive["course"] == "lap") != ("wall_margin_m" in drive):
        raise ValueError("`wall_margin_m` sizes the lap's box, and only the lap's")
    if drive["course"] == "lap":
        m = float(drive["wall_margin_m"])
        xs, zs = T_wc[:, 0, 3], T_wc[:, 2, 3]
        return {"ground_y": gy, "x_min": float(xs.min()) - m, "x_max": float(xs.max()) + m,
                "z_min": float(zs.min()) - m, "z_max": float(zs.max()) + m}
    return {"half_width": float(drive["half_width_m"]), "ground_y": gy, "z_min": float(drive["z_min_m"]),
            "length": float(T_wc[-1, 2, 3]) + float(drive["far_wall_beyond_m"])}


def occluders_of(drive: dict, T_wc: np.ndarray, world: dict, seed: int) -> list:
    """The occluders of the drive table's world: over a box's floor clear
    of the course as a path (`occluders_per_m2`), or along the corridor
    clear of the course's side (`occluders_per_m`)."""
    clearance = float(drive["occluder_clearance_m"])
    if "x_min" in world:
        return course.box_occluders(T_wc, seed, float(drive["occluders_per_m2"]), clearance, world)
    return course.occluders(T_wc, seed, float(drive["occluders_per_m"]), clearance, world["half_width"],
                            world["ground_y"])


class DriveSource:
    """`n` frames at `speed` m/frame of the drive described by `drive` (the traffic
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
        self.ground_truth = course.poses(n, speed, drive)
        self.world = world_of(drive, self.ground_truth)
        self.occluders = occluders_of(drive, self.ground_truth, self.world, seed)
        self.left, self.right = render.render(self.ground_truth, (fx, fy, cx, cy), baseline, (H, W), self.world,
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
