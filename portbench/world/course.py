"""The drive: camera poses along the corridor, and occluders placed off it.

The course shapes are the port's soak courses (`soak_trajectory` in
chip_smoke.py, copied): forward at `speed` m/frame with a gentle yaw of
0.0018 rad a frame at most, period 320 frames.  "level" turns by 0.0018
cos(2 pi k / 320): its heading is +-0.092 rad about the corridor's axis with
mean 0, so it stays within ~3 m of the axis however long it runs.  "clear"
adds the phase 2.847, which kept the soak's six occluders 1.5 m away, but its
heading averages -0.027 rad and takes it out of a 12 m corridor after ~1,100
frames; "s_curve" leaves it after 460.

Occluders are the port's floating rectangles (`SyntheticPlanesDataset`):
a plane z = zc facing the camera, centre (xc, yc), size w x h, at the
soak's density (6 per 360 m of corridor), each redrawn until its near edge
lies `clearance` m or more to the side of the course where it crosses zc.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

COURSES = ("s_curve", "level", "clear")


def poses(n: int, speed: float, shape: str) -> np.ndarray:
    """(n, 4, 4) float64 world-from-camera poses (x right, y down, z ahead)."""
    if shape not in COURSES:
        raise ValueError(f"unknown course {shape!r} ({' | '.join(COURSES)})")
    k = np.arange(n)
    arg = 2 * np.pi * k / 320.0
    dyaw = 0.0018 * {"s_curve": np.sin(arg), "level": np.cos(arg), "clear": np.cos(arg + 2.847)}[shape]
    out, pos, yaw = [], np.zeros(3), 0.0
    for dy in dyaw:
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = pos
        out.append(T)
        pos = pos + T[:3, :3] @ np.array([0.0, 0.0, speed])
        yaw += dy
    return np.stack(out)


def lateral_at(T_wc: np.ndarray, z: float) -> float:
    """The course's x where it crosses the plane z (it runs along +z)."""
    zs, xs = T_wc[:, 2, 3], T_wc[:, 0, 3]
    return float(np.interp(z, zs, xs))


def occluders(T_wc: np.ndarray, seed: int, per_metre: float, clearance: float, half_width: float,
              ground_y: float) -> List[Tuple[float, float, float, float, float, int]]:
    """(xc, yc, zc, w, h, salt) of each occluder, drawn from `seed`, along
    the course's whole length and 20 m past its end."""
    z_end = float(T_wc[-1, 2, 3]) + 20.0
    count = int(round(per_metre * (z_end - 8.0)))
    rng = np.random.default_rng([seed, 7919])
    out = []
    for k in range(count):
        while True:
            zc = rng.uniform(8.0, z_end)
            xc = rng.uniform(-0.6 * half_width, 0.6 * half_width)
            yc = rng.uniform(-0.5, ground_y - 0.8)
            w = rng.uniform(0.8, 2.5)
            h = rng.uniform(0.8, 2.0)
            if abs(xc - lateral_at(T_wc, zc)) - w / 2 >= clearance:
                break
        out.append((xc, yc, zc, w, h, 71 + 13 * k))
    return out


def min_clearance(T_wc: np.ndarray, occ) -> float:
    """The least lateral distance from the course to an occluder's edge."""
    return min((abs(xc - lateral_at(T_wc, zc)) - w / 2 for xc, _, zc, w, _, _ in occ), default=float("inf"))
