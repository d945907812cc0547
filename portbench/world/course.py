"""The drive: camera poses along a course, and occluders placed off it.

The forward courses are the port's soak courses (`soak_trajectory` in
chip_smoke.py, copied): forward at `speed` m/frame with a gentle yaw of
0.0018 rad a frame at most, period 320 frames.  "level" turns by 0.0018
cos(2 pi k / 320): its heading is +-0.092 rad about the corridor's axis with
mean 0, so it stays within ~3 m of the axis however long it runs.  "clear"
adds the phase 2.847, which kept the soak's six occluders 1.5 m away, but its
heading averages -0.027 rad and takes it out of a 12 m corridor after ~1,100
frames; "s_curve" leaves it after 460.

"lap" comes back: a rounded rectangle of right turns (+z, then +x, -z,
-x), two straight lengths (`lap_straights_m`, each driven twice, on
opposite sides) joined by four quarter turns of `lap_turn_m` of arc, whose
yaw rate is a raised cosine (chip_smoke.py's `loop_trajectory`, copied), so
the constant-velocity prior holds through a turn.  The lap repeats for as
many frames as are asked for; each lap closes exactly, since opposite
quarters are the same steps turned by pi, so every later lap revisits the
first one's poses.

Occluders are the port's floating rectangles (`SyntheticPlanesDataset`):
a plane z = zc facing along z, centre (xc, yc), size w x h.  Beside a
forward course (`occluders`) they lie at the soak's density (6 per 360 m
of corridor), each redrawn until its near edge lies `clearance` m or more
to the side of the course where it crosses zc.  In a walled box
(`box_occluders`) they lie over the box's floor at the same density per
square metre, each redrawn until its footprint on the ground (a segment
along x) lies `clearance` m or more from every pose of the course.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple, Union

import numpy as np

COURSES = ("s_curve", "level", "clear", "lap")


def _lap_yaw_rates(speed: float, straights_m: Sequence[float], turn_m: float) -> np.ndarray:
    """The yaw added after each frame of one lap: per quarter, a straight
    (the two lengths in turn) and then a quarter turn."""
    turn = int(round(turn_m / speed))
    r = np.arange(turn)
    w = 0.5 * (1 - np.cos(2 * np.pi * (r + 0.5) / turn))
    w = w * (np.pi / 2 / w.sum())
    sides = [int(round(s / speed)) for s in straights_m]
    return np.concatenate([np.concatenate([np.zeros(sides[q % 2]), w]) for q in range(4)])


def _lap(drive: Mapping, speed: float) -> np.ndarray:
    return _lap_yaw_rates(speed, [float(s) for s in drive["lap_straights_m"]], float(drive["lap_turn_m"]))


def first_revisit(drive: Mapping, speed: float) -> int:
    """The frame at which the drive table's course first comes back to its
    start: one lap for "lap", 0 for the forward courses, which never do."""
    return len(_lap(drive, speed)) if drive["course"] == "lap" else 0


def poses(n: int, speed: float, shape: Union[str, Mapping]) -> np.ndarray:
    """(n, 4, 4) float64 world-from-camera poses (x right, y down, z ahead).
    `shape` is a course's name, or the traffic file's drive table, whose
    "course" names it (and, for "lap", whose `lap_straights_m` and
    `lap_turn_m` size it)."""
    drive = shape if isinstance(shape, Mapping) else {"course": shape}
    name = drive["course"]
    if name not in COURSES:
        raise ValueError(f"unknown course {name!r} ({' | '.join(COURSES)})")
    if name == "lap":
        dyaw = np.resize(_lap(drive, speed), n)
    else:
        k = np.arange(n)
        arg = 2 * np.pi * k / 320.0
        dyaw = 0.0018 * {"s_curve": np.sin(arg), "level": np.cos(arg), "clear": np.cos(arg + 2.847)}[name]
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


def _path(T_wc: np.ndarray) -> np.ndarray:
    """The course's distinct ground positions (x, z): a lap's repeats
    add none."""
    return np.unique(np.round(T_wc[:, [0, 2], 3], 9), axis=0)


def _distance(path: np.ndarray, xc: float, zc: float, w: float) -> float:
    """The least ground distance from the segment x in xc +- w/2 at z = zc
    to a point of `path` (m, 2)."""
    dx = np.maximum(np.abs(path[:, 0] - xc) - w / 2, 0.0)
    return float(np.sqrt(dx * dx + (path[:, 1] - zc) ** 2).min())


def box_occluders(T_wc: np.ndarray, seed: int, per_m2: float, clearance: float, world: Mapping,
                  ) -> List[Tuple[float, float, float, float, float, int]]:
    """(xc, yc, zc, w, h, salt) of each occluder over the floor of the walled
    box `world` (its x_min, x_max, z_min, z_max, ground_y), drawn from
    `seed`, each `clearance` m or more from the course as a path and wholly
    inside the box."""
    x0, x1, z0, z1 = (float(world[k]) for k in ("x_min", "x_max", "z_min", "z_max"))
    count = int(round(per_m2 * (x1 - x0) * (z1 - z0)))
    path = _path(T_wc)
    rng = np.random.default_rng([seed, 7919, 2])
    out = []
    for k in range(count):
        while True:
            w = rng.uniform(0.8, 2.5)
            h = rng.uniform(0.8, 2.0)
            xc = rng.uniform(x0 + w / 2 + 1.0, x1 - w / 2 - 1.0)
            zc = rng.uniform(z0 + 1.0, z1 - 1.0)
            yc = rng.uniform(-0.5, float(world["ground_y"]) - 0.8)
            if _distance(path, xc, zc, w) >= clearance:
                break
        out.append((xc, yc, zc, w, h, 71 + 13 * k))
    return out


def path_clearance(T_wc: np.ndarray, occ) -> float:
    """The least ground distance from any pose of the course to an
    occluder's footprint."""
    path = _path(T_wc)
    return min((_distance(path, xc, zc, w) for xc, _, zc, w, _, _ in occ), default=float("inf"))
