"""A drive that comes back, and the seam for stages outside `process_frame`:
- the lap closes each lap, its occluders clear it as a path, and in its
  walled box every direction is textured;
- today's cells keep today's poses, occluders, world and planes (against a
  frozen copy of the code before the lap, and pinned by value), today's
  frame count and today's warm-up; a lap's warm-up runs to its first
  revisit;
- a configuration's stage files wrap a module function and a class
  method, keep their calls up to a cap as data (nothing of the port's
  objects survives into the reference's replay), have their gaps held to
  the limits, and are taken off again; a configuration with none installs
  today's wrappers."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import check, harness
from portbench.world import course, render, source

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
INTR = (718.856 / 8, 718.856 / 8, 607.1928 / 8, 185.2157 / 8)
SHAPE = (47, 155)
LAP = {"course": "lap", "lap_straights_m": [18.0, 18.0], "lap_turn_m": 12.0, "wall_margin_m": 12.0,
       "ground_y_m": 1.6, "occluders_per_m2": 1 / 864, "occluder_clearance_m": 1.5, "photometric_noise": 1.5}


# --- the lap -------------------------------------------------------------------

@pytest.mark.parametrize("straights,turn", [([18.0, 18.0], 12.0), ([9.6, 14.4], 7.2)])
def test_the_lap_closes_each_lap(straights, turn):
    drive = dict(LAP, lap_straights_m=straights, lap_turn_m=turn)
    L = 2 * sum(round(s / 0.3) for s in straights) + 4 * round(turn / 0.3)
    T = course.poses(3 * L + 17, 0.3, drive)
    assert np.allclose(np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1), 0.3)
    for k in (1, 2, 3):
        a, b = T[k * L:], T[:len(T) - k * L]
        assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 1e-9
        assert np.abs(a[:, :3, :3] - b[:, :3, :3]).max() <= 1e-12  # rad, for angles this small
    # It comes back and faces each way: +z, +x, -z, -x at the middle of each straight.
    mid = [round(straights[0] / 0.3) // 2, round(straights[0] / 0.3) + round(turn / 0.3) + round(straights[1] / 0.3) // 2]
    q = round((straights[0] + straights[1] + 2 * turn) / 0.3)
    headings = [T[i, :3, 2] for i in (mid[0], mid[1], mid[0] + q, mid[1] + q)]
    assert np.allclose(headings, [[0, 0, 1], [1, 0, 0], [0, 0, -1], [-1, 0, 0]], atol=1e-12)


@pytest.mark.parametrize("seed", [0, 99, 2**31 + 7, 2**40 + 3])
def test_lap_occluders_clear_the_path(seed):
    T = course.poses(4541, 0.3, LAP)
    world = source.world_of(LAP, T)
    occ = source.occluders_of(LAP, T, world, seed)
    area = (world["x_max"] - world["x_min"]) * (world["z_max"] - world["z_min"])
    assert len(occ) == round(area / 864) >= 3
    assert course.path_clearance(T, occ) >= 1.5
    for xc, yc, zc, w, h, _ in occ:
        assert world["x_min"] < xc - w / 2 and xc + w / 2 < world["x_max"] and world["z_min"] < zc < world["z_max"]
        assert -0.5 <= yc <= 1.6 - 0.8
    assert occ == source.occluders_of(LAP, T, world, seed)
    assert occ != source.occluders_of(LAP, T, world, seed + 1)


def test_the_box_stands_a_margin_beyond_the_course():
    T = course.poses(800, 0.3, LAP)
    world = source.world_of(LAP, T)
    assert world["x_min"] == pytest.approx(T[:, 0, 3].min() - 12.0) and world["z_max"] == pytest.approx(
        T[:, 2, 3].max() + 12.0)
    assert [p[0] for p in render.planes(world)] == [1, 0, 0, 2, 2]
    assert [p[3] for p in render.planes(world)] == [11, 23, 37, 53, 59]


@pytest.mark.parametrize("drive", [
    {k: v for k, v in LAP.items() if k != "wall_margin_m"},
    dict(json.loads((ROOT / "portbench/traffic/drive.json").read_text())["drive"], wall_margin_m=12.0)],
    ids=["lap-without-box", "corridor-with-box"])
def test_the_box_goes_with_the_lap_alone(drive):
    with pytest.raises(ValueError, match="wall_margin_m"):
        source.world_of(drive, course.poses(20, 0.3, drive))


def _facing(yaw, at):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = at
    return T[None]


@pytest.mark.parametrize("yaw", [0.0, np.pi, np.pi / 2, -np.pi / 2], ids=["+z", "-z", "+x", "-x"])
def test_every_direction_in_the_box_is_textured(yaw):
    T = course.poses(400, 0.3, LAP)
    world = source.world_of(LAP, T)
    occ = source.occluders_of(LAP, T, world, 5)
    for at in (T[0, :3, 3], T[130, :3, 3], [0.5 * (world["x_min"] + world["x_max"]), 0.0, 5.0]):
        left, right = render.render(_facing(yaw, at), INTR, 0.537, SHAPE, world, occ, 5, 0.0, "cpu")
        assert (left != 12).all() and (right != 12).all()
        assert left.std() > 10.0
    # The corridor, open behind, shows the background to a camera facing -z.
    if yaw == np.pi:
        corridor = {"half_width": 12.0, "ground_y": 1.6, "z_min": -20.0, "length": 200.0}
        left, _ = render.render(_facing(yaw, [0.0, 0.0, 0.0]), INTR, 0.537, SHAPE, corridor, [], 5, 0.0, "cpu")
        assert (left == 12).any()


def test_occluders_behind_a_turned_camera_are_culled_and_ahead_are_not():
    import torch

    R = torch.tensor(_facing(np.pi / 2, [0, 0, 0])[:, :3, :3], dtype=torch.float32)  # facing +x
    o = torch.zeros((1, 3))
    occ = [(5.0, 0.0, 0.0, 1.0, 1.0, 71),   # ahead, at the camera's z
           (-5.0, 0.0, 0.0, 1.0, 1.0, 84),  # behind
           (-0.5, 0.0, 3.0, 2.0, 1.0, 97)]  # straddles the camera's plane
    assert render._in_front(o, R, occ) == [True, False, True]


# --- today's cells keep today's world ---------------------------------------------

def _today_poses(n, speed, shape):
    """course.poses as it was before the lap."""
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


def _today_occluders(T_wc, seed, per_metre, clearance, half_width, ground_y):
    """course.occluders as it was before the lap."""
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
            if abs(xc - float(np.interp(zc, T_wc[:, 2, 3], T_wc[:, 0, 3]))) - w / 2 >= clearance:
                break
        out.append((xc, yc, zc, w, h, 71 + 13 * k))
    return out


# Pinned from the code before the lap (seed 3150000077): frames rendered,
# the last pose's R[0, 0], x and z, the occluders' count, first and last.
TODAY = {
    "kitti00.drive": (4541, [0.9963685976970437, 2.0617794252548998, 1359.150956593645], 23,
                      (6.480439690790554, -0.3351128189667875, 87.22528705616823, 1.5955063666873899,
                       1.529658963204228, 71),
                      (-1.6658762097317554, 0.18192956498807, 945.2764336151353, 1.2614676325866352,
                       0.9311851218870025, 357)),
    "kitti05-klt.drive": (2761, [0.997998217149514, 3.151317765902722, 826.2753897509148], 14,
                          (6.480439690790554, -0.3351128189667875, 56.4356649906197, 1.5955063666873899,
                           1.529658963204228, 71),
                          (-0.14277760915106086, 0.4646802527667966, 44.76612543878098, 1.9064175451068315,
                           1.607453892445445, 240)),
    "kitti00.live10hz": (361, [0.9978827647404276, 0.4876049931841647, 107.78946745354857], 2,
                         (6.480439690790554, -0.3351128189667875, 14.921451572983493, 1.5955063666873899,
                          1.529658963204228, 71),
                         (5.592411530492239, 0.6078791034082967, 89.96358739457676, 1.8291389258615536,
                          1.684618896908134, 84)),
}


@pytest.mark.parametrize("name", list(TODAY))
def test_todays_cells_keep_todays_world(name):
    cell = harness.Cell(BENCH, name)
    drive, speed, seed = cell.traffic["drive"], float(cell.config["speed_m_per_frame"]), 3150000077
    n, last, count, first_occ, last_occ = TODAY[name]
    t = cell.traffic
    assert harness.frames_to_render(cell, BENCH["run_seconds"]) == n == min(
        int(cell.config["sequence_frames"]),
        int(t["warmup_max_frames"]) + int(np.ceil(float(t["max_frames_per_s"]) * BENCH["run_seconds"])) + 1)
    T = course.poses(n, speed, drive)
    assert np.array_equal(T, _today_poses(n, speed, drive["course"]))
    assert np.allclose([T[-1, 0, 0], T[-1, 0, 3], T[-1, 2, 3]], last, rtol=0, atol=1e-9)
    world = source.world_of(drive, T)
    assert world == {"half_width": 12.0, "ground_y": 1.6, "z_min": -20.0, "length": float(T[-1, 2, 3]) + 60.0}
    assert render.planes(world) == [(1, 1.6, (0, 2), 11), (0, -12.0, (2, 1), 23), (0, 12.0, (2, 1), 37),
                                    (2, world["length"], (0, 1), 53)]
    occ = source.occluders_of(drive, T, world, seed)
    assert occ == _today_occluders(T, seed, float(drive["occluders_per_m"]), 1.5, 12.0, 1.6)
    assert len(occ) == count
    assert np.allclose([occ[0], occ[-1]], [first_occ, last_occ], rtol=0, atol=1e-9)


def test_the_corridor_renders_as_before_the_cull_changed():
    """The cull by each camera's heading skips only what no pixel shows:
    frames with and without it are the same bytes."""
    T = course.poses(4, 0.3, "level")
    world = {"half_width": 12.0, "ground_y": 1.6, "z_min": -20.0, "length": 120.0}
    occ = [(3.0, 0.0, 9.0, 2.0, 1.5, 71), (-4.0, 0.2, -3.0, 2.0, 1.5, 84), (2.0, 0.1, 40.0, 2.5, 2.0, 97)]
    a = render.render(T, INTR, 0.537, SHAPE, world, occ, 11, 1.5, "cpu")
    b = render.render(T, INTR, 0.537, SHAPE, world, [o for o in occ if o[2] > 0], 11, 1.5, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# --- the warm-up ----------------------------------------------------------------------

class _FakeVO:
    """A keyframe every `gap` frames from frame 0; the window holds at most
    `cap` keyframes; counts the reads of its keyframe count."""

    def __init__(self, gap=5, cap=15, frames=2000):
        from types import SimpleNamespace

        self.gap, self.cap, self.frames, self.outputs, self.reads = gap, cap, frames, [], 0
        self.carry = SimpleNamespace(wmap=SimpleNamespace(num_keyframes=self._num))

    def _num(self):
        self.reads += 1
        return min(sum(o.kf_inserted for o in self.outputs), self.cap)

    def step(self):
        from types import SimpleNamespace

        if len(self.outputs) >= self.frames:
            return False
        self.outputs.append(SimpleNamespace(kf_inserted=len(self.outputs) % self.gap == 0))
        return True


class _FakeHooks:
    record = None


def _today_warm_up(vo, warmup_max, n_active):
    """harness.run_cell's warm-up as it was before the floor."""
    warm, full = 0, False
    while True:
        vo.step()
        warm += 1
        out = vo.outputs[-1]
        if out.kf_inserted:
            if full:
                break
            full = int(vo.carry.wmap.num_keyframes()) >= n_active
        if warm >= warmup_max:
            raise RuntimeError
    return warm


@pytest.mark.parametrize("name", list(TODAY))
def test_warm_up_without_a_floor_stops_as_today(name):
    cell = harness.Cell(BENCH, name)
    assert harness.warmup_floor(cell) == 0
    n_active = int(cell.config["settings"]["num_active_keyframes"])
    vo, samples = _FakeVO(), []
    warm = harness.warm_up(vo, _FakeHooks(), cell.traffic, n_active, samples, harness.warmup_floor(cell))
    old = _FakeVO()
    assert warm == _today_warm_up(old, int(cell.traffic["warmup_max_frames"]), n_active) == 76
    assert vo.reads == old.reads and len(samples) == 1


@pytest.mark.parametrize("floor,expect", [(0, 76), (50, 76), (76, 76), (77, 81), (400, 401), (403, 406)])
def test_warm_up_floor(floor, expect):
    traffic = {"warmup_max_frames": 160}
    vo = _FakeVO()
    assert harness.warm_up(vo, _FakeHooks(), traffic, 15, [], floor) == expect
    assert vo.outputs[expect - 1].kf_inserted
    with pytest.raises(RuntimeError, match=f"in {160 + floor} frames"):
        harness.warm_up(_FakeVO(cap=999), _FakeHooks(), traffic, 999, [], floor)


@pytest.mark.parametrize("straights,turn,lap", [([18.0, 18.0], 12.0, 400), ([9.6, 14.4], 7.2, 256)])
def test_a_laps_warm_up_runs_to_its_first_revisit(straights, turn, lap):
    cell = harness.Cell(BENCH, "kitti00.drive")
    cell.traffic = dict(cell.traffic, drive=dict(LAP, lap_straights_m=straights, lap_turn_m=turn),
                        max_frames_per_s=10.0)
    assert harness.warmup_floor(cell) == lap
    T = course.poses(lap + 1, 0.3, cell.traffic["drive"])
    assert np.abs(T[lap] - T[0]).max() <= 1e-9 and np.abs(T[1:lap, :3, 3]).max(axis=1).min() > 0.29
    assert harness.frames_to_render(cell, 20) == 160 + lap + 200 + 1


# --- the stage seam ---------------------------------------------------------------------

TOY = '''
"""A toy stage: the keyframe detector (a module function) and
VisualOdometry.process (a class method)."""
import gc
import weakref

import numpy as np

WRAP = (("pipeline.frontend", "detect_features", "toy_detect"),
        ("pipeline.visual_odometry", "VisualOdometry.process", "toy_process"))
KEEP = 3
GAPS = ("toy_calls", "toy_frame_ids", "toy_port_alive", "toy_not_data")
_PORT = []  # weak references to the port's objects the kept calls were handed


def keep(args, kw, out):
    if len(args) > 1 and hasattr(args[1], "frame_id"):  # VisualOdometry.process(self, frame)
        _PORT.append(weakref.ref(args[0]))
        return {"frame_id": args[1].frame_id, "frame": args[1], "out": out}
    _PORT.append(weakref.ref(args[2]))  # detect_features(cfg, img, feats)
    return [len(args), args[1][:2, :3].clone(), args[2]]


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in x for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def replay(calls, ctx, control=None):
    if not calls["toy_process"]:
        return {}
    ids = [c["frame_id"] for c in calls["toy_process"]]
    gc.collect()
    leaves = _leaves(calls)
    return {"toy_calls": float(len(ids) + len(calls["toy_detect"])),
            "toy_frame_ids": float(max(ids) - min(ids)) + (100.0 if control is not None else 0.0),
            "toy_port_alive": float(sum(r() is not None for r in _PORT)),
            "toy_not_data": float(sum(not isinstance(v, (np.ndarray, np.generic, bool, int, float, str, type(None)))
                                      for v in leaves)) + float(not any(isinstance(v, np.ndarray) for v in leaves))}
'''


def _stage(tmp_path):
    (tmp_path / "toy.py").write_text(TOY)
    return check.load_stage("toy", tmp_path)


def _wrapped(hooks):
    return [(owner.__name__, name) for owner, name, _, _ in hooks._saved]


def test_no_stage_files_install_todays_wrappers():
    from portbench import hooks as hooks_mod

    assert hooks_mod.STAGES == (("pipeline.frontend", "stereo_init", "init"),
                                ("pipeline.frontend", "track_last_frame", "track"),
                                ("pipeline.frontend", "estimate_current_pose", "pose"),
                                ("pipeline.frontend", "insert_keyframe", "insert"),
                                ("pipeline.backend", "ba_step", "ba"))
    assert [t for _, _, t in hooks_mod.SPANS] == ["detect", "stereo", "triangulate", "ba_problem", "lm_solve"]
    assert [t for _, _, t in hooks_mod.KERNELS] == ["k1_anchored", "k1_frame", "k2"]
    h = hooks_mod.Hooks().install()
    try:
        want = [("legoslam_tpu_torch.pipeline.visual_odometry", "process_frame")] + [
            (f"legoslam_tpu_torch.{m}", n) for m, n, _ in hooks_mod.STAGES + hooks_mod.SPANS + hooks_mod.KERNELS]
        assert _wrapped(h) == want
    finally:
        h.remove()
    assert check.FRAME_NAMES == ("track_px", "track_lanes", "pose_T", "pose_lanes", "kf_px", "kf_lanes",
                                 "kf_lm_m", "ba_pose", "ba_lm_m", "ba_chi")
    assert check.NAMES[:len(check.FRAME_NAMES)] == check.FRAME_NAMES
    assert harness.Cell(BENCH, "kitti00.drive").config.get("stages") is None


def test_a_stage_file_wraps_keeps_and_restores(tmp_path):
    from legoslam_tpu_torch.pipeline import frontend, visual_odometry
    from portbench.hooks import Hooks

    stage = _stage(tmp_path)
    assert check.stage_names(tmp_path) == ("toy_calls", "toy_frame_ids", "toy_port_alive", "toy_not_data")
    before = (frontend.detect_features, vars(visual_odometry.VisualOdometry)["process"])
    h = Hooks([stage]).install()
    try:
        assert frontend.detect_features is not before[0]
        assert vars(visual_odometry.VisualOdometry)["process"] is not before[1]
        assert _wrapped(h)[-2:] == [("legoslam_tpu_torch.pipeline.frontend", "detect_features"),
                                    ("VisualOdometry", "process")]
    finally:
        h.remove()
    assert frontend.detect_features is before[0]
    assert vars(visual_odometry.VisualOdometry)["process"] is before[1]


class _Frame:
    def __init__(self, i):
        self.frame_id = i


class _Probe:
    def call(self, frame):
        return frame.frame_id

    @staticmethod
    def static(frame):
        return -frame.frame_id


class _SubProbe(_Probe):
    pass


def test_kept_calls_are_capped_and_every_kind_of_attribute_comes_back():
    from portbench.hooks import Hooks

    h = Hooks()
    own, static = vars(_Probe)["call"], vars(_Probe)["static"]
    h._wrap(_Probe, "call", h._kept("probe", 3, lambda a, kw, out: (a[1].frame_id, out)))
    h._wrap(_Probe, "static", h._kept("static", 2, lambda a, kw, out: (a, out)))
    h._wrap(_SubProbe, "call", h._kept("sub", 1, lambda a, kw, out: (a, out)))  # inherited: the subclass's own
    p, q = _Probe(), _SubProbe()
    assert p.call(_Frame(0)) == 0 and h.kept is None  # outside the window nothing is kept
    h.kept = {}
    assert [p.call(_Frame(i)) for i in range(1, 6)] == [1, 2, 3, 4, 5]
    assert [_Probe.static(_Frame(i)) for i in range(3)] == [0, -1, -2]
    q.call(_Frame(7))
    assert h.kept["probe"] == [(1, 1), (2, 2), (3, 3)]
    assert [c[1] for c in h.kept["static"]] == [0, -1] and len(h.kept["sub"]) == 1
    assert h.kept["sub"][0][0][0] is q  # a method's call keeps its instance first
    h.remove()
    assert vars(_Probe)["call"] is own and vars(_Probe)["static"] is static
    assert "call" not in vars(_SubProbe) and q.call(_Frame(8)) == 8


def test_kept_calls_become_data_and_nothing_else():
    import dataclasses

    import torch

    from portbench.hooks import as_data

    @dataclasses.dataclass
    class Out:
        T: torch.Tensor
        n: int

    got = as_data({"out": Out(torch.eye(2), 3), "xs": [torch.ones(2), np.float32(1.5), None, "a"],
                   "t": (True, np.zeros(1))})
    assert isinstance(got["out"], dict) and isinstance(got["out"]["T"], np.ndarray) and got["out"]["n"] == 3
    assert isinstance(got["xs"][0], np.ndarray) and got["xs"][1:] == [np.float32(1.5), None, "a"]
    assert got["t"][0] is True and isinstance(got["t"][1], np.ndarray)
    for bad in (_Probe(), [1, {"self": _SubProbe()}], (lambda: 0,), {"cls": _Probe}):
        with pytest.raises(TypeError, match="not data"):
            as_data(bad)


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """A tiny run on the CPU whose configuration names the toy stage."""
    torch = pytest.importorskip("torch")
    from legoslam_tpu_torch.pipeline import frontend, visual_odometry

    tmp = tmp_path_factory.mktemp("stages")
    (tmp / "toy.py").write_text(TOY)
    cell = harness.Cell(BENCH, "kitti00.drive")
    cell.config["camera"]["image_scale"] = 0.25
    cell.config["settings"].update(
        num_active_keyframes=4, keyframe_window_capacity=5, max_features=128, max_active_landmarks=512,
        max_ba_edges=1280, max_landmarks=8192, num_features=60, num_features_init=20,
        num_features_needed_for_keyframe=40, num_features_tracking=12)
    cell.traffic.update(warmup_max_frames=60, max_frames_per_s=6)
    cell.traffic["sample"].update(min_frames_per_s=2, frames=4, keyframes=2)
    cell.config["stages"] = ["toy"]
    cell.config["limits"] = dict(cell.config["limits"], toy_calls=6, toy_frame_ids=2, toy_port_alive=0,
                                 toy_not_data=0)
    before = (frontend.detect_features, vars(visual_odometry.VisualOdometry)["process"])
    torch.set_num_threads(2)
    res = harness.run_cell(cell, 2**33 + 17, 2.0, False, "cpu", log=lambda m: None, control=True, stage_dir=tmp)
    after = (frontend.detect_features, vars(visual_odometry.VisualOdometry)["process"])
    return res, before, after


def test_a_stage_files_gaps_are_held_to_the_limits(toy_run):
    res, before, after = toy_run
    assert after[0] is before[0] and after[1] is before[1]
    assert res["attempted"] > 3
    # Three process calls kept of the window's frames, in order; detect ran in the window's keyframes.
    assert res["gaps"]["toy_frame_ids"] == 2.0 and 4.0 <= res["gaps"]["toy_calls"] <= 6.0
    # What the reference replays is data, and the objects of the port it was taken from are gone.
    assert res["gaps"]["toy_not_data"] == 0.0 and res["gaps"]["toy_port_alive"] == 0.0
    rows = {r["name"]: r for r in res["checks"]}
    assert rows["toy_calls"]["value"] == res["gaps"]["toy_calls"] and rows["toy_frame_ids"]["limit"] == 2
    assert res["correct"], res["checks"]
    assert res["control"]["toy_frame_ids"] == 102.0
    limits = {r["name"]: r["limit"] for r in res["checks"]}
    assert not check.verdict(res["gaps"], dict(limits, toy_frame_ids=1.5))[0]
    assert not check.verdict(res["gaps"], dict(limits, toy_never_read=1.0))[0]
