"""The port's asynchronous backend (pipeline/async_backend.py) and
`VisualOdometry`'s `ba_mode: async`, against the JAX reference's
(tests/test_async_backend.py).

- `solve_window` + `merge_ba_result` on the unchanged map is `ba_step`,
  bit for bit, and the reference's solve of the same map has the same chi
  (1e-2 relative, the bar of tests/test_torch_backend.py) and the same
  merged window relative to its oldest keyframe (1e-3);
- a merge into a map that moved on (a recycled slot, a newborn landmark)
  and into a map wiped by a reset follows the reference's rules, on the
  same maps in both packages;
- the schedule (cadence, `skipped`, `poll`, `flush`) with a solve that
  finishes when the test says so;
- `pick_ba_device`;
- `VisualOdometry` end to end with `ba_async_device` "none" and "auto", held as
  the reference's test holds it: every frame TRACKING_GOOD, ATE < 0.15 m,
  every dispatched solve merged, none pending, finite chi;
- a loop correction and a checkpoint that arrive while a solve is in flight
  settle it first.

On the CPU the worker thread runs without streams; the card's side stream
is held in tests/test_torch_kernels_gpu.py.
"""

import threading

import numpy as np
import pytest
import torch

from legoslam_tpu.pipeline import backend as j_backend
from legoslam_tpu_torch.pipeline import async_backend, backend, state
from legoslam_tpu_torch.pipeline import visual_odometry as t_vo
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.state import WorldMap
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests import test_torch_backend as tb
from tests.test_torch_loop import HOOK_CONFIG, _FixedCorrection, _hook_dataset, _yaw_pose
from tests.test_torch_vo import OVERRIDES
from tests.torch_parity import to_numpy, window_gap

WAIT = 60.0  # seconds any wait in this file may take before the test fails


@pytest.fixture(scope="module")
def ref():
    return tb.reference_maps()


def _maps_equal(a: WorldMap, b: WorldMap) -> bool:
    return all(torch.equal(x, y) for x, y in zip(async_backend._tensors(a), async_backend._tensors(b)))


def test_solve_plus_merge_equals_ba_step(ref):
    d = tb._noisy(ref["maps"]["window"])
    cfg, rig = ref["cfg"], ref["port_rig"]
    ba_cfg = backend.BAConfig(iterations=4)
    wmap = state.worldmap_from_numpy(d)
    m_sync, stats = backend.ba_step(cfg, rig, wmap, ba_cfg)
    result = backend.solve_window(cfg, rig, wmap, ba_cfg)
    assert _maps_equal(backend.merge_ba_result(wmap, result), m_sync)
    assert float(result.stats.chi) == float(stats.chi)
    # the reference's solve of the same map, merged the same way
    jwmap = tb._jtree(tb.JWorldMap, d)
    jres = j_backend.solve_window(ref["jcfg"], ref["rig"], jwmap, j_backend.BAConfig(iterations=4))
    jm = j_backend.merge_ba_result(jwmap, jres)
    np.testing.assert_allclose(float(result.stats.chi), float(jres.stats.chi), rtol=1e-2)
    window = lambda m: {k: to_numpy(getattr(m, k)) for k in ("kf_pose", "kf_valid", "kf_id")}  # noqa: E731
    assert window_gap(window(m_sync), window(jm)) < 1e-3


def test_merge_respects_moved_on_map(ref):
    """tests/test_async_backend.py::test_merge_respects_moved_on_map in both
    packages: a recycled slot keeps its new pose, an unchanged slot takes the
    optimized pose, a newborn landmark is untouched, the optimized landmarks
    are written back."""
    d = ref["maps"]["window"]
    cfg, rig = ref["cfg"], ref["port_rig"]
    result = backend.solve_window(cfg, rig, state.worldmap_from_numpy(d), backend.BAConfig(iterations=4))
    jres = j_backend.solve_window(ref["jcfg"], ref["rig"], tb._jtree(tb.JWorldMap, d), j_backend.BAConfig(iterations=4))
    moved = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    slot = int(np.nonzero(d["kf_valid"])[0][1])
    new_pose = np.eye(4, dtype=np.float32)
    new_pose[0, 3] = 7.0
    lm_new = int(d["lm_next"])
    moved["kf_id"][slot] = d["next_kf_id"]
    moved["kf_frame_id"][slot] = 99
    moved["kf_pose"][slot] = new_pose
    moved["next_kf_id"] = d["next_kf_id"] + 1
    moved["lm_pos"][lm_new] = [1.0, 2.0, 3.0]
    moved["lm_alive"][lm_new] = True
    moved["lm_next"] = d["lm_next"] + 1
    m = backend.merge_ba_result(state.worldmap_from_numpy(moved), result)
    jm = j_backend.merge_ba_result(tb._jtree(tb.JWorldMap, moved), jres)
    for merged in (to_numpy(m.kf_pose), np.asarray(jm.kf_pose)):
        np.testing.assert_array_equal(merged[slot], new_pose)
    kept = int(np.nonzero(d["kf_valid"])[0][0])
    np.testing.assert_array_equal(to_numpy(m.kf_pose)[kept], to_numpy(result.poses)[kept])
    for merged in (to_numpy(m.lm_pos), np.asarray(jm.lm_pos)):
        np.testing.assert_array_equal(merged[lm_new], [1.0, 2.0, 3.0])
    ids, pv = to_numpy(result.active_ids), to_numpy(result.point_valid)
    pv &= ids >= 0
    assert pv.sum() > 100
    np.testing.assert_array_equal(to_numpy(m.lm_pos)[ids[pv]], to_numpy(result.points)[pv])
    np.testing.assert_array_equal(ids, np.asarray(jres.active_ids))
    for name in ("lm_obs", "kf_obs_left", "kf_obs_right"):
        assert (to_numpy(getattr(m, name)) == np.asarray(getattr(jm, name))).mean() >= 0.99, name


def test_merge_after_reset_is_a_noop(ref):
    """A late solve merged into a map wiped by a LOST reset and re-filled at
    another frame writes no pose and no observation count, in both packages."""
    d = ref["maps"]["window"]
    result = backend.solve_window(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d),
                                  backend.BAConfig(iterations=4))
    jres = j_backend.solve_window(ref["jcfg"], ref["rig"], tb._jtree(tb.JWorldMap, d), j_backend.BAConfig(iterations=4))
    fresh = state.carry_to_numpy(t_vo.initial_carry(ref["cfg"], (16, 24), torch.float32, "cpu"))["wmap"]
    fresh["kf_valid"][0], fresh["kf_id"][0], fresh["kf_frame_id"][0] = True, 0, 50
    fresh["next_kf_id"] = np.asarray(1, np.int32)
    m = backend.merge_ba_result(state.worldmap_from_numpy(fresh), result)
    jm = j_backend.merge_ba_result(tb._jtree(tb.JWorldMap, fresh), jres)
    for merged in (m, jm):
        np.testing.assert_array_equal(to_numpy(merged.kf_pose), fresh["kf_pose"])
        np.testing.assert_array_equal(to_numpy(merged.lm_obs), fresh["lm_obs"])


class _GatedBackend(async_backend.AsyncBackend):
    """Solves return a stub result (the map's own poses, no outliers) once
    the test opens the gate of that solve."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gates, self.solved = [], []

    def _solve(self, wmap):
        gate = threading.Event()
        self.gates.append(gate)
        if not gate.wait(WAIT):
            raise TimeoutError("gate never opened")
        self.solved.append(wmap)
        return backend.solve_window(self.cfg, self.rig, wmap, backend.BAConfig(iterations=1))


def _wait_for(cond):
    for _ in range(int(WAIT / 0.01)):
        if cond():
            return
        threading.Event().wait(0.01)
    raise TimeoutError


def test_schedule(ref):
    wmap = state.worldmap_from_numpy(ref["maps"]["window"])
    ab = _GatedBackend(ref["cfg"], ref["port_rig"], backend.BAConfig(), dispatch_every=3)
    for _ in range(2):
        ab.observe()
        assert not ab.want_dispatch
    ab.observe()
    assert ab.want_dispatch
    ab.dispatch(wmap)
    assert ab.stats == {"dispatched": 1, "merged": 0, "skipped": 0} and not ab.want_dispatch
    with pytest.raises(RuntimeError, match="in flight"):
        ab.dispatch(wmap)
    _wait_for(lambda: len(ab.gates) == 1)
    # in flight: poll returns the map untouched, ticks are skipped
    for _ in range(7):
        assert ab.poll(wmap) is wmap
        ab.observe()
    assert ab.stats["skipped"] == 2 and ab.pending is not None
    ab.gates[0].set()
    _wait_for(lambda: ab.pending.future.done())
    merged = ab.poll(wmap)
    assert merged is not wmap and ab.pending is None
    assert ab.stats == {"dispatched": 1, "merged": 1, "skipped": 2} and len(ab.merged_stats) == 1
    assert ab.solved[0] is wmap
    # one frame since the last skipped tick; two more make the cadence
    assert not ab.want_dispatch
    ab.observe(), ab.observe()
    assert ab.want_dispatch
    # flush waits for the solve in flight
    ab.dispatch(merged)
    _wait_for(lambda: len(ab.gates) == 2)
    threading.Timer(0.2, ab.gates[1].set).start()
    out = ab.flush(merged)
    assert ab.pending is None and ab.stats["merged"] == 2 and out is not merged
    assert ab.flush(out) is out  # nothing in flight


def test_solve_error_surfaces(ref):
    class Failing(async_backend.AsyncBackend):
        def _solve(self, wmap):
            raise FloatingPointError("solve failed")

    ab = Failing(ref["cfg"], ref["port_rig"], backend.BAConfig(), dispatch_every=1)
    wmap = state.worldmap_from_numpy(ref["maps"]["window"])
    ab.observe()
    ab.dispatch(wmap)
    with pytest.raises(FloatingPointError, match="solve failed"):
        ab.flush(wmap)


def test_pick_ba_device(monkeypatch):
    assert async_backend.pick_ba_device("none", "cuda") is None
    assert async_backend.pick_ba_device("auto", "cpu") is None
    assert async_backend.pick_ba_device("1", "cpu") is None
    for n, auto in ((1, None), (2, torch.device("cuda", 1))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert async_backend.pick_ba_device("auto", "cuda") == auto
        assert async_backend.pick_ba_device("1", "cuda") == auto
        assert async_backend.pick_ba_device("0", "cuda") is None
        assert async_backend.pick_ba_device("5", "cuda") is None


def _dataset(n_frames=20):
    return TDataset(n_frames=n_frames, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


@pytest.mark.parametrize("ba_async_device", ["none", "auto"])
def test_vo_async_end_to_end(ba_async_device):
    ds = _dataset()
    vo = VisualOdometry(config=Config({**OVERRIDES, "ba_mode": "async", "ba_async_device": ba_async_device}),
                        dataset=ds, device="cpu")
    assert vo.init() and vo.async_backend is not None and vo.async_backend.ba_device is None
    vo.run()
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    T_wc = vo.trajectory_T_wc()
    assert evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:, :3, 3]) < 0.15
    st = vo.async_backend.stats
    assert st["dispatched"] >= 1 and st["merged"] == st["dispatched"], st
    assert vo.async_backend.pending is None
    chis = [float(s.chi) for s in vo.async_backend.merged_stats]
    assert chis and all(np.isfinite(c) for c in chis), chis
    # no frame ran BA inline
    assert all(np.isnan(float(o.ba_chi)) for o in vo.outputs)


def _gated_vo(config, dataset):
    vo = VisualOdometry(config=Config({**config, "ba_mode": "async"}), dataset=dataset, device="cpu")
    assert vo.init()
    ab = vo.async_backend
    gated = _GatedBackend(vo.frontend_cfg, vo.rig, vo.ba_cfg, dispatch_every=ab.dispatch_every)
    vo.async_backend = gated
    events = []
    flush = gated.flush

    def open_and_flush(wmap):
        events.append(("flush", gated.pending is not None))
        for g in gated.gates:
            g.set()
        return flush(wmap)

    gated.flush = open_and_flush
    return vo, gated, events


def test_loop_correction_settles_the_solve_in_flight(monkeypatch):
    """The stub closer of tests/test_torch_loop.py returns a correction at
    frame 7's registration; `VisualOdometry` applies it after frame 8.  The solve
    dispatched after frame 3 (cadence 4) is still in flight then: it is
    merged first, in the old world, and the correction comes after it."""
    vo, ab, events = _gated_vo(HOOK_CONFIG, _hook_dataset(TDataset))
    vo.loop_closer = _FixedCorrection(7, _yaw_pose(4.0, [0.3, -0.1, 0.5]))
    apply = t_vo._apply_world_correction

    def recording(carry, G):
        events.append(("correction", ab.pending is not None, ab.stats["merged"]))
        return apply(carry, G)

    monkeypatch.setattr(t_vo, "_apply_world_correction", recording)
    vo.run()
    assert events[:2] == [("flush", True), ("correction", False, 1)]
    assert ab.stats["dispatched"] == ab.stats["merged"] == 2 and ab.stats["skipped"] == 1 and ab.pending is None
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    assert np.isfinite(vo.trajectory_T_cw()).all()


def test_checkpoint_settles_the_solve_in_flight(tmp_path):
    """A checkpoint taken while a solve is in flight holds the merged map;
    a resumed run continues from it."""
    vo, ab, events = _gated_vo(OVERRIDES, _dataset(12))
    for _ in range(5):
        assert vo.step()
    assert ab.pending is not None and ab.stats["dispatched"] == 1
    before = vo.carry.wmap
    path = vo.save_checkpoint(str(tmp_path / "ckpt.npz"))
    assert events == [("flush", True)] and ab.pending is None and ab.stats["merged"] == 1
    assert not torch.equal(vo.carry.wmap.kf_obs_left, before.kf_obs_left) or \
        not torch.equal(vo.carry.wmap.kf_pose, before.kf_pose)
    resumed = VisualOdometry(config=Config({**OVERRIDES, "ba_mode": "async"}), dataset=_dataset(12), device="cpu")
    assert resumed.init()
    resumed.load_checkpoint(path)
    assert _maps_equal(resumed.carry.wmap, vo.carry.wmap)
    resumed.run()
    assert len(resumed.outputs) == 12
    assert (resumed.statuses() == FrontendStatus.TRACKING_GOOD).all()
    assert resumed.async_backend.pending is None
