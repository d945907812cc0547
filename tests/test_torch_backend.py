"""The port's window BA (pipeline/backend.py) against the JAX reference on
the same world maps.

The maps come from the reference itself: its inline-BA run of the test
corridor (tests/test_torch_vo.py's scene and small capacities, a keyframe
every second frame), copied to NumPy after the first frame (stereo init and
its BA) and after the seventh (a window of four keyframes), and handed to
the port with `state.worldmap_from_numpy`.  The reference runs with
`ba_assembly_precision: f32`; the port's `BAConfig()` assembles at f32.

The reference leaves every window pose free (backend.py:176), so the
window's rigid placement (its gauge) is held only by the LM damping, and
two correct solves that sum in other orders can end a rigid motion apart
(up to 1 m under strategy1's tiny damping on these maps).  So `solve_ba` is
compared with the oldest keyframe fixed in both graphs, and the full
`ba_step` on its gauge-free values: chi, relative poses and the outlier
verdicts.

Bars: `build_problem` bit-equal (integer sorts and gathers); final chi
within 1e-2 relative, keyframe poses within 1e-3, landmarks seen at least
twice within 1e-2 m, outlier verdicts agree on >= 99% of the observation
grid (the two packages sum in other orders, so an edge near the threshold
may fall either way) and the observation counts are equal where they agree;
`merge_ba_result` exact.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from legoslam_tpu.pipeline import backend as j_backend
from legoslam_tpu.pipeline import frontend as j_frontend
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.state import MargState as JMargState
from legoslam_tpu.pipeline.state import WorldMap as JWorldMap
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.pipeline import backend, frontend, state
from legoslam_tpu_torch.solver import lm, robust, schur
from legoslam_tpu_torch.utils.config import Config
from tests.lm_bits import assert_same_lm_bits, lm_both_ways, pose_prior
from tests.test_torch_vo import F32, OVERRIDES, _dataset
from tests.torch_parity import (agreement, assert_close, load_kitti_window, t, to_numpy, tree_to_numpy,
                                window_gap)

CONFIG = {**OVERRIDES, "max_keyframe_gap": 2}
SEED = 0
KITTI_WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "kitti_soak_window_f25.npz")
# The run's chi at frame 25: port 46.19, reference 46.54 / 46.63 / 46.60 under
# XLA's instruction sets (a spread of 0.19%).  On the reference's own map the
# reference gives 46.54182 / 46.54182 / 46.54197 and the port 46.54177 (f32:
# 43.51135 and 43.51228), so the bar sits far below the run's gap.
KITTI_CHI_RTOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    return reference_maps()


def reference_maps():
    """The reference's maps, rig and configs (see the module docstring)."""
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig({**CONFIG, **F32}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    maps = {}
    for k in range(7):
        assert vo.step()
        if k == 0:
            maps["init"] = tree_to_numpy(vo.carry.wmap)
    maps["window"] = tree_to_numpy(vo.carry.wmap)
    assert maps["window"]["kf_valid"].sum() == 4
    return {
        "maps": maps,
        "rig": ds.rig,
        "port_rig": state.rig_from_numpy(tree_to_numpy(ds.rig)),
        "jcfg": j_frontend.FrontendConfig.from_config(JConfig(CONFIG)),
        "cfg": frontend.FrontendConfig.from_config(Config({**CONFIG, **F32})),
    }


def _jtree(cls, d):
    """A reference state NamedTuple from the nested NumPy dict."""
    kw = {k: _jtree(JMargState, v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}
    return cls(**kw)


def _noisy(d, landmark_sigma=0.05, pose_sigma=0.005):
    """The map with its alive landmarks and valid keyframe positions
    perturbed, and one left observation in each of three keyframes moved by
    (40, -25) px: outliers for the adaptive threshold."""
    rng = np.random.default_rng(SEED)
    d = {**d, "lm_pos": d["lm_pos"].copy(), "kf_pose": d["kf_pose"].copy(), "kf_uv": d["kf_uv"].copy()}
    alive = d["lm_alive"]
    d["lm_pos"][alive] += rng.normal(0, landmark_sigma, (alive.sum(), 3)).astype(np.float32)
    slots = np.nonzero(d["kf_valid"])[0]
    for s in slots:
        d["kf_pose"][s, :3, 3] += rng.normal(0, pose_sigma, 3).astype(np.float32)
    for s in slots[:3]:
        d["kf_uv"][s, np.nonzero(d["kf_obs_left"][s])[0][5]] += np.asarray([40.0, -25.0], np.float32)
    return d


def _caps(cfg, **kw):
    return cfg._replace(caps=cfg.caps._replace(**kw))


@pytest.mark.parametrize("case", ["init", "window", "edges_over_budget", "landmarks_over_budget"])
def test_build_problem_bit_equal(ref, case):
    d = ref["maps"]["init" if case == "init" else "window"]
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    if case == "edges_over_budget":
        jcfg, cfg = _caps(jcfg, ba_edges=200), _caps(cfg, ba_edges=200)
    elif case == "landmarks_over_budget":
        jcfg, cfg = _caps(jcfg, active_landmarks=50), _caps(cfg, active_landmarks=50)
    jp, jc = j_backend.build_problem(jcfg, ref["rig"], _jtree(JWorldMap, d))
    p, c = backend.build_problem(cfg, ref["port_rig"], state.worldmap_from_numpy(d))
    np.testing.assert_array_equal(to_numpy(c), np.asarray(jc))
    n_active, n_dropped = np.asarray(jc)
    assert n_active > 0
    assert (n_dropped > 0) == (case.endswith("over_budget"))
    np.testing.assert_array_equal(to_numpy(p.e_src), np.asarray(jp.e_src))
    np.testing.assert_array_equal(to_numpy(p.active_ids), np.asarray(jp.active_ids))
    np.testing.assert_array_equal(to_numpy(p.points), np.asarray(jp.points))
    for name in ("e_pose", "e_point", "e_cam", "e_uv", "e_valid", "pose_fixed", "point_valid"):
        np.testing.assert_array_equal(to_numpy(getattr(p.graph, name)), np.asarray(getattr(jp.graph, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["init", "window"])
def test_ba_sum_widths_hold(ref, case):
    """`solve_window` sizes its fixed-order sum tables by the window's
    structure (2 NF edges per slot, 2 KW per landmark, one per camera per
    slot and landmark) without reading the device; the graph's own widths
    stay within them."""
    from legoslam_tpu_torch.solver import schur

    cfg = ref["cfg"]
    p, _ = backend.build_problem(cfg, ref["port_rig"], state.worldmap_from_numpy(ref["maps"][case]))
    need = [x.shape[1] for x in schur.build_order(p.graph, cfg.caps.window, p.points.shape[0])]
    assert need[0] > 1 and need[1] > 1
    assert need[0] <= 2 * cfg.caps.max_features and need[1] <= 2 * cfg.caps.window and need[2] <= 2, need


@pytest.mark.parametrize("chis,expected", [
    ([1.0] * 4 + [100.0] * 6, 5.991 * 32),  # ratio 0.4 until the 5-doubling cap
    ([1.0] * 9 + [100.0], 5.991),           # ratio 0.9 at once
])
def test_adaptive_chi2_threshold(chis, expected):
    chis = np.asarray(chis, np.float32)
    valid = np.ones(chis.shape, bool)
    th_ref = float(j_backend.adaptive_chi2_threshold(jnp.asarray(chis), jnp.asarray(valid), j_backend.BAConfig()))
    th = float(backend.adaptive_chi2_threshold(t(chis), t(valid), backend.BAConfig()))
    assert th == th_ref == pytest.approx(expected)


@pytest.mark.parametrize("strategy", ["default", "strategy1"])
def test_solve_ba_matches_reference(ref, strategy):
    """`lm.solve_ba` on the same graph with the oldest keyframe fixed."""
    d = _noisy(ref["maps"]["window"])
    jp, _ = j_backend.build_problem(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d))
    p, _ = backend.build_problem(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d))
    oldest = int(np.argmax(d["kf_valid"]))
    jg = jp.graph._replace(pose_fixed=jp.graph.pose_fixed.at[oldest].set(True))
    g = p.graph._replace(pose_fixed=p.graph.pose_fixed.clone().index_fill_(0, torch.tensor(oldest), True))
    jst, jres = j_lm.solve_ba(jg, jp.poses, jp.points, cfg=j_lm.LMConfig(strategy=strategy))
    st, res = lm.solve_ba(g, p.poses, p.points, cfg=lm.LMConfig(strategy=strategy))
    np.testing.assert_allclose(float(res.chi), float(jres.chi), rtol=1e-2)
    chi0 = float(schur.robust_chi(g, p.poses, p.points, robust.HUBER, 5.991))
    assert float(res.chi) < 0.9 * chi0
    valid = d["kf_valid"]
    assert_close(to_numpy(st.poses)[valid], np.asarray(jst.poses)[valid], 1e-3)
    n_obs = np.bincount(to_numpy(g.e_point)[to_numpy(g.e_valid)], minlength=len(g.point_valid))
    seen_twice = to_numpy(g.point_valid) & (n_obs >= 2)
    assert seen_twice.sum() > 100
    assert_close(to_numpy(st.points), np.asarray(jst.points), 1e-2, where=seen_twice)
    assert 1 <= res.iterations <= res.attempts and res.trace.shape == (0, 2)


@pytest.mark.parametrize("strategy", ["default", "strategy1"])
def test_ba_step_matches_reference(ref, strategy):
    """The whole cycle on the map, gauge free: chi, poses relative to the
    oldest keyframe, outlier verdicts and observation counts.

    Under strategy1 (lambda 1e-5 and falling) the window has not settled
    after 10 iterations: chi still falls ~0.007 per iteration while the
    oldest keyframe slides along the corridor relative to the others.  Where
    it ends depends on the summation order: the reference's own runs of one
    map under XLA's CPU instruction sets (`--xla_cpu_max_isa` unset, AVX2,
    SSE4_2) part by up to 7.46e-4 there, and the port, on the map that an
    AVX2 run of the reference makes, by 1.568e-3 at chi equal to 2e-6
    (`python -m tests.ba_parity_report --isa-spread`).  So strategy1 is held
    by chi, within 1e-4 relative (the reference's spread 5.3e-5), and the
    relative poses at 1e-3 only under the default strategy (spread 3.05e-4,
    the port within 2.5e-4)."""
    d = _noisy(ref["maps"]["window"])
    ba_cfg = dict(strategy=strategy, trace=True)
    jm, stats_r = j_backend.ba_step(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d), j_backend.BAConfig(**ba_cfg))
    m, stats = backend.ba_step(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d),
                               backend.BAConfig(**ba_cfg))
    np.testing.assert_allclose(float(stats.chi), float(stats_r.chi), rtol=1e-2)
    valid = d["kf_valid"]
    oldest = int(np.argmax(valid))

    def relative(T):
        T = np.asarray(T, np.float64)
        return (T @ np.linalg.inv(T[oldest]))[valid]

    if strategy == "default":
        assert_close(relative(to_numpy(m.kf_pose)), relative(jm.kf_pose), 1e-3)
    else:
        np.testing.assert_allclose(float(stats.chi), float(stats_r.chi), rtol=1e-4)
    assert int(stats.n_outlier) >= 3 and int(stats_r.n_outlier) >= 3
    agree = np.ones(d["kf_lm"].shape, bool)
    for name in ("kf_obs_left", "kf_obs_right"):
        a, b = to_numpy(getattr(m, name)), np.asarray(getattr(jm, name))
        assert agreement(a, b) >= 0.99, name
        agree &= a == b
    ids = d["kf_lm"][agree & (d["kf_lm"] >= 0)]
    np.testing.assert_array_equal(to_numpy(m.lm_obs)[ids], np.asarray(jm.lm_obs)[ids])
    assert int(stats.n_active_landmarks) == int(stats_r.n_active_landmarks)
    assert int(stats.n_dropped_landmarks) == int(stats_r.n_dropped_landmarks) == 0
    # the trace: one finite [chi, lambda] row per iteration run, NaN after
    tr = to_numpy(stats.trace)
    assert tr.shape == (10, 2) and np.isfinite(tr[: stats.iterations]).all()
    assert np.isnan(tr[stats.iterations:]).all()
    np.testing.assert_allclose(tr[stats.iterations - 1, 0], float(stats.chi))


def test_ba_step_removes_planted_outlier(ref):
    """tests/test_backend.py:64-106 on the port: one corrupted left
    observation is flagged and cleared, the count of its landmark drops by
    exactly the removals charged to it, no other observation goes, and the
    reference removes the same observations."""
    d = {**ref["maps"]["init"]}
    slot = int(np.argmax(d["kf_valid"]))
    target = int(np.nonzero(d["kf_obs_left"][slot])[0][0])
    d["kf_uv"] = d["kf_uv"].copy()
    d["kf_uv"][slot, target] += np.asarray([45.0, -30.0], np.float32)
    lm_id = int(d["kf_lm"][slot, target])

    jm, _ = j_backend.ba_step(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d))
    m, stats = backend.ba_step(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d))
    obs_l, obs_r = to_numpy(m.kf_obs_left), to_numpy(m.kf_obs_right)
    assert int(stats.n_outlier) >= 1
    assert not obs_l[slot, target]
    removed = (d["kf_obs_left"] & ~obs_l) | (d["kf_obs_right"] & ~obs_r)
    n_removed = int((d["kf_obs_left"] & ~obs_l).sum() + (d["kf_obs_right"] & ~obs_r).sum())
    assert n_removed == int(stats.n_outlier)
    is_lm = d["kf_lm"] == lm_id
    removed_this = int(((d["kf_obs_left"] & ~obs_l) & is_lm).sum() + ((d["kf_obs_right"] & ~obs_r) & is_lm).sum())
    assert removed_this >= 1
    assert int(to_numpy(m.lm_obs)[lm_id]) == int(d["lm_obs"][lm_id]) - removed_this
    assert not (removed & ~is_lm).any()
    np.testing.assert_array_equal(obs_l, np.asarray(jm.kf_obs_left))
    np.testing.assert_array_equal(obs_r, np.asarray(jm.kf_obs_right))


def kitti_window_solves(d, P, precision):
    """`ba_step` by both packages on the world map `d` (NumPy, by field) of a
    KITTI sequence with projections P, at `precision`: the default config's
    capacities but for the landmark table's size.  Returns both chis, the
    LM iterations and the windows' relative poses apart."""
    from legoslam_tpu.geometry.camera import StereoRig as JStereoRig
    from legoslam_tpu_torch.geometry.camera import StereoRig

    conf = {"max_landmarks": len(d["lm_pos"])}
    jm, jst = j_backend.ba_step(j_frontend.FrontendConfig.from_config(JConfig(conf)),
                                JStereoRig.from_kitti_projections(P[0], P[1], scale=0.5), _jtree(JWorldMap, d),
                                j_backend.BAConfig(assembly_precision=precision))
    m, st = backend.ba_step(frontend.FrontendConfig.from_config(Config(conf)),
                            StereoRig.from_kitti_projections(P[0], P[1], scale=0.5), state.worldmap_from_numpy(d),
                            backend.BAConfig(assembly_precision=precision))
    win = {"kf_valid": d["kf_valid"], "kf_id": d["kf_id"]}
    return {"reference": float(jst.chi), "port": float(st.chi), "iterations": (int(jst.iterations), st.iterations),
            "window_gap": window_gap({**win, "kf_pose": to_numpy(m.kf_pose)}, {**win, "kf_pose": np.asarray(jm.kf_pose)})}


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_kitti_window_ba_matches_reference(precision):
    """ROADMAP C15: on the KITTI soak's frames (scripts/kitti_soak_torch.py
    --frames 460, the default config) the port's window BA chi first leaves
    the reference's own spread at keyframe frame 25.  The reference's map
    just before that BA (its window and the 648 landmarks it sees, written
    by `python -m tests.ba_parity_report --kitti-window <seq> 25 --save`)
    goes through both packages' `ba_step`: chi within KITTI_CHI_RTOL, the
    window relative to its oldest keyframe within 1e-3 (measured 8.6e-5),
    at the default bf16 and at f32.  So window BA, given the same map, is
    not where the two runs part."""
    d, P, frame = load_kitti_window(KITTI_WINDOW)
    assert frame == 25 and len(d["lm_pos"]) == 648 and d["kf_valid"].sum() == 6
    r = kitti_window_solves(d, P, precision)
    assert r["iterations"][0] == r["iterations"][1] == 10
    assert abs(r["port"] - r["reference"]) <= KITTI_CHI_RTOL * r["reference"], r
    assert r["window_gap"] < 1e-3, r


def test_merge_ba_result_on_moved_map(ref):
    """A reference solve written into a map that moved on since its snapshot:
    one window slot evicted and re-filled by a new keyframe, one optimized
    landmark reset.  The port's merge equals the reference's exactly."""
    d = _noisy(ref["maps"]["window"])
    res = j_backend.solve_window(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d))
    moved = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    slot = int(np.nonzero(d["kf_valid"])[0][1])
    moved["kf_id"][slot] = d["next_kf_id"]
    moved["kf_frame_id"][slot] = 99
    moved["next_kf_id"] = d["next_kf_id"] + 1
    lm_reset = int(np.asarray(res.active_ids)[0])
    moved["lm_alive"][lm_reset] = False
    assert np.asarray(res.out_l).any() or np.asarray(res.out_r).any()

    jm = j_backend.merge_ba_result(_jtree(JWorldMap, moved), res)
    port_res = backend.BAResult(
        **{f: t(np.asarray(getattr(res, f))) for f in backend.BAResult._fields if f not in ("stats", "info")},
        stats=None)
    m = backend.merge_ba_result(state.worldmap_from_numpy(moved), port_res)
    for name in ("kf_pose", "lm_pos", "lm_obs", "kf_obs_left", "kf_obs_right", "kf_valid", "kf_id"):
        np.testing.assert_array_equal(to_numpy(getattr(m, name)), np.asarray(getattr(jm, name)), err_msg=name)
    # the re-filled slot and the reset landmark kept their own values
    np.testing.assert_array_equal(to_numpy(m.kf_pose)[slot], moved["kf_pose"][slot])
    np.testing.assert_array_equal(to_numpy(m.lm_pos)[lm_reset], moved["lm_pos"][lm_reset])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["init", "window", "window_prior", "kitti"])
def test_device_select_matches_the_eager_loop_on_windows(ref, case, precision):
    """`solve_window`'s solve, the order tables at the widths it gives them
    (the sums a card takes), with the accept decision on the device
    (`lm.lm_optimize`: `lm.lm_select` in `lm.lm_run`'s loop, the attempt
    the card replays as a CUDA graph) gives the bits of the plain
    host-decided loop (`tests/lm_bits.py` `host_decided_lm`) on the reference's maps
    (the first frame's and the four-keyframe window, perturbed, also with
    a pose prior) and on the KITTI soak's window before frame 25's BA."""
    if case == "kitti":
        from legoslam_tpu_torch.geometry.camera import StereoRig

        d, P, _ = load_kitti_window(KITTI_WINDOW)
        cfg = frontend.FrontendConfig.from_config(Config({"max_landmarks": len(d["lm_pos"])}))
        rig = StereoRig.from_kitti_projections(P[0], P[1], scale=0.5)
    else:
        d = ref["maps"]["init"] if case == "init" else _noisy(ref["maps"]["window"])
        cfg, rig = ref["cfg"], ref["port_rig"]
    p, _ = backend.build_problem(cfg, rig, state.worldmap_from_numpy(d))
    KW, NF = cfg.caps.window, cfg.caps.max_features
    order = schur.build_order(p.graph, KW, p.points.shape[0], widths=(2 * NF, 2 * KW, 2))
    prior = lm.ba_prior(pose_prior(p.poses, 5)) if case == "window_prior" else None
    lm_cfg = lm.LMConfig(assembly_precision=precision)
    fns = lm.ba_functions(p.graph, order, prior, robust.HUBER, 5.991, lm_cfg)
    host, device = lm_both_ways(fns, lm.BAState(p.poses, p.points), lm_cfg)
    assert_same_lm_bits(host, device)
    assert host.iterations >= 1
