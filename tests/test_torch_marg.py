"""The marginalization prior of the port against the JAX reference:
`solver/marginalization.py`, `lm.solve_ba(pose_prior=...)`, the prior in
`backend.solve_window` / `merge_ba_result`, `frontend._evict_if_full`, and
`use_marg_prior` through the driver.

`eigh` is not unique (eigenvector signs, the basis inside a repeated
eigenvalue), so `sqrt_J` and `err` are never compared entry by entry: the
comparisons are on H = J^T J, b, J^T err (= -b on the kept range) and the
effect on a solve, each relative to the largest entry of H (or b).  Unit
inputs are well conditioned (eigenvalues far above eps = 1e-8), with one
case of exactly-zero rows, which is what a stale window slot produces.

The maps come from one reference run: the 14-frame test corridor with a
window of 4 active keyframes in 5 slots and a keyframe on every frame
(tests/test_marg_prior.py's eviction scenario), `use_marg_prior` on, window
BA inline at `ba_assembly_precision: f32`; its carry is copied after frame 0
(the init map), frame 3 (the window full, information stored, no prior yet)
and frame 5 (a prior in use).  The window's gauge is free until the first
eviction and only partly held after it, so the `VisualOdometry` runs are compared by
statuses, keyframe flags, `prior_kf_id` (exactly), the prior's H and the
rigidly aligned trajectories.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from legoslam_tpu.pipeline import backend as j_backend
from legoslam_tpu.pipeline import frontend as j_frontend
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.state import WorldMap as JWorldMap
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu.solver import marginalization as j_marg
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.pipeline import backend, frontend, state
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam_tpu_torch.solver import lm, marginalization
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_backend import _jtree
from tests.test_torch_vo import N_FRAMES, OVERRIDES, _dataset
from tests.torch_parity import j, t, to_numpy, tree_to_numpy

TINY = {**OVERRIDES, "keyframe_window_capacity": 5, "num_active_keyframes": 4, "max_keyframe_gap": 1,
        "use_marg_prior": True}


def _rel(port, ref, rel, name=""):
    """|port - ref| <= rel * the largest |ref| entry."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    np.testing.assert_allclose(port, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=name)


def _system(seed, n=30, zero_rows=()):
    """A well-conditioned SPD information matrix (eigenvalues in [1, 40]),
    its vector, and a mask of 6 coordinates to marginalize."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    H = (Q * rng.uniform(1.0, 40.0, n)) @ Q.T
    b = rng.normal(size=n)
    keep = np.ones(n)
    keep[list(zero_rows)] = 0.0
    H, b = H * keep[:, None] * keep[None, :], b * keep
    mask = np.zeros(n, bool)
    mask[12:18] = True
    return H.astype(np.float32), b.astype(np.float32), mask


@pytest.mark.parametrize("zero_rows", [(), (24, 25, 26, 27, 28, 29)])
def test_marginalize(zero_rows):
    H, b, mask = _system(0, zero_rows=zero_rows)
    f = marginalization.marginalize(t(H), t(b), t(mask), 6)
    r = j_marg.marginalize(j(H), j(b), j(mask), 6)
    # direct elimination in float64
    H64, b64 = H.astype(np.float64), b.astype(np.float64)
    k, m = ~mask, mask
    Amm_inv = np.linalg.inv(H64[np.ix_(m, m)])
    H_keep = H64[np.ix_(k, k)] - H64[np.ix_(k, m)] @ Amm_inv @ H64[np.ix_(m, k)]
    b_keep = b64[k] - H64[np.ix_(k, m)] @ Amm_inv @ b64[m]
    fH, fb, fJ, ferr = (to_numpy(x).astype(np.float64) for x in f)
    _rel(fH[np.ix_(k, k)], H_keep, 1e-5, "H vs elimination")
    _rel(fb[k], b_keep, 1e-5, "b vs elimination")
    _rel(fJ.T @ fJ, fH, 1e-5, "J^T J")
    _rel((fJ.T @ ferr)[k], -b_keep, 1e-4, "J^T err = -b")
    # zero rows and columns at the marginalized (and the empty) coordinates
    dead = mask.copy()
    dead[list(zero_rows)] = True
    assert not fH[dead].any() and not fH[:, dead].any() and not fb[dead].any()
    assert not fJ[:, dead].any() and not ferr[mask].any()
    # against the reference
    rH, rb, rJ, rerr = (np.asarray(x, np.float64) for x in r)
    _rel(fH, rH, 1e-5, "H")
    _rel(fb, rb, 1e-5, "b")
    _rel(fJ.T @ ferr, rJ.T @ rerr, 1e-4, "J^T err")
    np.testing.assert_allclose(float(ferr @ ferr), float(rerr @ rerr), rtol=1e-3)


def test_prior_effect_on_a_solve():
    """Solving the kept block with the prior applied gives the kept part of
    the joint solve, `apply_prior` zeroes fixed coordinates and
    `update_prior_b` follows a state change to first order."""
    H, b, mask = _system(1)
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.normal(size=(30, 30)))
    H2 = ((Q * rng.uniform(1.0, 10.0, 30)) @ Q.T).astype(np.float32)
    H2[mask], H2[:, mask] = 0.0, 0.0     # the new problem does not see the marginalized block
    b2 = (rng.normal(size=30) * ~mask).astype(np.float32)
    f = marginalization.marginalize(t(H), t(b), t(mask), 6)
    r = j_marg.marginalize(j(H), j(b), j(mask), 6)
    Hn, bn = to_numpy(marginalization.apply_prior(t(H2), t(b2), f))
    Hr, br = (np.asarray(x) for x in j_marg.apply_prior(j(H2), j(b2), r))
    _rel(Hn, Hr, 1e-5, "apply_prior H")
    _rel(bn, br, 1e-5, "apply_prior b")
    k = ~mask
    x = np.linalg.solve(Hn[np.ix_(k, k)].astype(np.float64), bn[k].astype(np.float64))
    joint = np.linalg.solve((H + H2).astype(np.float64), (b + b2).astype(np.float64))
    _rel(x, joint[k], 1e-4, "kept solve vs joint solve")
    fixed = np.zeros(30, bool)
    fixed[:6] = True
    Hf, bf = to_numpy(marginalization.apply_prior(t(H2), t(b2), f, fixed_mask=t(fixed)))
    Hfr, bfr = (np.asarray(x) for x in j_marg.apply_prior(j(H2), j(b2), r, fixed_mask=j(fixed)))
    _rel(Hf, Hfr, 1e-5, "apply_prior fixed H")
    _rel(bf, bfr, 1e-5, "apply_prior fixed b")
    np.testing.assert_array_equal(Hf[fixed], H2[fixed])
    dx = (rng.normal(size=30) * 0.01).astype(np.float32)
    _rel(to_numpy(marginalization.update_prior_b(f, t(dx)).b), np.asarray(j_marg.update_prior_b(r, j(dx)).b),
         1e-5, "update_prior_b")


# --- maps from the reference's tiny-window run --------------------------------

@pytest.fixture(scope="module")
def ref():
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig({**TINY, "ba_assembly_precision": "f32"}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    carries = {}
    for k in range(N_FRAMES):
        assert vo.step()
        if k in (0, 3, 5):
            carries[k] = tree_to_numpy(vo.carry)
    return {
        "carries": carries,
        "final_marg": tree_to_numpy(vo.carry.wmap.marg),
        "statuses": vo.statuses(),
        "kf": np.asarray([bool(o.kf_inserted) for o in vo.outputs]),
        "T_wc": vo.trajectory_T_wc(),
        "gt_T_wc": ds.gt_T_wc,
        "rig": ds.rig,
        "port_rig": state.rig_from_numpy(tree_to_numpy(ds.rig)),
        "jcfg": j_frontend.FrontendConfig.from_config(JConfig(TINY)),
        "cfg": frontend.FrontendConfig.from_config(Config(TINY)),
    }


def test_config_and_state_carry_the_prior(ref):
    assert ref["cfg"].use_marg_prior and ref["cfg"].marg_prior_weight == ref["jcfg"].marg_prior_weight == 0.5
    d = ref["carries"][5]["wmap"]
    assert (d["marg"]["prior_kf_id"] >= 0).any() and np.abs(d["marg"]["prior_J"]).max() > 0
    wmap = state.worldmap_from_numpy(d)
    for name, value in d["marg"].items():
        np.testing.assert_array_equal(to_numpy(getattr(wmap.marg, name)), value, err_msg=name)
        assert getattr(wmap.marg, name).dtype == (torch.int32 if name.endswith("kf_id") else torch.float32)


def test_pose_prior_anchors_solution(ref):
    """tests/test_marg_prior.py::test_pose_prior_anchors_solution on the port,
    with chi parity: a strong prior pinning the (otherwise gauge-free) init
    keyframe at a shifted pose pulls the solve there; without it the solve
    stays at the origin."""
    d = ref["carries"][0]["wmap"]
    jp, _ = j_backend.build_problem(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d))
    p, _ = backend.build_problem(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d))
    K = p.poses.shape[0]
    T_lin = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T_lin[0, 0, 3] = 0.5                       # the prior wants keyframe 0 at x = +0.5
    prior_J = np.zeros((K * 6, K * 6), np.float32)
    prior_J[np.arange(6), np.arange(6)] = 1e4  # huge information on slot 0 only
    err0 = np.zeros((K * 6,), np.float32)
    st, res = lm.solve_ba(p.graph, p.poses, p.points, pose_prior=(t(prior_J), t(err0), t(T_lin)))
    jst, jres = j_lm.solve_ba(jp.graph, jp.poses, jp.points, cfg=j_lm.LMConfig(iterations=10),
                              pose_prior=(j(prior_J), j(err0), j(T_lin)))
    assert abs(float(st.poses[0, 0, 3]) - 0.5) < 2e-2
    assert abs(float(jst.poses[0, 0, 3]) - 0.5) < 2e-2
    np.testing.assert_allclose(float(res.chi), float(jres.chi), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(to_numpy(st.poses)[0], np.asarray(jst.poses)[0], atol=1e-3)
    st0, _ = lm.solve_ba(p.graph, p.poses, p.points)
    assert abs(float(st0.poses[0, 0, 3])) < 1e-3
    # both engine names take the prior (the port has one engine)
    st_b, _ = lm.solve_ba(p.graph, p.poses, p.points, engine="blocks", pose_prior=(t(prior_J), t(err0), t(T_lin)))
    assert torch.equal(st_b.poses, st.poses)


def _prior_H(marg):
    J = np.asarray(marg["prior_J"], np.float64)
    return J.T @ J


def test_evict_if_full_builds_the_prior(ref):
    """The full window after frame 3 (information stored by its BA, no prior
    yet) through `_evict_if_full` in both packages."""
    d = ref["carries"][3]
    assert d["wmap"]["kf_valid"].sum() == 4 and (d["wmap"]["marg"]["info_kf_id"] >= 0).sum() == 4
    assert (d["wmap"]["marg"]["prior_kf_id"] < 0).all()
    jw = j_frontend._evict_if_full(ref["jcfg"], _jtree(JWorldMap, d["wmap"]), jnp.asarray(d["T_cur"]))
    w = frontend._evict_if_full(ref["cfg"], state.worldmap_from_numpy(d["wmap"]), t(d["T_cur"]))
    for name in ("kf_valid", "kf_id", "kf_frame_id", "lm_obs", "kf_obs_left", "kf_obs_right", "kf_lm"):
        np.testing.assert_array_equal(to_numpy(getattr(w, name)), np.asarray(getattr(jw, name)), err_msg=name)
    assert to_numpy(w.kf_valid).sum() == 3
    mg, jmg = tree_to_numpy_marg(w.marg), tree_to_numpy(jw.marg)
    np.testing.assert_array_equal(mg["prior_kf_id"], jmg["prior_kf_id"])
    assert (mg["prior_kf_id"] >= 0).sum() == 3
    np.testing.assert_array_equal(mg["prior_T"], jmg["prior_T"])
    _rel(_prior_H(mg), _prior_H(jmg), 1e-3, "prior H")
    Jt_err = lambda m: np.asarray(m["prior_J"], np.float64).T @ np.asarray(m["prior_err"], np.float64)  # noqa: E731
    _rel(Jt_err(mg), Jt_err(jmg), 1e-3, "prior J^T err")
    # rows of the evicted and the empty slot carry nothing
    gone = np.repeat(mg["prior_kf_id"] < 0, 6)
    assert not _prior_H(mg)[gone].any()
    # a window that is not full passes through, prior and all
    d0 = ref["carries"][0]
    w0 = frontend._evict_if_full(ref["cfg"], state.worldmap_from_numpy(d0["wmap"]), t(d0["T_cur"]))
    for name, value in d0["wmap"]["marg"].items():
        np.testing.assert_array_equal(to_numpy(getattr(w0.marg, name)), value, err_msg=name)
    assert to_numpy(w0.kf_valid).sum() == 1


def tree_to_numpy_marg(marg):
    return {k: to_numpy(v) for k, v in vars(marg).items()}


def test_solve_window_info_with_prior(ref):
    """The map after frame 5 (a prior in use) through `solve_window` and
    `merge_ba_result`: chi, the information handed to the next eviction."""
    d = ref["carries"][5]["wmap"]
    jres = j_backend.solve_window(ref["jcfg"], ref["rig"], _jtree(JWorldMap, d),
                                  j_backend.BAConfig(assembly_precision="f32"))
    res = backend.solve_window(ref["cfg"], ref["port_rig"], state.worldmap_from_numpy(d))
    np.testing.assert_allclose(float(res.stats.chi), float(jres.stats.chi), rtol=1e-2)
    S, b, T, kf_id = res.info
    jS, jb, jT, jkf_id = jres.info
    np.testing.assert_array_equal(to_numpy(kf_id), np.asarray(jkf_id))
    # Each package evaluates the information at its own optimum, 10 LM
    # iterations from the same map: S within 5% of its largest entry
    # (measured 1.8%), b within 5%.
    _rel(to_numpy(S), jS, 5e-2, "info S")
    _rel(to_numpy(b), jb, 5e-2, "info b")
    assert torch.equal(T, res.poses)
    m = backend.merge_ba_result(state.worldmap_from_numpy(d), res)
    assert torch.equal(m.marg.info_S, S) and torch.equal(m.marg.info_b, b)
    assert torch.equal(m.marg.info_T, T) and torch.equal(m.marg.info_kf_id, kf_id)
    assert torch.equal(m.marg.prior_J, t(d["marg"]["prior_J"]))
    # prior off: no information is computed, the map's stays as it was
    off = ref["cfg"]._replace(use_marg_prior=False)
    res_off = backend.solve_window(off, ref["port_rig"], state.worldmap_from_numpy(d))
    assert res_off.info is None
    m_off = backend.merge_ba_result(state.worldmap_from_numpy(d), res_off)
    assert torch.equal(m_off.marg.info_S, t(d["marg"]["info_S"]))


def test_tiny_window_run_matches_reference(ref):
    vo = VisualOdometry(config=Config(TINY), dataset=_dataset(TDataset), device="cpu")
    assert vo.init()
    vo.run()
    np.testing.assert_array_equal(vo.statuses(), ref["statuses"])
    np.testing.assert_array_equal(vo.keyframe_flags(), ref["kf"])
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all() and vo.keyframe_flags().all()
    mg, jmg = tree_to_numpy_marg(vo.carry.wmap.marg), ref["final_marg"]
    np.testing.assert_array_equal(mg["prior_kf_id"], jmg["prior_kf_id"])
    np.testing.assert_array_equal(mg["info_kf_id"], jmg["info_kf_id"])
    assert (mg["prior_kf_id"] >= 0).sum() == 3 and np.abs(mg["prior_J"]).max() > 0
    # Ten evictions on, each prior built from the run's own BA optimum:
    # within 10% of the largest entry (measured 5.5%).
    _rel(_prior_H(mg), _prior_H(jmg), 0.1, "final prior H")
    T_wc = vo.trajectory_T_wc()
    assert evaluation.ate_rmse(T_wc[:, :3, 3], ref["T_wc"][:, :3, 3]) < 5e-2  # rigidly aligned
    gt = ref["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert evaluation.ate_rmse(ref["T_wc"][:, :3, 3], gt) < 0.15
