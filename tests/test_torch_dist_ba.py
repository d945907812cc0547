"""The port's distributed BA (`parallel/dist_ba.py` over torch.distributed)
against its single-process solve and the JAX reference's, on the CPU.

The ranks run in processes of their own over gloo (tests/dist_ba_ranks.py),
started in a subprocess with a timeout, so that a rank that hangs fails its
test instead of the suite.  At world size 2 and 4 the problem of
tests/test_dist_ba.py (60 points, 5 poses, pose 0 fixed, noisy start) is
solved with 8 LM iterations and compared with the port's `lm.solve_ba` and
the reference's at that file's tolerances: chi within 1e-3 relative, poses
within 1e-3, points within 5e-3.  Every rank must hold the same bits (the LM
control flow runs replicated on all-reduced values).  `backend.ba_step`
with the sharded solve plugged into its seam (`solve_fn`) is held against
the single solve of the same window map (tests/test_torch_backend.py's,
four keyframes) at the same tolerances.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.geometry import se3 as j_se3
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from legoslam_tpu_torch.pipeline import backend, state
from legoslam_tpu_torch.solver import lm, schur
from tests import test_torch_backend as tb
from tests.dist_ba_ranks import load_problem
from tests.test_lm_solver import _build_graph, make_scene, project_all
from tests.torch_parity import to_numpy

TIMEOUT = 240  # seconds for one subprocess of ranks
ITERATIONS = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flatten(d, prefix):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """tests/test_dist_ba.py's problem as the reference makes it, the window
    map, and the path of both as one file for the ranks."""
    rng = np.random.default_rng(0)
    pts, poses, exts = make_scene(rng, n_points=60, n_poses=5)
    uv, ok = project_all(pts, poses, exts)
    meas = uv + rng.normal(scale=0.2, size=uv.shape).astype(np.float32)
    jgraph = _build_graph(pts, poses, exts, uv, ok, meas)
    poses0 = poses.copy()
    for k in range(1, len(poses)):
        d = rng.normal(scale=0.02, size=6).astype(np.float32)
        poses0[k] = np.asarray(j_se3.retract(jnp.asarray(poses[k]), jnp.asarray(d)))
    pts0 = (pts + rng.normal(scale=0.2, size=pts.shape)).astype(np.float32)
    maps = tb.reference_maps()
    graph = {k: np.asarray(getattr(jgraph, k)) for k in schur.BAGraph._fields if k != "intr"}
    graph["intr"] = np.asarray([float(v) for v in jgraph.intr], np.float32)
    path = str(tmp_path_factory.mktemp("dist") / "problem.npz")
    np.savez(path, poses0=poses0, points0=pts0, lm_cfg=json.dumps({"iterations": ITERATIONS}),
             vo_config=json.dumps(tb.CONFIG), **_flatten(graph, "graph/"), **_flatten(maps["maps"]["window"], "wmap/"))
    return {"path": path, "jgraph": jgraph, "maps": maps}


def _ranks(problem, world, tmp_path):
    out = str(tmp_path / f"out{world}.npz")
    proc = subprocess.run([sys.executable, "-m", "tests.dist_ba_ranks", problem["path"], out, str(world)],
                          cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("world", [2, 4])
def test_dist_matches_single_and_reference(problem, world, tmp_path):
    graph, poses0, pts0, cfg, _ = load_problem(problem["path"])
    r = _ranks(problem, world, tmp_path)
    # every rank holds the same result
    assert (r["every"] == r["every"][0]).all()
    st, res = lm.solve_ba(graph, poses0, pts0, cfg=cfg)
    jst, jres = j_lm.solve_ba(problem["jgraph"], jnp.asarray(poses0.numpy()), jnp.asarray(pts0.numpy()),
                              cfg=j_lm.LMConfig(iterations=ITERATIONS))
    for poses, points, chi in ((to_numpy(st.poses), to_numpy(st.points), float(res.chi)),
                               (np.asarray(jst.poses), np.asarray(jst.points), float(jres.chi))):
        np.testing.assert_allclose(float(r["chi"]), chi, rtol=1e-3)
        np.testing.assert_allclose(r["poses"], poses, atol=1e-3)
        np.testing.assert_allclose(r["points"], points, atol=5e-3)
    assert 1 <= int(r["iterations"]) <= int(r["attempts"])
    # the reference's convergence bar (tests/test_dist_ba.py:45-56)
    chi0 = float(schur.robust_chi(graph, poses0, pts0, "huber", 5.991))
    assert float(r["chi"]) < 0.05 * chi0
    # the seam: ba_step with the sharded solve against the single solve
    cfg_vo, rig = problem["maps"]["cfg"], problem["maps"]["port_rig"]
    m, stats = backend.ba_step(cfg_vo, rig, state.worldmap_from_numpy(problem["maps"]["maps"]["window"]))
    np.testing.assert_allclose(float(r["ba_chi"]), float(stats.chi), rtol=1e-3)
    np.testing.assert_allclose(r["ba_kf_pose"], to_numpy(m.kf_pose), atol=1e-3)
    alive = to_numpy(m.lm_alive)
    np.testing.assert_allclose(r["ba_lm_pos"][alive], to_numpy(m.lm_pos)[alive], atol=5e-3)
    assert int(r["ba_n_inlier"]) > 0
    assert (r["ba_obs_left"] == to_numpy(m.kf_obs_left)).mean() >= 0.99


def test_pads():
    g = schur.BAGraph(e_pose=torch.zeros(5, dtype=torch.int32), e_point=torch.arange(5, dtype=torch.int32),
                      e_cam=torch.zeros(5, dtype=torch.int32), e_uv=torch.ones(5, 2),
                      e_valid=torch.ones(5, dtype=torch.bool), exts=torch.eye(4)[None], intr=None,
                      pose_fixed=torch.zeros(2, dtype=torch.bool), point_valid=torch.ones(5, dtype=torch.bool))
    p = dist_ba._pad_edges(g, 4)
    assert p.e_pose.shape == (8,) and not p.e_valid[5:].any() and p.e_valid[:5].all() and p.e_uv.shape == (8, 2)
    assert dist_ba._pad_edges(g, 5) is g
    g2, pts, L = dist_ba._pad_points(g, torch.ones(5, 3), 4)
    assert L == 5 and pts.shape == (8, 3) and not pts[5:].any()
    assert g2.point_valid.tolist() == [True] * 5 + [False] * 3


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_mesh()
    m = mesh_mod.Mesh(rank=0, world_size=4, device=torch.device("cpu"))
    assert m.shape == {"ba": 4} and mesh_mod.BA_AXIS == "ba"


def test_ba_step_refuses_the_prior_with_a_solve_fn():
    """As the reference: the marginalization prior needs the single-device
    solver."""
    cfg = tb.frontend.FrontendConfig.from_config(tb.Config({**tb.CONFIG, "use_marg_prior": True}))
    with pytest.raises(ValueError, match="use_marg_prior"):
        backend.solve_window(cfg, None, None, solve_fn=lambda *a: None)
