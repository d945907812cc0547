"""The port's BA engine (solver/schur.py, pcg.py, the BA half of lm.py)
against the JAX reference's two engines on the same NumPy inputs.

The graph is tests/test_edge_soa.py's random problem (5 poses, pose 0 fixed,
60 landmarks seen 4 times each, 5% gross outliers, landmarks masked by edge
and by slot) with one non-finite point on a masked slot.  Bars: blocks and
chi within 1e-4 of each array's largest entry (sums in another order: the
port's `index_add_` against the reference's one-hot contractions); the
Schur system and its solution within 1e-3 of their largest entry (a
Cholesky or CG solve in float32 amplifies that rounding by the condition
number).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.solver import edge_soa
from legoslam_tpu.solver import reprojection as j_reproj
from legoslam_tpu.solver import robust as j_robust
from legoslam_tpu.solver import schur as j_schur
from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import lm, reprojection, robust, schur
from tests.test_edge_soa import random_graph
from tests.torch_parity import j, t, to_numpy

DELTA = 5.991


@pytest.fixture(scope="module")
def problem():
    """(reference graph, poses, points, port graph), NumPy-made, point 1 NaN."""
    graph, poses, points = random_graph(np.random.default_rng(7))
    points = np.array(points)
    assert not bool(graph.point_valid[1])
    points[1] = np.nan
    port = schur.BAGraph(
        e_pose=t(graph.e_pose), e_point=t(graph.e_point), e_cam=t(graph.e_cam), e_uv=t(graph.e_uv),
        e_valid=t(graph.e_valid), exts=t(graph.exts),
        intr=reprojection.Intrinsics(*(float(np.asarray(v)) for v in graph.intr)),
        pose_fixed=t(graph.pose_fixed), point_valid=t(graph.point_valid),
    )
    return graph, np.array(poses), points, port


def _close(port, ref, rel, name=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    np.testing.assert_allclose(port, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()), err_msg=name)


def test_projection_edge():
    rng = np.random.default_rng(3)
    n = 64
    xi = np.concatenate([rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.1, (n, 3))], -1).astype(np.float32)
    T = se3.se3_exp(t(xi)).numpy()
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ext[::2, 0, 3] = -0.54
    pw = rng.uniform([-4, -2, 4], [4, 2, 30], (n, 3)).astype(np.float32)
    uv = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    intr = (300.0, 310.0, 160.0, 120.0)
    ref = j_reproj.projection_edge(j_reproj.Intrinsics(*map(jnp.float32, intr)), j(T), j(ext), j(pw), j(uv))
    port = reprojection.projection_edge(reprojection.Intrinsics(*intr), t(T), t(ext), t(pw), t(uv))
    for a, b, name in zip(to_numpy(port), to_numpy(ref), ("r", "J_pose", "J_point")):
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("kernel", [j_robust.HUBER, j_robust.TRIVIAL])
def test_build_blocks(problem, kernel):
    graph, poses, points, port_graph = problem
    assert kernel == getattr(robust, kernel.upper())
    gs = edge_soa.make_soa_graph(graph)
    ref_soa, ref_chi = edge_soa.soa_build(gs, j(poses), j(points), kernel, DELTA, with_chi=True)
    ref_soa = edge_soa.to_bablocks(ref_soa)
    ref_blk = j_schur.build_blocks(graph, j(poses), j(points), kernel, DELTA)
    blocks, chi = schur.build_blocks(port_graph, t(poses), t(points), kernel, DELTA, with_chi=True)
    assert torch.isfinite(chi) and all(torch.isfinite(b).all() for b in blocks)
    for name in schur.BABlocks._fields:
        got = to_numpy(getattr(blocks, name))
        _close(got, np.asarray(getattr(ref_soa, name)), 1e-4, name)
        _close(got, np.asarray(getattr(ref_blk, name)), 1e-4, name)
    np.testing.assert_allclose(float(chi), float(ref_chi), rtol=1e-4)
    np.testing.assert_allclose(float(schur.robust_chi(port_graph, t(poses), t(points), kernel, DELTA)),
                               float(ref_chi), rtol=1e-4)
    # without the fused chi, the same blocks
    again = schur.build_blocks(port_graph, t(poses), t(points), kernel, DELTA)
    assert all(torch.equal(a, b) for a, b in zip(again, blocks))
    # the outlier sweep takes the raw points: NaN exactly where the reference has it
    chis = to_numpy(schur.edge_chi2(port_graph, t(poses), t(points), kernel, DELTA))
    ref_chis = np.asarray(edge_soa.soa_edge_chi2(edge_soa.make_soa_graph(graph, assembly=False),
                                                 j(poses), j(points), kernel, DELTA))
    np.testing.assert_array_equal(np.isnan(chis), np.isnan(ref_chis))
    assert np.isnan(chis).any()
    fin = ~np.isnan(ref_chis)
    np.testing.assert_allclose(chis[fin], ref_chis[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["cholesky", "pcg"])
@pytest.mark.parametrize("strategy", ["default", "strategy1"])
def test_schur_solve(problem, method, strategy):
    """schur_reduce + damp_and_solve + back_substitute on the reference's blocks."""
    graph, poses, points, port_graph = problem
    ref_soa = edge_soa.soa_build(edge_soa.make_soa_graph(graph), j(poses), j(points), j_robust.HUBER, DELTA)
    ref_blocks = edge_soa.to_bablocks(ref_soa)
    lam = 1e-3 * float(np.abs(np.asarray(edge_soa.soa_blocks_diag(ref_soa))).max())
    S_r, bs_r, inv_r = edge_soa.soa_schur_reduce(ref_soa, graph.point_valid, jnp.float32(lam), strategy)
    dxp_r = j_schur.damp_and_solve(S_r, bs_r, jnp.float32(lam), strategy, method=method)
    dxl_r = edge_soa.soa_back_substitute(ref_soa, inv_r, dxp_r)

    blocks = schur.BABlocks(*(t(np.asarray(getattr(ref_blocks, f))) for f in schur.BABlocks._fields))
    lam_t = torch.tensor(lam, dtype=torch.float32)
    S, bs, inv = schur.schur_reduce(blocks, port_graph.point_valid, lam_t, strategy)
    dxp = schur.damp_and_solve(S, bs, lam_t, strategy, method=method)
    dxl = schur.back_substitute(blocks, inv, dxp)
    _close(to_numpy(S), np.asarray(S_r), 1e-3, "S")
    _close(to_numpy(bs), np.asarray(bs_r), 1e-3, "bs")
    _close(to_numpy(inv).reshape(-1, 9).T, np.asarray(inv_r), 1e-3, "Hll_inv")
    _close(to_numpy(dxp), np.asarray(dxp_r), 1e-3, "dx_pose")
    _close(to_numpy(dxl), np.asarray(dxl_r), 1e-3, "dx_landmark")
    assert np.abs(to_numpy(dxp)[:6]).max() == 0.0  # pose 0 is fixed


def test_non_pd_cholesky_gives_nan_step():
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]])  # eigenvalues 3 and -1
    dx = schur.damp_and_solve(S, torch.tensor([1.0, 0.5]), torch.tensor(0.5))
    assert torch.isnan(dx).all()
    assert torch.isfinite(schur.damp_and_solve(S, torch.tensor([1.0, 0.5]), torch.tensor(1.5))).all()


def test_lm_rejects_non_pd_step():
    """A model Hessian that is indefinite at small lambda: the NaN step is
    rejected, lambda grows until the damped system is positive definite,
    and the solve ends at the minimum instead of raising."""
    A = torch.tensor([[2.0, 0.0], [0.0, 1.0]])
    y = torch.tensor([1.0, -2.0])

    def residual(x):
        return A @ x - y

    def build(x):
        # The true Gauss-Newton Hessian A^T A, less 3 I: indefinite below lambda = 3.
        return A.T @ A - 3.0 * torch.eye(2), -A.T @ residual(x)

    fns = lm.LMFunctions(
        build=build, chi=lambda x: 0.5 * residual(x).square().sum(),
        solve=lambda aux, lam: schur.damp_and_solve(aux[0], aux[1], lam),
        retract=lambda x, dx: x + torch.where(torch.isfinite(dx), dx, 0.0),
        dot_scale=lambda aux, dx, lam: 0.5 * torch.dot(dx, lam * dx + aux[1]),
        max_diag=lambda aux: aux[0].diagonal().abs().max(),
    )
    res = lm.lm_optimize(fns, torch.zeros(2), lm.LMConfig(iterations=20, init_lambda=0.5))
    assert res.attempts > res.iterations  # the NaN steps were tried and rejected
    assert float(res.chi) < 1e-6
    np.testing.assert_allclose(res.state.numpy(), [0.5, -2.0], atol=1e-3)


def test_unknown_engine_raises(problem):
    graph, poses, points, port_graph = problem
    with pytest.raises(ValueError, match="lm_engine"):
        lm.solve_ba(port_graph, t(poses), t(points), engine="dense")
