"""Window BA's assembly precision (`ba_assembly_precision`) in the port
against the JAX reference.

The reference's default, "bf16", runs the cross-block contraction on the
TPU's matrix unit in one bfloat16 pass with float32 accumulation
(legoslam_tpu/solver/edge_soa.py:265-296): each edge's 18 pose-landmark
terms are rounded to bfloat16 and summed in float32.  The port rounds the
same per-edge terms with one cast pair before its sums
(`schur.build_blocks(..., assembly_precision="bf16")`).  Everything else
stays float32 in both: the pose and landmark blocks, the gradient, chi, the
"blocks" engine, the marginalization information and the distributed solve.

The graph is tests/test_edge_soa.py's random problem (5 poses, pose 0
fixed, 60 landmarks seen 4 times each, 5% gross outliers).  Bars: the bf16
cross blocks within 1e-4 of their largest entry of the reference's, the
bar of the f32 blocks in tests/test_torch_schur.py, where rounding to
bfloat16 moves them by 2e-3; the other blocks and chi bit-equal to the
port's own f32 build; one 10-iteration `solve_ba` at bf16 within 1e-3
relative in chi, 1e-3 in the poses and 1e-2 m in the points of the
reference's; and the twin of tests/test_edge_soa.py's
`test_bf16_assembly_reaches_f32_optimum` at its bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from legoslam_tpu.solver import edge_soa
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu.solver import robust as j_robust
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from legoslam_tpu_torch.pipeline import backend, frontend
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.solver import lm, schur
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_schur import DELTA, problem  # noqa: F401  (the module fixture)
from tests.test_torch_vo import OVERRIDES, _dataset
from tests.torch_parity import j, t, to_numpy


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaN where the other is NaN (the problem's point 1 is NaN)."""
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_defaults_follow_the_reference():
    """bf16 in the config, f32 in the solver's and the backend's own
    configs: the reference's two defaults (ROADMAP C3)."""
    assert Config()["ba_assembly_precision"] == JConfig()["ba_assembly_precision"] == "bf16"
    assert backend.BAConfig().assembly_precision == lm.LMConfig().assembly_precision == "f32"
    assert j_lm.LMConfig().assembly_precision == "f32"


@pytest.mark.parametrize("kernel", [j_robust.HUBER, j_robust.TRIVIAL])
def test_bf16_blocks_match_reference(problem, kernel):  # noqa: F811
    graph, poses, points, g = problem
    gs = edge_soa.make_soa_graph(graph)
    ref16, ref_chi = edge_soa.soa_build(gs, j(poses), j(points), kernel, DELTA, with_chi=True,
                                        assembly_dtype=jnp.bfloat16)
    ref16 = edge_soa.to_bablocks(ref16)
    ref32 = edge_soa.to_bablocks(edge_soa.soa_build(gs, j(poses), j(points), kernel, DELTA))
    b16, chi16 = schur.build_blocks(g, t(poses), t(points), kernel, DELTA, with_chi=True, assembly_precision="bf16")
    b32, chi32 = schur.build_blocks(g, t(poses), t(points), kernel, DELTA, with_chi=True)
    gap = _rel_gap(to_numpy(b16.Hpl), np.asarray(ref16.Hpl))
    assert gap <= 1e-4, gap
    # the rounding is real: f32 and bf16 cross blocks part by far more than the bar
    assert _rel_gap(to_numpy(b32.Hpl), np.asarray(ref16.Hpl)) > 1e-3
    assert _rel_gap(np.asarray(ref32.Hpl), np.asarray(ref16.Hpl)) > 1e-3
    # only the cross terms are rounded: the rest is the f32 build's, bit for bit
    for name in ("Hpp", "Hll", "bp", "bl"):
        assert torch.equal(getattr(b16, name), getattr(b32, name)), name
    assert torch.equal(chi16, chi32)
    np.testing.assert_allclose(float(chi16), float(ref_chi), rtol=1e-4)
    # one edge's cross term, summed alone, is a bfloat16 value
    free = schur.edge_mask(g) & ~g.pose_fixed[g.e_pose]
    one = torch.arange(len(free)) == int(torch.nonzero(free)[0])
    terms = schur.build_blocks(g._replace(e_valid=one), t(poses), t(points), kernel, DELTA,
                               assembly_precision="bf16").Hpl
    assert torch.equal(terms, terms.to(torch.bfloat16).float()) and terms.abs().max() > 0


def test_fixed_order_sums_round_the_same_terms(problem):  # noqa: F811
    """The card's padded sums at bf16 against `index_add_` at bf16."""
    _, poses, points, g = problem
    P, X = t(poses), t(points)
    padded = schur.build_blocks(g, P, X, "huber", DELTA, order=schur.build_order(g, P.shape[0], X.shape[0]),
                                assembly_precision="bf16")
    scattered = schur.build_blocks(g, P, X, "huber", DELTA, assembly_precision="bf16")
    for name in schur.BABlocks._fields:
        a, b = to_numpy(getattr(padded, name)), to_numpy(getattr(scattered, name))
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max()), name


@pytest.mark.parametrize("value", ["f32", "fp16", "BF16", ""])
def test_any_other_value_is_f32(problem, value):  # noqa: F811
    """Only "bf16" rounds, as `lm.py:313` of the reference reads the key."""
    _, poses, points, g = problem
    a = schur.build_blocks(g, t(poses), t(points), "huber", DELTA, assembly_precision=value)
    b = schur.build_blocks(g, t(poses), t(points), "huber", DELTA)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_solve_ba_bf16_matches_reference(problem):  # noqa: F811
    graph, poses, points, g = problem
    cfg = dict(iterations=10, assembly_precision="bf16")
    jst, jres = j_lm.solve_ba(graph, j(poses), j(points), cfg=j_lm.LMConfig(**cfg))
    st, res = lm.solve_ba(g, t(poses), t(points), cfg=lm.LMConfig(**cfg))
    np.testing.assert_allclose(float(res.chi), float(jres.chi), rtol=1e-3)
    np.testing.assert_allclose(to_numpy(st.poses), np.asarray(jst.poses), rtol=0, atol=1e-3)
    pv = to_numpy(g.point_valid)
    np.testing.assert_allclose(to_numpy(st.points)[pv], np.asarray(jst.points)[pv], rtol=0, atol=1e-2)
    # the precision reached the assembly: the f32 solve takes other steps
    st32, _ = lm.solve_ba(g, t(poses), t(points), cfg=lm.LMConfig(iterations=10))
    assert not _same(st.points, st32.points)


def test_bf16_assembly_reaches_f32_optimum(problem):  # noqa: F811
    """The port's twin of tests/test_edge_soa.py's A/B gate for the default:
    bf16 perturbs only the model Hessian, so the LM loop reaches the f32
    solve's chi within 0.5%, poses within 1e-2."""
    _, poses, points, g = problem
    P, X = t(poses), t(points)
    st32, res32 = lm.solve_ba(g, P, X, cfg=lm.LMConfig(iterations=10))
    st16, res16 = lm.solve_ba(g, P, X, cfg=lm.LMConfig(iterations=10, assembly_precision="bf16"))
    chi0 = float(schur.robust_chi(g, P, X, "huber", DELTA))
    assert float(res16.chi) < 0.9 * chi0
    np.testing.assert_allclose(float(res16.chi), float(res32.chi), rtol=5e-3)
    np.testing.assert_allclose(to_numpy(st16.poses), to_numpy(st32.poses), rtol=0, atol=1e-2)


def test_blocks_engine_stays_f32(problem):  # noqa: F811
    """The reference's "blocks" engine never reads the precision
    (lm.py:242-252); the port's two engine names select one engine, so the
    name itself must keep the solve at f32."""
    _, poses, points, g = problem
    P, X = t(poses), t(points)
    blocks16, res_b = lm.solve_ba(g, P, X, cfg=lm.LMConfig(assembly_precision="bf16"), engine="blocks")
    soa32, res_s = lm.solve_ba(g, P, X, cfg=lm.LMConfig(), engine="soa")
    soa16, _ = lm.solve_ba(g, P, X, cfg=lm.LMConfig(assembly_precision="bf16"), engine="soa")
    assert _same(blocks16.poses, soa32.poses) and _same(blocks16.points, soa32.points)
    assert torch.equal(res_b.chi, res_s.chi)
    assert not _same(soa16.points, soa32.points)


@pytest.fixture(scope="module")
def tiny_map():
    """The port's own map after 5 frames of tests/test_torch_marg.py's
    tiny-window run (a keyframe every frame, the prior on), with its config."""
    from tests.test_torch_marg import TINY

    vo = VisualOdometry(config=Config(TINY), dataset=_dataset(TDataset), device="cpu")
    assert vo.init()
    for _ in range(5):
        assert vo.step()
    assert int((vo.carry.wmap.marg.prior_kf_id >= 0).sum()) >= 1
    return vo.frontend_cfg, vo.rig, vo.carry.wmap


def test_marginalization_info_stays_f32(tiny_map, monkeypatch):
    """`solve_window` assembles every LM attempt (the fused chi and blocks)
    at the configured precision, and the information it keeps for the next
    eviction at f32 (the reference's backend.py:300)."""
    cfg, rig, wmap = tiny_map
    seen = []
    build = schur.build_blocks

    def spy(*args, with_chi=False, assembly_precision="f32", **kw):
        seen.append((with_chi, assembly_precision))
        return build(*args, with_chi=with_chi, assembly_precision=assembly_precision, **kw)

    monkeypatch.setattr(schur, "build_blocks", spy)
    res = backend.solve_window(cfg, rig, wmap, backend.BAConfig(assembly_precision="bf16"))
    assert res.info is not None
    lm_builds = [p for fused, p in seen if fused]
    assert len(lm_builds) >= 2 and set(lm_builds) == {"bf16"}
    assert [p for fused, p in seen if not fused] == ["f32"]


def test_dist_solve_stays_f32(problem, tmp_path):  # noqa: F811
    """`make_dist_solve_fn` assembles in f32 whatever the config says, as the
    reference's sharded build (parallel/dist_ba.py:130): at world size 1
    over gloo, the bf16-configured solve gives the f32 solve's bits."""
    _, poses, points, g = problem
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        solve_fn = dist_ba.make_dist_solve_fn(mesh_mod.make_mesh())
        st16, res16 = solve_fn(g, t(poses), t(points), lm.LMConfig(assembly_precision="bf16"))
        st32, res32 = solve_fn(g, t(poses), t(points), lm.LMConfig())
    finally:
        dist.destroy_process_group()
    assert _same(st16.poses, st32.poses) and _same(st16.points, st32.points)
    assert torch.equal(res16.chi, res32.chi)
    single16, _ = lm.solve_ba(g, t(poses), t(points), cfg=lm.LMConfig(assembly_precision="bf16"))
    assert not _same(single16.points, st16.points)


def _short(n):
    return TDataset(n_frames=n, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


@pytest.mark.parametrize("ba_mode", ["inline", "async"])
def test_the_config_reaches_every_ba_path(ba_mode, monkeypatch):
    """`VisualOdometry` reads the key into its `BAConfig` (the reference's
    visual_odometry.py:356), which the inline path and the async backend
    share; `lm.solve_ba` gets it through `LMConfig`.  A `BAConfig()` made
    without the config, as `process_chunk`'s default, stays f32."""
    seen = []
    solve = lm.solve_ba

    def spy(*args, cfg, **kw):
        seen.append(cfg.assembly_precision)
        return solve(*args, cfg=cfg, **kw)

    monkeypatch.setattr(lm, "solve_ba", spy)
    vo = VisualOdometry(config=Config({**OVERRIDES, "ba_mode": ba_mode}), dataset=_short(6), device="cpu")
    assert vo.init() and vo.ba_cfg.assembly_precision == "bf16"
    if ba_mode == "async":
        assert vo.async_backend.ba_cfg is vo.ba_cfg
    vo.run()
    assert seen and set(seen) == {"bf16"}
    seen.clear()
    backend.ba_step(frontend.FrontendConfig.from_config(Config(OVERRIDES)), vo.rig, vo.carry.wmap)
    assert seen == ["f32"]
    vo = VisualOdometry(config=Config({**OVERRIDES, "ba_assembly_precision": "f32"}), dataset=_short(1), device="cpu")
    assert vo.init() and vo.ba_cfg.assembly_precision == "f32"
