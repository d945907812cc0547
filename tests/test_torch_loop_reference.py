"""The port's loop closer (pipeline/loop_closure.py, solver/pose_graph_host.py)
against the benchmark's plain reference of it (portbench/reference/loop.py),
on the CPU at small sizes:
- thumbnails agree to float32 rounding and the candidates come in the same
  order, on seeded random records;
- `_verify` gives the same verdict, inliers within 10% and the transform
  within tests/test_torch_loop.py's bars (2e-2 m, 0.1 degrees), on a
  revisit and on an unrelated view;
- the pose graph over a 60-record chain with 3 loop edges gives poses
  within 1e-9 m, the same dropped edges and the same chi gates, also with
  a gross outlier edge, where the outlier pass drops edges;
- a scripted `add_keyframe` sequence closes at the same keyframe onto the
  same candidate, with the same correction G;
- the stage file's replay (portbench/stages/loop.py) reads the port's
  kept calls within the configuration's limits, and at the cell's scale
  (320 records) a float32 pose graph in the port's place breaks `pg_T`'s
  limit;
- the pose graph's stacked SE(3) maps give the scalar helpers' bits, and
  at the cell's scale (400 records, 30 loop edges, with and without a
  gross outlier edge) the array solve agrees with the JAX package's loop
  over the edges within 1e-9 m and 1e-9 of chi, and drops the same edges.
The verifier's pose goes through `kernels.pose.verify_pose`, which the
benchmark's hook on `estimate_pose` does not see: a verification logs no
`k2` call, and both entries give the plain version's bits."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.kernels import pose as pose_k
from legoslam_tpu_torch.pipeline import loop_closure
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.solver import lm, pose_graph_host, reprojection
from portbench.reference import loop as ref_loop
from portbench.stages import loop as stage

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "portbench/configs/kitti00-loop.json").read_text())["limits"]
SHAPE, FOCAL = (160, 240), 260.0


def _yaw_pose(yaw_deg, xyz):
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = xyz
    return T


def _se3_random(rng, n, sigma_t, sigma_r):
    xi = np.concatenate([rng.normal(0, sigma_t, (n, 3)), rng.normal(0, sigma_r, (n, 3))], -1).astype(np.float32)
    return se3.se3_exp(torch.from_numpy(xi)).numpy().astype(np.float64)


@pytest.fixture(scope="module")
def world():
    return SyntheticPlanesDataset(n_frames=2, shape=SHAPE, focal=FOCAL, baseline=0.54)


def _view(ds, T_wc, step=12):
    """The image at T_wc, a grid of pixels and their exact world points."""
    H, W = SHAPE
    img, depth = ds._render_with_depth(T_wc, ds.rig.left)
    us, vs = np.meshgrid(np.arange(20, W - 20, step), np.arange(20, H - 20, step))
    uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float64)
    z = depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
    ok = np.isfinite(z) & (z < 60)
    uv, z = uv[ok], z[ok]
    p_cam = np.stack([(uv[:, 0] - W / 2) / FOCAL * z, (uv[:, 1] - H / 2) / FOCAL * z, z], -1)
    return img, uv, p_cam @ T_wc[:3, :3].T + T_wc[:3, 3]


def _intr(closer):
    return reprojection.Intrinsics(*closer.intr)


# --- place recognition ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thumbnails_and_candidate_order(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (94, 310)).astype(np.float32)
    # 30 records: noisy copies of a few places, so some score above the gate
    imgs = [np.clip(base * (k % 4 == 0) + rng.uniform(0, 255, base.shape) * (0.3 if k % 4 == 0 else 1.0), 0, 255)
            .astype(np.float32) for k in range(29)] + [np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
                                                        .astype(np.float32)]
    port = [loop_closure.make_thumbnail(im) for im in imgs]
    ref = [ref_loop.thumbnail(im) for im in imgs]
    for a, b in zip(port, ref):
        assert a.shape == ref_loop.THUMB and np.abs(a - b.numpy()).max() < 1e-5
    closer = loop_closure.LoopCloser(SyntheticPlanesDataset(n_frames=1, shape=SHAPE, focal=FOCAL).rig,
                                     device="cpu")
    closer.records = [loop_closure.KeyframeRecord(k, np.eye(4), np.eye(4), np.eye(4), t, None, None, None, 0)
                      for k, t in enumerate(port)]
    got = closer._detect()
    assert got == ref_loop.detect(ref, ref_loop.DEFAULTS) and len(got) == 3
    assert ref_loop.thumbnail(np.full((94, 310), 7.0)).abs().max() == 0


# --- verification --------------------------------------------------------------------

def _two_records(ds, T_wc_B, features_on_B=True):
    closer = loop_closure.LoopCloser(ds.rig, loop_closure.LoopConfig(zncc_min=1.1), device="cpu")
    for k, T_wc in enumerate((np.eye(4), T_wc_B)):
        img, uv, pw = _view(ds, T_wc)
        if k == 1 and not features_on_B:
            uv, pw = uv[:0], pw[:0]
        assert closer.add_keyframe(k, img, np.linalg.inv(T_wc), uv, pw) is None
    return closer


@pytest.mark.parametrize("T_wc_B,features_on_B,accept", [
    (_yaw_pose(2.0, [0.05, 0.0, 0.4]), True, True),
    (_yaw_pose(2.0, [0.05, 0.0, 0.4]), False, True),
    (_yaw_pose(40.0, [2.0, 0.0, 60.0]), False, False)], ids=["revisit", "forward-only", "unrelated"])
def test_verify_against_the_reference(world, T_wc_B, features_on_B, accept):
    closer = _two_records(world, T_wc_B, features_on_B)
    ok, M, n_in = closer._verify(0)
    call = stage.keep((closer, 0), {}, (ok, M, n_in))
    ok_r, M_r, n_r = ref_loop.verify(call["rec_i"], call["rec_j"], call["path_T_cw"], _intr(closer),
                                     ref_loop.DEFAULTS)
    assert ok == ok_r == accept
    assert abs(n_in - n_r) <= 0.1 * max(n_r, 1), (n_in, n_r)
    M_r = M_r.numpy()
    assert np.linalg.norm(M[:3, 3] - M_r[:3, 3]) < 2e-2 and stage.rotation_gap(M, M_r) < np.deg2rad(0.1)
    if accept:
        M_true = np.linalg.inv(T_wc_B)
        assert np.linalg.norm(M_r[:3, 3] - M_true[:3, 3]) < 0.08
    gaps = stage.verify_gaps(stage.keep((closer, 0), {}, (ok, M, n_in)), _intr(closer), ref_loop.DEFAULTS)
    assert gaps["loop_T"] <= LIMITS["loop_T"] and gaps["loop_inliers"] <= LIMITS["loop_inliers"]


# --- the pose graph ------------------------------------------------------------------

def _chain(seed, n=60):
    rng = np.random.default_rng(seed)
    rel = list(_se3_random(rng, n - 1, 0.3, 0.02))
    P = [np.eye(4)]
    for r in rel:
        P.append(r @ P[-1])
    edges = [(i, j, _se3_random(rng, 1, 0.05, 0.005)[0] @ P[i] @ np.linalg.inv(P[j]))
             for i, j in ((n - 1, 2), (n - 6, 1), (n // 2, 4))]
    return rel, edges, P[0]


@pytest.mark.parametrize("seed,outlier", [(3, False), (4, False), (3, True)])
def test_pose_graph_against_the_reference(seed, outlier):
    rel, edges, anchor = _chain(seed)
    if outlier:  # a verified but wrong closure, 40 m and 5 degrees off
        P = [anchor]
        for r in rel:
            P.append(r @ P[-1])
        edges = edges + [(58, 0, _yaw_pose(5.0, [40.0, 0.0, 0.0]) @ P[58] @ np.linalg.inv(P[0]))]
    kw = dict(anchor=anchor, odom_weight=1.0, loop_weight=20.0, iterations=4)
    P, chi0, chi1, dropped = pose_graph_host.solve_chain_graph(rel, edges, **kw)
    P_r, chi0_r, chi1_r, dropped_r = ref_loop.solve_chain_graph(rel, edges, **kw)
    centres = [stage._centres(x) for x in (P, P_r.numpy())]
    assert np.linalg.norm(centres[0] - centres[1], axis=-1).max() <= 1e-9
    assert dropped == dropped_r and bool(dropped) == outlier  # the outlier pass ran, and dropped the same edges
    assert chi0 == pytest.approx(chi0_r, rel=1e-9) and chi1 == pytest.approx(chi1_r, rel=1e-6)
    for new_dropped in (False, True):
        assert ref_loop.accepted(chi0, chi1, new_dropped, ref_loop.DEFAULTS) == ref_loop.accepted(
            chi0_r, chi1_r, new_dropped, ref_loop.DEFAULTS)
    call = stage.keep((rel, edges), kw, (P, chi0, chi1, dropped))
    gaps = stage.pose_graph_gaps(call, ref_loop.DEFAULTS)
    assert gaps["pg_T"] <= LIMITS["pg_T"] and gaps["pg_chi"] <= LIMITS["pg_chi"]


def test_a_float32_pose_graph_breaks_the_limit():
    """At the cell's scale, 320 records of a 468 m lap at 1.5 m a keyframe
    with a drift of 1 cm and 0.5 mrad a step, closed onto the first lap by
    three loop edges: the port reads within `pg_T`'s and `pg_chi`'s limits,
    a float32 pose graph in the port's place breaks `pg_T`'s."""
    rng = np.random.default_rng(6)
    n, L = 320, 312
    truth = [np.eye(4)]
    for k in range(n - 1):
        turn = _yaw_pose(90.0 / 8 if (k % (L // 4)) >= L // 4 - 8 else 0.0, [0.0, 0.0, 0.0])
        truth.append(turn @ _yaw_pose(0.0, [0.0, 0.0, -1.5]) @ truth[-1])
    rel = [_se3_random(rng, 1, 0.01, 0.0005)[0] @ truth[k + 1] @ np.linalg.inv(truth[k]) for k in range(n - 1)]
    edges = [(L + d, d, truth[L + d] @ np.linalg.inv(truth[d])) for d in (0, 3, 6)]
    kw = dict(anchor=truth[0], odom_weight=1.0, loop_weight=20.0, iterations=4)
    call = stage.keep((rel, edges), kw, pose_graph_host.solve_chain_graph(rel, edges, **kw))
    assert call["out"]["dropped"] == [] and call["out"]["chi1"] < 0.5 * call["out"]["chi0"]
    gaps = stage.pose_graph_gaps(call, ref_loop.DEFAULTS)
    assert gaps["pg_T"] <= LIMITS["pg_T"] and gaps["pg_chi"] <= LIMITS["pg_chi"], gaps
    low = stage.pose_graph_gaps(call, ref_loop.DEFAULTS, control=True)
    assert low["pg_T"] > LIMITS["pg_T"], low


def test_stacked_se3_maps_give_the_scalar_helpers_bits():
    rng = np.random.default_rng(8)
    xi = rng.normal(0, 0.3, (300, 6)) * rng.choice([1e-12, 1e-6, 1.0, 10.0], (300, 1))
    xi[:4, 3:] = 0.0  # no rotation: the small-angle branches
    T = pose_graph_host.se3_exps(xi)
    np.testing.assert_array_equal(T, np.stack([pose_graph_host.se3_exp(x) for x in xi]))
    T = T @ T[::-1]
    np.testing.assert_array_equal(pose_graph_host.se3_logs(T), np.stack([pose_graph_host.se3_log(x) for x in T]))
    np.testing.assert_array_equal(pose_graph_host.adjoints(T), np.stack([pose_graph_host.adjoint(x) for x in T]))


def _lap_chain(seed, outlier, n=400, L=312, n_loops=30):
    """A lap of `n` records at 1.5 m a keyframe, drifting 1 cm and 0.5 mrad a
    step, closed onto its first lap by `n_loops` loop edges; with `outlier`,
    one more edge 40 m and 5 degrees off."""
    rng = np.random.default_rng(seed)
    truth = [np.eye(4)]
    for k in range(n - 1):
        turn = _yaw_pose(90.0 / 8 if (k % (L // 4)) >= L // 4 - 8 else 0.0, [0.0, 0.0, 0.0])
        truth.append(turn @ _yaw_pose(0.0, [0.0, 0.0, -1.5]) @ truth[-1])
    rel = [_se3_random(rng, 1, 0.01, 0.0005)[0] @ truth[k + 1] @ np.linalg.inv(truth[k]) for k in range(n - 1)]
    edges = [(L + d, d, _se3_random(rng, 1, 0.02, 0.001)[0] @ truth[L + d] @ np.linalg.inv(truth[d]))
             for d in np.linspace(0, n - 1 - L, n_loops).astype(int)]
    if outlier:
        edges.append((n - 2, 5, _yaw_pose(5.0, [40.0, 0.0, 0.0]) @ truth[n - 2] @ np.linalg.inv(truth[5])))
    return rel, edges, truth[0]


@pytest.mark.parametrize("outlier", [False, True])
def test_pose_graph_at_the_cells_scale_against_the_jax_package(outlier):
    from legoslam_tpu.solver import pose_graph_host as j_pgh

    rel, edges, anchor = _lap_chain(7, outlier)
    kw = dict(anchor=anchor, odom_weight=1.0, loop_weight=20.0, iterations=4)
    stats = {}
    P, chi0, chi1, dropped = pose_graph_host.solve_chain_graph(rel, edges, **kw, stats=stats)
    P_r, chi0_r, chi1_r, dropped_r = j_pgh.solve_chain_graph(rel, edges, **kw)
    assert np.linalg.norm(stage._centres(P) - stage._centres(P_r), axis=-1).max() <= 1e-9
    assert chi0 == pytest.approx(chi0_r, rel=1e-9) and chi1 == pytest.approx(chi1_r, rel=1e-9)
    assert dropped == dropped_r == ([len(edges) - 1] if outlier else [])  # the outlier alone
    assert chi1 < 1e-3 * chi0
    assert stats == {"factorizations": 1 + outlier, "edges": len(rel) + len(edges) - outlier}


# --- the closer ------------------------------------------------------------------------

def test_a_scripted_sequence_closes_like_the_reference(world):
    """Six keyframes: five down the corridor, the sixth back beside the
    first with its odometry 0.25 m off; both close it onto record 0 with
    the same correction."""
    truth = [_yaw_pose(0.0, [0.0, 0.0, 4.0 * k]) for k in range(5)] + [_yaw_pose(2.0, [0.05, 0.0, 0.4])]
    drift = [np.eye(4)] * 5 + [_yaw_pose(0.0, [0.25, 0.0, 0.1])]
    closer = loop_closure.LoopCloser(world.rig, loop_closure.LoopConfig(min_gap=3), device="cpu")
    ref = ref_loop.LoopReference(_intr(closer), dict(ref_loop.DEFAULTS, min_gap=3))
    out = []
    for k, (T_wc, D) in enumerate(zip(truth, drift)):
        img, uv, pw = _view(world, T_wc)
        T_cw = np.linalg.inv(T_wc @ D)
        pw = pw @ D[:3, :3].T + D[:3, 3] if k == 5 else pw
        out.append((closer.add_keyframe(k, img, T_cw, uv, pw), ref.add_keyframe(k, img, T_cw, uv, pw)))
    assert all(a is None and b is None for a, b in out[:5])
    (corr, G), (corr_r, G_r) = out[5]
    assert [(i, j) for i, j, _ in closer.loop_edges] == [(i, j) for i, j, _ in ref.loop_edges] == [(5, 0)]
    assert np.abs(G - G_r.numpy()).max() < 2e-2 and np.abs(corr - corr_r.numpy()).max() < 2e-2
    for a, b in zip(closer.records, ref.records):
        assert np.abs(a.T_cw - b["T_cw"].numpy()).max() < 2e-2
        np.testing.assert_array_equal(a.img, b["img"])
    assert ref.cooldown == closer._cooldown == closer.cfg.cooldown_keyframes


# --- the verifier's own pose entry ---------------------------------------------------

def _pose_case(n=200, seed=5):
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(6, 40, n)], -1)
    T = np.eye(4)
    uv = np.stack([150 * P[:, 0] / P[:, 2] + 155, 150 * P[:, 1] / P[:, 2] + 47], -1) + rng.normal(0, 0.4, (n, 2))
    uv[: n // 10] += rng.normal(0, 20.0, (n // 10, 2))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    T_prior = se3.se3_exp(torch.tensor([0.05, -0.02, 0.2, 0.0, 0.01, 0.0]))
    return reprojection.Intrinsics(150.0, 150.0, 155.0, 47.0), T_prior @ f32(T), f32(P), f32(uv), \
        torch.from_numpy(rng.uniform(size=n) > 0.05)


def test_verify_pose_is_the_verification_rounds_and_bypasses_the_k2_hook(world):
    from portbench.hooks import Hooks

    intr, T, P, uv, valid = _pose_case()
    kw = dict(chi2_th=5.991, outer_iterations=4, drop_kernel_after=3, cfg=lm.LMConfig(iterations=10))
    v, t = pose_k.verify_pose(intr, T, P, uv, valid, **kw), pose_k.estimate_pose(intr, T, P, uv, valid)
    for got, want in ((v, lm.estimate_pose(intr, T, P, uv, valid, verification=True, **kw)),
                      (t, lm.estimate_pose(intr, T, P, uv, valid))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(v[0], t[0])  # the two entries run different rounds
    closer = _two_records(world, _yaw_pose(2.0, [0.05, 0.0, 0.4]))
    hooks = Hooks().install()
    try:
        hooks.kernel_log = []
        ok, _, _ = closer._verify(0)
        assert ok and [c[0] for c in hooks.kernel_log] == ["k1_frame"] * 4  # K1 there and back, both ways
        pose_k.estimate_pose(intr, T, P, uv, valid)
        assert [c[0] for c in hooks.kernel_log].count("k2") == 1  # tracking's call alone
    finally:
        hooks.remove()
