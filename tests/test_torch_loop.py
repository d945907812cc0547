"""Loop closure of the port (pipeline/loop_closure.py,
solver/pose_graph_host.py, the driver's hook and world correction) against
the JAX reference.

Host code (thumbnails, the f64 pose graph) is NumPy in both packages and
must agree exactly or to 1e-12.  Verification is float32 on the device in
both: KLT lanes at a gate threshold may fall either way, so `_verify` is
compared by its verdict, the inlier count (within 10% of the reference's)
and the measured transform (translation within 2e-2 m, rotation within
0.1 degrees; both within the reference test's own bars of the true
transform).  A scripted sequence of six keyframe records whose last one
revisits the first goes through `add_keyframe` in both closers: the same
closure, the correction G and the corrected poses within 2e-2.

A pair of records from the card (tests/data/loop_pair_tail80.npz) shows a
hole that the port shares with the reference: on a one-lap course with an
80-frame tail (188x620, `scripts/loop_course_scan.py lap1_tail80 --dump` on
an NVIDIA H100 80GB HBM3) the port closed keyframe 54 onto keyframe 7, whose
camera stood 2.1 m further along the straight, with a loop transform 1.025 m
off the true one, and the full ATE rose from 0.2257 to 1.1140 m.  Fed the
same records, both closers accept that closure and measure the same wrong
transform (within 2e-2 m of each other, more than 0.5 m from the truth): the
zero-motion KLT guess at 3 half-resolution levels does not always span a
revisit that far off, and the gates (25 inliers, a consistency budget of
0.5 m + 5% of the path) let the result through.  The file was cut from the
card's records by `python -m tests.ba_parity_report --loop-records ...
--save-pair`.

The hook is held to the reference driver's: on 12 frames of the test
corridor (keyframes on frames 0, 1, 6 and 11) both register frames 1, 2, 7
and, drained at the end of the stream, 11.  One lap end to end through the
port alone is marked `slow`, as its reference twin is
(tests/test_loop_closure.py::test_loop_closure_end_to_end).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from legoslam_tpu.pipeline import loop_closure as j_loop
from legoslam_tpu.pipeline import visual_odometry as j_vo
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.solver import pose_graph_host as j_pgh
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.pipeline import frontend, loop_closure, state
from legoslam_tpu_torch.pipeline import visual_odometry as t_vo
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam_tpu_torch.solver import pose_graph_host
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests.test_loop_closure import FOCAL, SHAPE, _grid_features, _make_record, loop_trajectory
from tests.test_torch_vo import F32, OVERRIDES, _dataset
from tests.torch_parity import step_gap, to_numpy, tree_to_numpy


def _yaw_pose(yaw_deg, xyz):
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = xyz
    return T


def _se3_random(rng, n, sigma_t=1.0, sigma_r=0.2):
    from legoslam_tpu_torch.geometry import se3

    xi = np.concatenate([rng.normal(0, sigma_t, (n, 3)), rng.normal(0, sigma_r, (n, 3))], -1).astype(np.float32)
    return se3.se3_exp(torch.from_numpy(xi)).numpy()


# --- host code ------------------------------------------------------------------

def test_make_thumbnail_equals_reference():
    rng = np.random.default_rng(0)
    for shape in ((94, 310), (80, 120)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        a, b = loop_closure.make_thumbnail(img), j_loop.make_thumbnail(img)
        assert a.dtype == np.float32 and a.shape == loop_closure.THUMB == j_loop.THUMB
        np.testing.assert_array_equal(a, b)
    flat = loop_closure.make_thumbnail(np.full((94, 310), 7.0, np.float32))
    assert not flat.any()


def test_solve_chain_graph_equals_reference():
    rng = np.random.default_rng(1)
    n = 12
    rel = [_se3_random(rng, 1, 0.5, 0.05)[0].astype(np.float64) for _ in range(n - 1)]
    P = [np.eye(4)]
    for r in rel:
        P.append(r @ P[-1])
    M = (_se3_random(rng, 1, 0.05, 0.01)[0].astype(np.float64)) @ P[n - 1] @ np.linalg.inv(P[1])
    far = _yaw_pose(5.0, [40.0, 0.0, 0.0]) @ P[n - 2] @ np.linalg.inv(P[0])  # a gross outlier edge
    for edges in ([(n - 1, 1, M)], [(n - 1, 1, M), (n - 2, 0, far)]):
        a = pose_graph_host.solve_chain_graph(rel, edges, anchor=P[0], iterations=4)
        b = j_pgh.solve_chain_graph(rel, edges, anchor=P[0], iterations=4)
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(a[1:3], b[1:3], rtol=1e-12)
        assert a[3] == b[3]
        assert a[2] < 0.5 * a[1]
    assert len(a[3]) == 1  # the outlier pass ran and dropped an edge, the same one in both
    for fn in ("se3_log", "se3_exp", "adjoint"):
        x = rng.normal(0, 0.3, 6) if fn == "se3_exp" else P[3]
        np.testing.assert_array_equal(getattr(pose_graph_host, fn)(x), getattr(j_pgh, fn)(x))


# --- verification ---------------------------------------------------------------

@pytest.fixture(scope="module")
def views():
    ds = JDataset(n_frames=2, shape=SHAPE, focal=FOCAL, baseline=0.54)
    ds.init()
    port_ds = TDataset(n_frames=2, shape=SHAPE, focal=FOCAL, baseline=0.54)
    return ds, port_ds


def _closers(views, **cfg):
    ds, port_ds = views
    return (j_loop.LoopCloser(ds.rig, j_loop.LoopConfig(**cfg)),
            loop_closure.LoopCloser(port_ds.rig, loop_closure.LoopConfig(**cfg), device="cpu"))


def _port_record(rec):
    return loop_closure.KeyframeRecord(**dataclasses.asdict(rec))


def test_verify_matches_reference_on_a_revisit(views):
    ds, _ = views
    T_wc_A, T_wc_B = np.eye(4), _yaw_pose(2.0, [0.05, 0.0, 0.4])
    imgA, uvA, pwA = _grid_features(ds, T_wc_A)
    imgB, uvB, pwB = _grid_features(ds, T_wc_B)
    jlc, lc = _closers(views)
    assert lc.cfg.klt.levels == 3 and lc.cfg.max_feats == 256 and lc.device.type == "cpu"
    jlc.records = [_make_record(0, imgA, np.linalg.inv(T_wc_A), uvA, pwA),
                   _make_record(1, imgB, np.linalg.inv(T_wc_B), uvB, pwB)]
    lc.records = [_port_record(r) for r in jlc.records]
    ok_r, M_r, n_r = jlc._verify(0)
    ok, M, n_in = lc._verify(0)
    assert ok and ok_r
    assert n_in >= 50 and abs(n_in - n_r) <= 0.1 * n_r, (n_in, n_r)
    assert M.dtype == np.float64
    assert np.linalg.norm(M[:3, 3] - M_r[:3, 3]) < 2e-2

    def angle(A, B):
        return np.arccos(np.clip((np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2, -1, 1))

    assert angle(M, M_r) < np.deg2rad(0.1)
    M_true = np.linalg.inv(T_wc_B) @ T_wc_A
    assert np.linalg.norm(M[:3, 3] - M_true[:3, 3]) < 0.08 and angle(M, M_true) < np.deg2rad(0.5)
    # forward only (the new keyframe has no stored features): the same verdict
    jlc.records[1] = _make_record(1, imgB, np.linalg.inv(T_wc_B))
    lc.records[1] = _port_record(jlc.records[1])
    ok_r, M_r, n_r = jlc._verify(0)
    ok, M, n_in = lc._verify(0)
    assert ok and ok_r and abs(n_in - n_r) <= 0.1 * n_r
    assert np.linalg.norm(M[:3, 3] - M_r[:3, 3]) < 2e-2


def test_verify_rejects_unrelated_view_like_reference(views):
    ds, _ = views
    T_wc_A, T_wc_B = np.eye(4), _yaw_pose(40.0, [2.0, 0.0, 60.0])
    imgA, uvA, pwA = _grid_features(ds, T_wc_A)
    imgB = ds._render(T_wc_B, ds.rig.left)
    jlc, lc = _closers(views)
    jlc.records = [_make_record(0, imgA, np.linalg.inv(T_wc_A), uvA, pwA),
                   _make_record(1, imgB, np.linalg.inv(T_wc_B))]
    lc.records = [_port_record(r) for r in jlc.records]
    ok_r, _, n_r = jlc._verify(0)
    ok, M, n_in = lc._verify(0)
    assert not ok and not ok_r
    assert n_in < lc.cfg.min_inliers and n_r < jlc.cfg.min_inliers
    np.testing.assert_array_equal(M, np.eye(4))


def test_add_keyframe_closes_like_reference(views):
    """Six keyframes: five down the corridor, the sixth back beside the
    first, its odometry pose 0.25 m off.  Both closers close it onto record
    0, with the same correction."""
    ds, _ = views
    truth = [_yaw_pose(0.0, [0.0, 0.0, 4.0 * k]) for k in range(5)] + [_yaw_pose(2.0, [0.05, 0.0, 0.4])]
    drift = [np.eye(4)] * 5 + [_yaw_pose(0.0, [0.25, 0.0, 0.1])]
    jlc, lc = _closers(views, min_gap=3)
    results = []
    for k, (T_wc, D) in enumerate(zip(truth, drift)):
        img, uv, pw = _grid_features(ds, T_wc)
        T_cw = np.linalg.inv(T_wc @ D)
        # the landmarks live in the odometry's (drifted) world
        pw_odo = pw @ D[:3, :3].T + D[:3, 3] if k == 5 else pw
        results.append((jlc.add_keyframe(k, img, T_cw, uv, pw_odo), lc.add_keyframe(k, img, T_cw, uv, pw_odo)))
    assert all(a is None and b is None for a, b in results[:5])
    (corr_r, G_r), (corr, G) = results[5]
    assert jlc.stats == lc.stats and lc.stats["closures"] == 1
    assert [(i, j) for i, j, _ in lc.loop_edges] == [(i, j) for i, j, _ in jlc.loop_edges] == [(5, 0)]
    np.testing.assert_allclose(G, G_r, rtol=0, atol=2e-2)
    np.testing.assert_allclose(corr, corr_r, rtol=0, atol=2e-2)
    # the correction undoes most of the drift of the last keyframe
    err_before = np.linalg.norm(np.linalg.inv(lc.records[5].T_cw_obs)[:3, 3] - truth[5][:3, 3])
    err_after = np.linalg.norm(np.linalg.inv(corr[5])[:3, 3] - truth[5][:3, 3])
    assert err_after < 0.5 * err_before, (err_before, err_after)
    for a, b in zip(lc.records, jlc.records):
        assert a.frame_id == b.frame_id and a.n_feats == b.n_feats
        np.testing.assert_array_equal(a.thumb, b.thumb)
        np.testing.assert_array_equal(a.img, b.img)
        np.testing.assert_array_equal(a.rel_prev, b.rel_prev)
        np.testing.assert_array_equal(a.T_cw, corr[lc.records.index(a)])
    # cooldown, then reset
    assert lc._cooldown == lc.cfg.cooldown_keyframes
    lc.reset()
    assert not lc.records and not lc.loop_edges and lc._cooldown == 0


def _pair_closers(d, upto):
    """Both packages' closers holding tests/data's pair of records and blank
    ones around them, up to (not including) keyframe `upto`."""
    world = dict(n_frames=1, shape=(188, 620), focal=360.0, baseline=0.54)
    jlc = j_loop.LoopCloser(JDataset(**world).rig)
    lc = loop_closure.LoopCloser(TDataset(**world).rig, device="cpu")
    i, j = int(d["i"]), int(d["j"])
    blank = np.zeros((94, 310), np.uint8)
    for closer, Record in ((jlc, j_loop.KeyframeRecord), (lc, loop_closure.KeyframeRecord)):
        for k, T in enumerate(d["T_cw"][:upto]):
            w = {i: "i", j: "j"}.get(k)
            closer.records.append(Record(
                frame_id=int(d[f"frame_id_{w}"]) if w else k, T_cw=T.copy(),
                T_cw_obs=d[f"T_cw_obs_{w}"] if w else T.copy(), rel_prev=np.eye(4),
                thumb=np.zeros(loop_closure.THUMB, np.float32), img=d[f"img_{w}"] if w else blank,
                uv=d[f"uv_{w}"] if w else np.zeros((256, 2), np.float32),
                p_world=d[f"p_world_{w}"] if w else np.zeros((256, 3), np.float32),
                n_feats=int(d[f"n_feats_{w}"]) if w else 0))
    return jlc, lc


def test_verify_accepts_a_far_revisit_wrongly_like_reference():
    d = np.load(os.path.join(os.path.dirname(__file__), "data", "loop_pair_tail80.npz"))
    i, j = int(d["i"]), int(d["j"])
    jlc, lc = _pair_closers(d, i + 1)
    assert len(jlc.records) == len(lc.records) == i + 1
    ok_r, M_r, n_r = jlc._verify(j)
    ok, M, n_in = lc._verify(j)
    assert ok and ok_r
    assert n_in >= 100 and abs(n_in - n_r) <= 0.1 * n_r, (n_in, n_r)
    assert np.linalg.norm(M[:3, 3] - M_r[:3, 3]) < 2e-2
    assert np.linalg.norm(M[:3, 3] - d["M_card"][:3, 3]) < 2e-2
    M_true = d["M_true"]
    assert abs(M_true[2, 3]) > 2.0  # the revisit stands 2.1 m off along the straight
    assert np.linalg.norm(M[:3, 3] - M_true[:3, 3]) > 0.5 and np.linalg.norm(M_r[:3, 3] - M_true[:3, 3]) > 0.5


def test_debug_dump_matches_reference(tmp_path, monkeypatch):
    """With LEGOSLAM_LOOP_DEBUG=<path>, a closure appends the reference's
    records to <path>: the same tags in the same order, the same payload
    keys, NumPy arrays, and the same values (the measurement within 2e-2 m,
    as the test above holds it).  Keyframe i of tests/data's pair is added
    to both closers holding the records before it, with place recognition
    pointed at keyframe j."""
    import pickle

    d = np.load(os.path.join(os.path.dirname(__file__), "data", "loop_pair_tail80.npz"))
    i, j, n = int(d["i"]), int(d["j"]), int(d["n_feats_i"])
    jlc, lc = _pair_closers(d, i)
    img_full = np.repeat(np.repeat(d["img_i"].astype(np.float32), 2, axis=0), 2, axis=1)
    dumps = {}
    for name, closer in (("reference", jlc), ("port", lc)):
        path = str(tmp_path / f"{name}.pkl")
        if name == "reference":
            monkeypatch.setattr(j_loop, "_DEBUG_PATH", path)
        else:
            monkeypatch.setenv("LEGOSLAM_LOOP_DEBUG", path)
        closer._detect = lambda: [j]
        closer.add_keyframe(int(d["frame_id_i"]), img_full, d["T_cw_obs_i"], d["uv_i"][:n] * 2.0, d["p_world_i"][:n])
        records = []
        with open(path, "rb") as f:
            while True:
                try:
                    records.append(pickle.load(f))
                except EOFError:
                    break
        dumps[name] = records
    ref, port = dumps["reference"], dumps["port"]
    assert [r["tag"] for r in port] == [r["tag"] for r in ref] == ["closure", "optimize"]
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
    closure, jclosure = port[0], ref[0]
    assert (closure["i"], closure["j"]) == (jclosure["i"], jclosure["j"]) == (i, j)
    assert closure["fids"] == jclosure["fids"]
    assert isinstance(closure["M"], np.ndarray) and isinstance(closure["pre"], np.ndarray)
    assert np.linalg.norm(closure["M"][:3, 3] - jclosure["M"][:3, 3]) < 2e-2
    np.testing.assert_allclose(closure["pre"], jclosure["pre"], atol=1e-6)
    opt, jopt = port[1], ref[1]
    assert opt["pre"] is None and jopt["pre"] is None and opt["fids"] == jopt["fids"]
    assert isinstance(opt["post"], np.ndarray) and opt["post"].shape == jopt["post"].shape == (i + 1, 4, 4)
    assert [(a, b) for a, b, _ in opt["loop_edges"]] == [(a, b) for a, b, _ in jopt["loop_edges"]] == [(i, j)]
    # nothing is written without the variable
    size = os.path.getsize(tmp_path / "port.pkl")
    monkeypatch.delenv("LEGOSLAM_LOOP_DEBUG")
    loop_closure._debug_dump("closure", {"i": 0})
    assert os.path.getsize(tmp_path / "port.pkl") == size


# --- the driver -------------------------------------------------------------------

def test_apply_world_correction_matches_reference():
    rng = np.random.default_rng(3)
    cfg = frontend.FrontendConfig.from_config(Config(OVERRIDES))
    jcfg = j_vo.frontend_mod.FrontendConfig.from_config(JConfig(OVERRIDES))
    jc = j_vo.initial_carry(jcfg, (16, 24))
    KW, ML = cfg.caps.window, cfg.caps.landmarks
    wmap = jc.wmap._replace(
        lm_pos=jnp.asarray(rng.normal(0, 5, (ML, 3)).astype(np.float32)),
        lm_alive=jnp.asarray(rng.uniform(size=ML) > 0.5),
        kf_pose=jnp.asarray(_se3_random(rng, KW)),
        kf_valid=jnp.asarray(rng.uniform(size=KW) > 0.4),
        marg=jc.wmap.marg._replace(prior_T=jnp.asarray(_se3_random(rng, KW)),
                                   info_T=jnp.asarray(_se3_random(rng, KW))),
    )
    jc = jc._replace(wmap=wmap, T_cur=jnp.asarray(_se3_random(rng, 1)[0]),
                     rel_motion=jnp.asarray(_se3_random(rng, 1, 0.1, 0.01)[0]))
    G = _se3_random(rng, 1, 0.5, 0.05)[0]
    carry = state.carry_from_numpy(tree_to_numpy(jc))
    ref = tree_to_numpy(j_vo._apply_world_correction(jc, jnp.asarray(G)))
    out = t_vo._apply_world_correction(carry, torch.from_numpy(G))
    np.testing.assert_allclose(to_numpy(out.T_cur), ref["T_cur"], atol=1e-5)
    np.testing.assert_array_equal(to_numpy(out.rel_motion), ref["rel_motion"])
    for name in ("lm_pos", "kf_pose"):
        np.testing.assert_allclose(to_numpy(getattr(out.wmap, name)), ref["wmap"][name], atol=2e-5, err_msg=name)
    for name in ("prior_T", "info_T"):
        np.testing.assert_allclose(to_numpy(getattr(out.wmap.marg, name)), ref["wmap"]["marg"][name], atol=1e-5)
    dead = ~np.asarray(wmap.lm_alive)
    np.testing.assert_array_equal(to_numpy(out.wmap.lm_pos)[dead], np.asarray(wmap.lm_pos)[dead])
    # a point seen from a corrected keyframe stays where it was in that camera
    k = int(np.argmax(np.asarray(wmap.kf_valid)))
    p = int(np.argmax(np.asarray(wmap.lm_alive)))
    before = np.asarray(wmap.kf_pose)[k] @ np.append(np.asarray(wmap.lm_pos)[p], 1.0)
    after = to_numpy(out.wmap.kf_pose)[k] @ np.append(to_numpy(out.wmap.lm_pos)[p], 1.0)
    np.testing.assert_allclose(after, before, atol=1e-3)


class _StubCloser:
    """Records what the hook hands over; never closes."""

    def __init__(self):
        self.added, self.resets, self.records = [], 0, []

    def add_keyframe(self, frame_id, img, T_cw, uv, p_world):
        self.added.append((frame_id, img.shape, np.array(T_cw), np.array(uv), np.array(p_world)))
        return None

    def reset(self):
        self.resets += 1


HOOK_FRAMES = 12
HOOK_CONFIG = {**OVERRIDES, "use_loop_closure": True, "loop_zncc_min": 1.1}


def _hook_dataset(cls):
    return cls(n_frames=HOOK_FRAMES, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


def reference_hook_run(closer):
    """The reference's `VisualOdometry` over the 12 hook frames (BA inline at
    f32) with `closer` in place of its loop closer: (T_cw, keyframe flags)."""
    jvo = j_vo.VisualOdometry(config=JConfig({**HOOK_CONFIG, **F32}),
                              dataset=_hook_dataset(JDataset))
    assert jvo.init()
    jvo.loop_closer = closer
    jvo.run()
    return np.asarray(jvo.trajectory_T_cw()), np.asarray([bool(o.kf_inserted) for o in jvo.outputs])


def test_loop_hook_registers_the_frame_after_each_keyframe():
    vo = VisualOdometry(config=Config(HOOK_CONFIG), dataset=_hook_dataset(TDataset), device="cpu")
    assert vo.init()
    assert isinstance(vo.loop_closer, loop_closure.LoopCloser) and vo.loop_closer.device.type == "cpu"
    assert vo.loop_closer.cfg.zncc_min == 1.1 and vo.loop_closer.cfg.min_gap == 10
    stub = vo.loop_closer = _StubCloser()
    vo.run()
    kf = vo.keyframe_flags()
    assert kf.tolist() == [True, True] + [False] * 4 + [True] + [False] * 4 + [True]
    # the frame after each keyframe; the trailing keyframe drained from the final carry
    assert [a[0] for a in stub.added] == [1, 2, 7, 11] and stub.resets == 0
    T_cw = vo.trajectory_T_cw()
    for fid, shape, T, uv, pw in stub.added:
        assert shape == (160, 240) and len(uv) == len(pw) > 30
        np.testing.assert_array_equal(T, T_cw[fid])
        z = (pw @ T[:3, :3].T + T[:3, 3])[:, 2]
        assert (z > 0).all()
        u = 260.0 * (pw @ T[:3, :3].T + T[:3, 3])[:, 0] / z + 120.0
        assert np.median(np.abs(u - uv[:, 0])) < 1.0   # features and landmarks of one frame
    assert vo.keyframe_trajectory()[0] == []
    vo._drain_hooks()                                   # drained once: nothing is left
    assert len(stub.added) == 4


def test_loop_hook_resets_on_lost():
    vo = VisualOdometry(config=Config(HOOK_CONFIG), dataset=_hook_dataset(TDataset), device="cpu")
    assert vo.init()
    stub = vo.loop_closer = _StubCloser()
    for _ in range(3):
        assert vo.step()
    assert [a[0] for a in stub.added] == [1, 2]
    frame = _hook_dataset(TDataset)
    frame.init()
    fr = frame.next_frame()
    lost = dataclasses.replace(vo.outputs[-1], status=int(FrontendStatus.LOST), kf_inserted=False)
    vo._loop_hook(fr, lost)                  # the LOST frame itself changes nothing yet
    assert stub.resets == 0
    vo._loop_hook(fr, dataclasses.replace(lost, status=int(FrontendStatus.INITING)))
    assert stub.resets == 1 and len(stub.added) == 2
    vo._hook_prev = (fr, lost)               # a stream that ends on a LOST frame
    vo._drain_hooks()
    assert stub.resets == 2 and vo._hook_prev is None


def test_loop_hook_frame_ids_match_reference_driver():
    """The reference driver's records on the same 12 frames (detector shut)."""
    jvo = j_vo.VisualOdometry(config=JConfig({**HOOK_CONFIG, **F32}),
                              dataset=_hook_dataset(JDataset))
    assert jvo.init()
    jvo.run()
    vo = VisualOdometry(config=Config({**HOOK_CONFIG, **F32}), dataset=_hook_dataset(TDataset), device="cpu")
    assert vo.init()
    vo.run()
    ids, T = vo.keyframe_trajectory()
    jids, jT = jvo.keyframe_trajectory()
    assert ids == jids == [1, 2, 7, 11]
    assert vo.loop_closer.stats == jvo.loop_closer.stats and vo.loop_closer.stats["closures"] == 0
    assert T.shape == jT.shape == (4, 4, 4)
    for a, b in zip(vo.loop_closer.records, jvo.loop_closer.records):
        assert abs(a.n_feats - b.n_feats) <= 0.1 * b.n_feats
        np.testing.assert_array_equal(a.img, b.img)
        np.testing.assert_array_equal(a.thumb, b.thumb)


class _FixedCorrection(_StubCloser):
    """Returns one fixed correction G at the registration of `frame_id`."""

    def __init__(self, frame_id, G):
        super().__init__()
        self.frame_id, self.G = frame_id, G

    def add_keyframe(self, frame_id, img, T_cw, uv, p_world):
        super().add_keyframe(frame_id, img, T_cw, uv, p_world)
        return (0, self.G) if frame_id == self.frame_id else None


def test_loop_correction_applied_at_the_reference_frame():
    """Both drivers run the same 12 frames with the closer stubbed to return
    one fixed G when frame 7 (the frame after keyframe 6) is registered.
    The reference reads that record a frame late and applies G to the carry
    after frame 8, so frame 8 is reported in the uncorrected world and frame
    9 on in the corrected one; the port must do the same.  Each package is
    held against its own run without the correction, and the two corrected
    trajectories against each other as tests/test_torch_vo.py holds the
    BA-inline runs (frame-to-frame motion out of frames without a keyframe
    within 0.03 m): the reference's camera positions themselves move by up
    to 0.093 m from one host to the next (`python -m tests.ba_parity_report
    --isa-spread`)."""
    G = _yaw_pose(4.0, [0.3, -0.1, 0.5])
    jstub = _FixedCorrection(7, G)
    T_ref, kf_ref = reference_hook_run(jstub)
    ref_plain, _ = reference_hook_run(_StubCloser())
    runs = {}
    for name, closer in (("plain", _StubCloser()), ("corrected", _FixedCorrection(7, G))):
        vo = VisualOdometry(config=Config({**HOOK_CONFIG, **F32}), dataset=_hook_dataset(TDataset), device="cpu")
        assert vo.init()
        vo.loop_closer = closer
        vo.run()
        runs[name] = vo.trajectory_T_cw()
    assert [a[0] for a in jstub.added] == [a[0] for a in closer.added] == [1, 2, 7, 11]
    T, plain = runs["corrected"], runs["plain"]
    assert step_gap(np.linalg.inv(T), np.linalg.inv(T_ref), kf_ref) < 0.03
    # frame 8: the uncorrected world, bit for bit; frame 9: T_cw G^-1 of the uncorrected run
    np.testing.assert_array_equal(T[:9], plain[:9])
    G_inv = np.linalg.inv(G)
    for T_run, P in ((T, plain), (T_ref, ref_plain)):
        assert np.abs(T_run[8] - P[8]).max() < 5e-2 < np.abs(T_run[8] @ G - P[8]).max()
        assert np.abs(T_run[9] - P[9] @ G_inv).max() < 5e-2 < np.abs(T_run[9] - P[9]).max()


@pytest.mark.slow
def test_loop_closure_end_to_end():
    """tests/test_loop_closure.py::test_loop_closure_end_to_end through the
    port: one lap, open arm (detector shut) against closed arm."""
    traj = loop_trajectory()
    base = {
        "max_features": 320, "keyframe_window_capacity": 8, "max_active_landmarks": 1536,
        "max_landmarks": 16384, "num_active_keyframes": 7, "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 50.0, "detect_mask_half": 6, "gftt_min_distance": 6,
        "use_loop_closure": True,
    }
    res = {}
    for zncc in (1.1, 0.5):
        ds = TDataset(shape=SHAPE, focal=FOCAL, baseline=0.54, half_width=20.0, length=30.0, z_min=-25.0,
                      trajectory=traj)
        vo = VisualOdometry(config=Config({**base, "loop_zncc_min": zncc}), dataset=ds, device="cpu")
        assert vo.init()
        vo.run()
        est = vo.trajectory_T_wc()
        full_ate = evaluation.ate_rmse(est[:, :3, 3], traj[: len(est), :3, 3])
        ids, kf_T_cw = vo.keyframe_trajectory()
        kf_ate = evaluation.ate_rmse(np.linalg.inv(kf_T_cw)[:, :3, 3], traj[ids][:, :3, 3])
        res[zncc] = (full_ate, kf_ate, dict(vo.loop_closer.stats))
    open_full, open_kf, open_stats = res[1.1]
    closed_full, closed_kf, closed_stats = res[0.5]
    assert open_stats["closures"] == 0
    assert closed_stats["closures"] >= 1, closed_stats
    assert closed_kf < open_kf, (closed_kf, open_kf)
    assert closed_full < open_full, (closed_full, open_full)
