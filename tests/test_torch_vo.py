"""The port's VO slice against the JAX reference.

One reference run with window BA off of 14 frames of the test corridor (the
scene and small capacities of tests/test_pipeline.py) serves the first
checks, so the reference step compiles once:
- state handover: the reference's carry after 7 frames, converted with
  `state.carry_from_numpy`, is stepped through frame 7 (a tracking frame) by
  both; T_cw within 1e-3, inlier masks agree >= 98%, KLT success masks
  >= 95% (the bars of tests/test_pose_pallas.py and test_klt_pallas.py);
- the whole slice: statuses and keyframe flags equal on every frame,
  camera positions within 2e-2 m, both ATE < 0.15 m (test_pipeline.py:135).

A second reference run, with window BA inline (the default) at
`ba_assembly_precision: f32`, holds the port at f32: statuses and
keyframe flags equal on every frame, both ATE < 0.15 m
(test_pipeline.py:145), a finite BA chi on every keyframe frame, and the
trajectory in what the window's free gauge cannot move.  The reference
itself does not hold camera positions from one host to the next: under
XLA's CPU instruction sets (`--xla_cpu_max_isa` unset, AVX2, SSE4_2) its
runs agree to 1e-4 in frame 1's window BA relative to the oldest keyframe,
and in chi to 1e-3, while the window's rigid placement moves by up to
0.0912 m, and every later frame with it (`python -m tests.ba_parity_report
--isa-spread`).  So the trajectories are held by the frame-to-frame motion
out of frames without a keyframe (the reference's spread 0.016014 m, bar
0.03), their distance after a rigid alignment (spread 0.028309 m, bar
0.05) and the final window's poses relative to its oldest keyframe
(spread 0.002642, bar 5e-3); each bar is under twice the spread.

A third reference run, with no precision key on either side, holds the
port's default path against the reference's default path: window BA
assembled with the cross terms rounded to bfloat16 (solver/schur.py).  The
reference's three instruction-set settings give window BA chi 1.8736 /
1.8813 / 1.8814 at frame 1, 4.7477 / 4.7728 / 4.6895 at frame 6 and 8.3272
/ 8.5081 / 8.1963 at frame 11, so its own runs part by up to 0.41%, 1.78%
and 3.80% (`python -m tests.ba_parity_report --isa-spread`).  The port's
chi at each keyframe from frame 1 on is held within 7.6% of the
reference's, twice the largest spread; the final window relative to its
oldest keyframe within 5e-3 and the rigidly aligned distance within 0.05 m
(today's bars; the bf16 spreads are 0.005969 and 0.071647 m); the
frame-to-frame motion out of frames without a keyframe within 0.027 m
(twice the bf16 spread of 0.013578 m, under today's 0.03).  The port at f32
misses the chi bar against that run: 8.49-8.87% at frame 1.

`process_chunk` is held bit for bit against the port's own stepwise run,
and against the reference's `process_chunk` on tests/test_pipeline.py:151's
10 frames (the first 10 of the same corridor and configuration) as the
inline run is.
"""

import logging

import numpy as np
import pytest
import torch

from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.utils import evaluation as j_eval
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.pipeline import frontend, state
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import (FrontendStatus, VisualOdometry, initial_carry,
                                                         process_chunk, process_frame)
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests.torch_parity import agreement, assert_close, step_gap, t, to_numpy, tree_to_numpy, window_gap

N_FRAMES = 14
CHUNK = 10    # frames of the chunk tests (tests/test_pipeline.py:151)
HANDOVER = 7  # frames the reference runs before its carry is handed over
OVERRIDES = {
    # tests/test_pipeline.py SMALL_CAPS and SCENE_OVERRIDES
    "max_features": 320,
    "keyframe_window_capacity": 8,
    "max_active_landmarks": 1024,
    "max_landmarks": 8192,
    "num_active_keyframes": 7,
    "stereo_depth_inferior_limit": 2.0,
    "stereo_depth_superior_limit": 50.0,
    "detect_mask_half": 6,
    "gftt_min_distance": 6,
}
# The default path against the reference's (both at bf16): the bars of the
# module docstring's third reference run.
DEFAULT_CHI_RTOL = 0.076
DEFAULT_WINDOW_GAP = 5e-3
DEFAULT_STEP_GAP = 0.027
DEFAULT_ALIGNED = 0.05
# Window BA's assembly precision, on both sides of a comparison: every
# parity test of a BA run pins both packages to f32 unless it names DEFAULT,
# which leaves both at their shared default (bf16).
F32 = {"ba_assembly_precision": "f32"}
DEFAULT = {}


def _dataset(cls):
    return cls(n_frames=N_FRAMES, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


@pytest.fixture(scope="module")
def reference():
    """The reference's 14-frame BA-off run, with its carry copied to NumPy
    after HANDOVER and HANDOVER + 1 frames (its jitted step donates the
    carry, so each copy is taken before the next step)."""
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig(OVERRIDES), dataset=ds, inline_ba=False)
    assert vo.init()
    carries = {}
    for k in range(N_FRAMES):
        assert vo.step()
        if k + 1 in (HANDOVER, HANDOVER + 1):
            carries[k + 1] = tree_to_numpy(vo.carry)
    return {
        "statuses": vo.statuses(),
        "kf": np.asarray([bool(o.kf_inserted) for o in vo.outputs]),
        "T_cw": vo.trajectory_T_cw(),
        "T_wc": vo.trajectory_T_wc(),
        "carries": carries,
        "rig": tree_to_numpy(ds.rig),
        "gt_T_wc": ds.gt_T_wc,
    }


def test_dataset_renders_reference_frames():
    ref, port = _dataset(JDataset), _dataset(TDataset)
    ref.init(), port.init()
    for _ in range(2):
        a, b = ref.next_frame(), port.next_frame()
        assert a.frame_id == b.frame_id
        assert a.left.dtype == b.left.dtype == np.float32
        assert a.left.tobytes() == b.left.tobytes() and a.right.tobytes() == b.right.tobytes()
    assert float(port.rig.right.baseline) == float(ref.rig.right.baseline)
    np.testing.assert_array_equal(to_numpy(port.rig.right.pose), np.asarray(ref.rig.right.pose))


def test_state_handover(reference):
    before, after = reference["carries"][HANDOVER], reference["carries"][HANDOVER + 1]
    assert not reference["kf"][HANDOVER]  # frame 7 only tracks
    carry = state.carry_from_numpy(before)
    rig = state.rig_from_numpy(reference["rig"])
    cfg = frontend.FrontendConfig.from_config(Config(OVERRIDES))
    ds = _dataset(TDataset)
    ds.init()
    for _ in range(HANDOVER):
        ds.next_frame()
    fr = ds.next_frame()
    carry2, out = process_frame(cfg, rig, carry, t(fr.left), t(fr.right), fr.frame_id)
    assert out.status == int(reference["statuses"][HANDOVER])
    assert_close(to_numpy(out.T_cw), reference["T_cw"][HANDOVER], 1e-3)
    # KLT survivors, then pose inliers (linked before, still linked after).
    ok_ref, ok_port = after["feats"]["valid"], to_numpy(carry2.feats.valid)
    assert agreement(ok_port, ok_ref) >= 0.95
    linked = before["feats"]["lm"] >= 0
    in_ref = ok_ref & linked & (after["feats"]["lm"] >= 0)
    in_port = ok_port & linked & (to_numpy(carry2.feats.lm) >= 0)
    assert in_ref.sum() >= 30
    assert agreement(in_port, in_ref) >= 0.98
    assert_close(to_numpy(carry2.feats.uv), after["feats"]["uv"], 2e-2, where=ok_ref & ok_port)


def test_whole_slice(reference):
    ds = _dataset(TDataset)
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=ds, ba_mode="off", device="cpu")
    assert vo.init()
    vo.run()
    np.testing.assert_array_equal(vo.statuses(), reference["statuses"])
    np.testing.assert_array_equal(vo.keyframe_flags(), reference["kf"])
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    T_wc = vo.trajectory_T_wc()
    assert_close(T_wc[:, :3, 3], reference["T_wc"][:, :3, 3], 2e-2)
    gt = reference["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert j_eval.ate_rmse(reference["T_wc"][:, :3, 3], gt) < 0.15
    R = T_wc[-1, :3, :3]
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5


@pytest.fixture(scope="module")
def reference_inline():
    return run_reference_inline()


@pytest.fixture(scope="module")
def reference_default():
    return run_reference_inline(DEFAULT)


def run_reference_inline(pin=F32):
    """The reference's 14-frame run with window BA inline, at f32 or, with
    `pin=DEFAULT`, at its default precision (bf16)."""
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig({**OVERRIDES, **pin}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    return {
        "statuses": vo.statuses(),
        "kf": np.asarray([bool(o.kf_inserted) for o in vo.outputs]),
        "ba_chi": np.asarray([float(o.ba_chi) for o in vo.outputs]),
        "final_window": {k: np.asarray(getattr(vo.carry.wmap, k)) for k in ("kf_pose", "kf_valid", "kf_id")},
        "T_cw": vo.trajectory_T_cw(),
        "T_wc": vo.trajectory_T_wc(),
        "gt_T_wc": ds.gt_T_wc,
    }


def test_whole_slice_ba_inline(reference_inline):
    ref = reference_inline
    vo = VisualOdometry(config=Config({**OVERRIDES, **F32}), dataset=_dataset(TDataset), device="cpu")
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    np.testing.assert_array_equal(vo.statuses(), ref["statuses"])
    np.testing.assert_array_equal(vo.keyframe_flags(), ref["kf"])
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    kf = vo.keyframe_flags()
    ba_chi = np.asarray([float(o.ba_chi) for o in vo.outputs])
    assert np.isfinite(ba_chi[kf]).all() and np.isnan(ba_chi[~kf]).all()
    assert np.isfinite(ref["ba_chi"][kf]).all()
    assert all(o.ba.iterations >= 1 for o, k in zip(vo.outputs, kf) if k)
    T_wc = vo.trajectory_T_wc()
    assert_gauge_free_close(T_wc, ref["T_wc"], ref["kf"])
    final = {k: to_numpy(getattr(vo.carry.wmap, k)) for k in ("kf_pose", "kf_valid", "kf_id")}
    assert window_gap(final, ref["final_window"]) < 5e-3
    gt = ref["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert j_eval.ate_rmse(ref["T_wc"][:, :3, 3], gt) < 0.15


def _run_port(pin):
    vo = VisualOdometry(config=Config({**OVERRIDES, **pin}), dataset=_dataset(TDataset), device="cpu")
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    return vo


def _chi_gaps(vo, ref):
    """{keyframe frame: window BA's chi relative to the reference's}, from
    the second keyframe on: the first BA holds one keyframe and ends at a chi
    of ~1e-9, at the rounding level."""
    chi = np.asarray([float(o.ba_chi) for o in vo.outputs])
    return {int(k): abs(chi[k] - ref["ba_chi"][k]) / abs(ref["ba_chi"][k]) for k in np.nonzero(ref["kf"])[0][1:]}


def test_default_path_matches_reference_default(reference_default):
    """Both packages at their shared default (`ba_assembly_precision:
    bf16`, no override on either side): the bars of the module docstring's
    third reference run."""
    ref = reference_default
    vo = _run_port(DEFAULT)
    assert vo.ba_cfg.assembly_precision == "bf16"
    np.testing.assert_array_equal(vo.statuses(), ref["statuses"])
    np.testing.assert_array_equal(vo.keyframe_flags(), ref["kf"])
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    gaps = _chi_gaps(vo, ref)
    assert list(gaps) == [1, 6, 11] and max(gaps.values()) <= DEFAULT_CHI_RTOL, gaps
    T_wc = vo.trajectory_T_wc()
    final = {k: to_numpy(getattr(vo.carry.wmap, k)) for k in ("kf_pose", "kf_valid", "kf_id")}
    assert window_gap(final, ref["final_window"]) < DEFAULT_WINDOW_GAP
    assert step_gap(T_wc, ref["T_wc"], ref["kf"]) < DEFAULT_STEP_GAP
    assert evaluation.ate_rmse(T_wc[:, :3, 3], ref["T_wc"][:, :3, 3]) < DEFAULT_ALIGNED
    gt = ref["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15


def test_f32_port_misses_reference_default(reference_default):
    """The fault this precision repairs: the port at f32, the reference at
    its default, part in window BA's chi by more than the bar at the first
    keyframe BA (frame 1), where the reference's own spread is smallest."""
    ref = reference_default
    vo = _run_port(F32)
    np.testing.assert_array_equal(vo.keyframe_flags(), ref["kf"])
    gaps = _chi_gaps(vo, ref)
    assert gaps[1] > DEFAULT_CHI_RTOL, gaps
    assert float(vo.outputs[1].ba_chi) < ref["ba_chi"][1]


def assert_gauge_free_close(T_wc, T_wc_ref, kf):
    """The BA-inline bars of the module docstring: frame-to-frame motion out
    of frames without a keyframe within 0.03 m, rigidly aligned positions
    within 0.05 m (RMS)."""
    assert step_gap(T_wc, T_wc_ref, kf) < 0.03
    assert evaluation.ate_rmse(T_wc[:, :3, 3], T_wc_ref[:, :3, 3]) < 0.05


def _chunk_frames(cls):
    ds = _dataset(cls)
    ds.init()
    frames = [ds.next_frame() for _ in range(CHUNK)]
    return (ds, np.stack([f.left for f in frames]), np.stack([f.right for f in frames]),
            np.asarray([f.frame_id for f in frames], np.int32))


def test_chunk_equals_stepwise():
    """`process_chunk` is `process_frame` in a loop: the same bits."""
    ds, il, ir, fids = _chunk_frames(TDataset)
    cfg = frontend.FrontendConfig.from_config(Config(OVERRIDES))
    rig = ds.rig
    carry = initial_carry(cfg, il.shape[1:], torch.float32, "cpu")
    steps = []
    for k in range(CHUNK):
        carry, out = process_frame(cfg, rig, carry, t(il[k]), t(ir[k]), int(fids[k]))
        steps.append(out)
    carry2, outs = process_chunk(cfg, rig, initial_carry(cfg, il.shape[1:], torch.float32, "cpu"),
                                 t(il), t(ir), t(fids))
    assert torch.equal(outs.T_cw, torch.stack([o.T_cw for o in steps]))
    assert outs.status.tolist() == [o.status for o in steps]
    assert outs.kf_inserted.tolist() == [o.kf_inserted for o in steps] and outs.kf_inserted.dtype == torch.bool
    assert outs.n_inliers.tolist() == [o.n_inliers for o in steps]
    torch.testing.assert_close(outs.ba_chi, torch.stack([o.ba_chi for o in steps]), rtol=0, atol=0, equal_nan=True)
    assert outs.ba.iterations.shape == (CHUNK,) and outs.ba.trace.shape == (CHUNK, 0, 2)
    assert torch.equal(carry2.wmap.kf_pose, carry.wmap.kf_pose) and torch.equal(carry2.wmap.lm_pos, carry.wmap.lm_pos)
    assert outs.kf_inserted.sum() >= 3


def test_chunk_carries_the_configured_precision():
    """`process_chunk` with `VisualOdometry`'s `BAConfig` (bf16, read from
    the default config) gives the driver's own run, bit for bit."""
    ds, il, ir, fids = _chunk_frames(TDataset)
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), device="cpu")
    assert vo.init() and vo.ba_cfg.assembly_precision == "bf16"
    for _ in range(CHUNK):
        assert vo.step()
    _, outs = process_chunk(vo.frontend_cfg, vo.rig, initial_carry(vo.frontend_cfg, il.shape[1:], torch.float32, "cpu"),
                            t(il), t(ir), t(fids), vo.ba_cfg)
    np.testing.assert_array_equal(to_numpy(outs.T_cw), vo.trajectory_T_cw())
    np.testing.assert_array_equal(to_numpy(outs.ba_chi), [float(o.ba_chi) for o in vo.outputs])


def test_chunk_matches_reference():
    import jax
    import jax.numpy as jnp
    from legoslam_tpu.pipeline import frontend as j_frontend
    from legoslam_tpu.pipeline import visual_odometry as j_vo

    jds, il, ir, fids = _chunk_frames(JDataset)
    jcfg = j_frontend.FrontendConfig.from_config(JConfig({**OVERRIDES, **F32}))
    chunk = jax.jit(lambda c, l, r, f: j_vo.process_chunk(jcfg, jds.rig, c, l, r, f, inline_ba=True))
    _, jouts = chunk(j_vo.initial_carry(jcfg, il.shape[1:]), jnp.asarray(il), jnp.asarray(ir), jnp.asarray(fids))
    cfg = frontend.FrontendConfig.from_config(Config({**OVERRIDES, **F32}))
    rig = state.rig_from_numpy(tree_to_numpy(jds.rig))
    _, outs = process_chunk(cfg, rig, initial_carry(cfg, il.shape[1:], torch.float32, "cpu"), t(il), t(ir), t(fids))
    kf = to_numpy(outs.kf_inserted)
    np.testing.assert_array_equal(to_numpy(outs.status), np.asarray(jouts.status))
    np.testing.assert_array_equal(kf, np.asarray(jouts.kf_inserted))
    assert (to_numpy(outs.status) == FrontendStatus.TRACKING_GOOD).all()
    T_wc, T_wc_ref = np.linalg.inv(to_numpy(outs.T_cw)), np.linalg.inv(np.asarray(jouts.T_cw))
    assert_gauge_free_close(T_wc, T_wc_ref, kf)
    gt = jds.gt_T_wc[:CHUNK, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert j_eval.ate_rmse(T_wc_ref[:, :3, 3], gt) < 0.15


def test_ba_log_and_capacity_audit():
    """The per-frame log carries BA's chi, trace and a capacity warning, and
    the end-of-run audit sums the dropped slots (here the edge budget is
    smaller than the window's observations)."""
    config = Config({**OVERRIDES, "log_every_n_frames": 1, "ba_trace": True, "max_ba_edges": 64})
    vo = VisualOdometry(config=config, dataset=_dataset(TDataset), device="cpu")
    assert vo.init()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("legoslam.vo")
    logger.addHandler(handler)
    try:
        vo.run()
    finally:
        logger.removeHandler(handler)
    text = "\n".join(r.getMessage() for r in records)
    assert "BA chi=" in text and "BA iter 0: chi=" in text
    assert "BA capacity overflow" in text and "BA dropped" in text
    dropped = [int(o.ba.n_dropped_landmarks) for o in vo.outputs if o.kf_inserted]
    assert all(d > 0 for d in dropped)
    assert all(o.ba.trace.shape == (10, 2) for o in vo.outputs)


def test_refuses_unknown_ba_mode():
    with pytest.raises(ValueError, match="unknown ba_mode"):
        VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode="threaded", device="cpu")


def test_save_trajectory(tmp_path):
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode="off", device="cpu")
    assert vo.init()
    for _ in range(2):
        assert vo.step()
    path = tmp_path / "traj.txt"
    vo.save_trajectory(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (2, 12)
    np.testing.assert_allclose(rows.reshape(2, 3, 4), vo.trajectory_T_wc()[:, :3, :], atol=1e-6)
    assert vo.num_keyframes() == 2 and torch.is_tensor(vo.outputs[0].T_cw)


def test_default_device_is_the_card():
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode="off")
    assert vo.device.type == "cuda"


def test_default_device_never_runs_on_cpu(monkeypatch):
    """Where no card is present, init() with the default device raises
    instead of running the frames on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode="off")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vo.init()
    assert vo.carry is None and not vo.outputs
