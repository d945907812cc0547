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
`ba_assembly_precision: f32`, holds the port's default path: statuses and
keyframe flags equal on every frame, camera positions within 5e-2 m (the
bar the reference holds its own two schedules to, test_pipeline.py:191),
both ATE < 0.15 m (test_pipeline.py:145), a finite BA chi on every
keyframe frame.
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
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry, process_frame
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests.torch_parity import agreement, assert_close, t, to_numpy, tree_to_numpy

N_FRAMES = 14
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


def run_reference_inline():
    """The reference's 14-frame run with window BA inline at f32."""
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig({**OVERRIDES, "ba_assembly_precision": "f32"}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    return {
        "statuses": vo.statuses(),
        "kf": np.asarray([bool(o.kf_inserted) for o in vo.outputs]),
        "ba_chi": np.asarray([float(o.ba_chi) for o in vo.outputs]),
        "T_cw": vo.trajectory_T_cw(),
        "T_wc": vo.trajectory_T_wc(),
        "gt_T_wc": ds.gt_T_wc,
    }


def test_whole_slice_ba_inline(reference_inline):
    ref = reference_inline
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), device="cpu")
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
    assert_close(T_wc[:, :3, 3], ref["T_wc"][:, :3, 3], 5e-2)
    gt = ref["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert j_eval.ate_rmse(ref["T_wc"][:, :3, 3], gt) < 0.15


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


@pytest.mark.parametrize("mode", ["async"])
def test_refuses_window_ba(mode):
    """Async BA is refused, not run without BA."""
    with pytest.raises(NotImplementedError, match="window BA"):
        VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode=mode, device="cpu")


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
