"""The port's VO slice (window BA off) against the JAX reference.

One reference run of 14 frames of the test corridor (the scene and small
capacities of tests/test_pipeline.py) serves every check, so the reference
step compiles once:
- state handover: the reference's carry after 7 frames, converted with
  `state.carry_from_numpy`, is stepped through frame 7 (a tracking frame) by
  both; T_cw within 1e-3, inlier masks agree >= 98%, KLT success masks
  >= 95% (the bars of tests/test_pose_pallas.py and test_klt_pallas.py);
- the whole slice: statuses and keyframe flags equal on every frame,
  camera positions within 2e-2 m, both ATE < 0.15 m (test_pipeline.py:135).
"""

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
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=ds, ba_mode="off")
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


@pytest.mark.parametrize("mode", ["inline", "async", None])
def test_refuses_window_ba(mode):
    """BA modes are refused, not run without BA (the default mode is inline)."""
    with pytest.raises(NotImplementedError, match="window BA"):
        VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode=mode)


def test_save_trajectory(tmp_path):
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), ba_mode="off")
    assert vo.init()
    for _ in range(2):
        assert vo.step()
    path = tmp_path / "traj.txt"
    vo.save_trajectory(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (2, 12)
    np.testing.assert_allclose(rows.reshape(2, 3, 4), vo.trajectory_T_wc()[:, :3, :], atol=1e-6)
    assert vo.num_keyframes() == 2 and torch.is_tensor(vo.outputs[0].T_cw)
