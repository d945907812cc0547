"""The port's utilities against the JAX package's: evaluation
(utils/evaluation.py), `CumulativeTimer` (utils/timer.py), `Config.from_yaml`
(utils/config.py) and the headless viewer (pipeline/viewer.py), plus the
driver's viewer stream and its dataset from `dataset_dir`.

Evaluation is NumPy float64 in both packages; results agree to 1e-9, the TUM
quaternions (float32 in the reference) to 1e-6.  The viewers render the same
stream to the same file list.
"""

import logging
import os

import numpy as np
import pytest
import yaml

from legoslam_tpu.pipeline.viewer import Viewer as JViewer
from legoslam_tpu.utils import evaluation as j_eval
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu.utils.timer import CumulativeTimer as JCumulativeTimer
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.pipeline.viewer import Viewer
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from legoslam_tpu_torch.utils.timer import CumulativeTimer
from tests.test_torch_vo import OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trajectories(n=60, seed=3):
    """(est, gt) world-from-camera poses: a curved drive and a drifted copy."""
    from legoslam_tpu_torch.geometry import se3

    import torch

    rng = np.random.default_rng(seed)
    xi = np.zeros((n, 6))
    xi[:, 2] = 0.8
    xi[:, 4] = 0.01 * np.sin(np.arange(n) / 7.0)
    steps = se3.se3_exp(torch.from_numpy(xi)).numpy()
    gt = [np.eye(4)]
    for s in steps[:-1]:
        gt.append(gt[-1] @ s)
    gt = np.stack(gt)
    noise = se3.se3_exp(torch.from_numpy(rng.normal(0, [0.05] * 3 + [0.004] * 3, (n, 6)))).numpy()
    est = np.stack([g @ e for g, e in zip(gt, noise)])
    est[:, :3, 3] = est[:, :3, 3] * 1.02 + np.array([0.3, -0.1, 0.2])
    return est, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_and_ate(with_scale):
    est, gt = _trajectories()
    R, t, c = evaluation.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale)
    jR, jt, jc = j_eval.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale)
    np.testing.assert_allclose(R, jR, atol=1e-12)
    np.testing.assert_allclose(t, jt, atol=1e-12)
    assert abs(c - jc) < 1e-12 and (c != 1.0) == with_scale
    for align in (True, False):
        assert abs(evaluation.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align)
                   - j_eval.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align)) < 1e-12


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_and_drift(delta):
    est, gt = _trajectories()
    np.testing.assert_allclose(evaluation.rpe_rmse(est, gt, delta), j_eval.rpe_rmse(est, gt, delta), atol=1e-12)
    for seg in (10.0, 100.0):
        d = evaluation.drift_rate(est, gt, seg)
        assert d > 0 and abs(d - j_eval.drift_rate(est, gt, seg)) < 1e-9
    assert evaluation.drift_rate(est[:1], gt[:1]) == j_eval.drift_rate(est[:1], gt[:1]) == 0.0


def test_trajectory_files(tmp_path):
    est, _ = _trajectories(n=12)
    evaluation.save_kitti_trajectory(str(tmp_path / "p.txt"), est)
    j_eval.save_kitti_trajectory(str(tmp_path / "j.txt"), est)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    with open(tmp_path / "p.txt", "a") as f:
        f.write("a comment line\n")
    loaded = evaluation.load_kitti_trajectory(str(tmp_path / "p.txt"))
    np.testing.assert_allclose(np.stack(loaded), np.stack(j_eval.load_kitti_trajectory(str(tmp_path / "j.txt"))),
                               atol=0)
    np.testing.assert_allclose(np.stack(loaded), est, atol=1e-8)
    ts = [float(i) for i in range(12)]
    evaluation.save_tum_trajectory(str(tmp_path / "p.tum"), ts, est)
    j_eval.save_tum_trajectory(str(tmp_path / "j.tum"), ts, est)
    p, jt = np.loadtxt(tmp_path / "p.tum"), np.loadtxt(tmp_path / "j.tum")
    np.testing.assert_allclose(p[:, :4], jt[:, :4], atol=1e-9)
    np.testing.assert_allclose(p[:, 4:], jt[:, 4:], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(p[:, 4:], axis=1), 1.0, atol=1e-9)


def test_cumulative_timer():
    timers, ref = CumulativeTimer(), JCumulativeTimer()
    for name, ms in (("b", 2.0), ("a", 1.5), ("b", 4.0)):
        timers.add(name, ms)
        ref.add(name, ms)
    assert timers.report() == ref.report()
    assert timers.total_ms("b") == 6.0 and timers.mean_ms("b") == 3.0 and timers.mean_ms("none") == 0.0
    with timers.section("s", block_on=[{"x": np.zeros(2)}]):
        sum(range(1000))
    with timers.section("s"):
        pass
    assert timers.mean_ms("s") >= 0.0 and "s: total=" in timers.report()


@pytest.mark.parametrize("name", ["kitti_00.yaml", "kitti_05.yaml"])
def test_from_yaml(name):
    path = os.path.join(REPO, "config", name)
    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = Config.from_yaml(path)
    for k, v in raw.items():
        assert cfg[k] == v and type(cfg[k]) is type(v), k
    ref = JConfig.from_yaml(path)
    for k in cfg.as_dict():
        if k in ref:
            assert cfg[k] == ref[k], k


def _stream(viewer, n=7, every=3):
    """A VO-like stream: poses every frame, overlays every `every` frames,
    two map snapshots."""
    rng = np.random.default_rng(1)
    for i in range(n):
        T = np.eye(4)
        T[2, 3] = -0.5 * i
        if i % every == 0:
            viewer.add_current_frame(T, rng.uniform(0, 255, (40, 64)), rng.uniform(0, 60, (20, 2)),
                                     np.arange(20) % 3 > 0)
        else:
            viewer.add_current_frame(T)
        if i in (2, 5):
            kf = np.tile(np.eye(4), (4, 1, 1))
            viewer.update_map(kf, np.array([1, 1, 0, 1], bool), rng.normal(0, 5, (50, 3)), rng.random(50) > 0.3)


def test_viewer_writes_the_reference_files(tmp_path):
    out = {}
    for name, cls in (("port", Viewer), ("ref", JViewer)):
        vw = cls(every_n=3)
        _stream(vw)
        paths = vw.save(str(tmp_path / name), ground_truth=np.tile(np.eye(4), (7, 1, 1)))
        out[name] = sorted(os.path.relpath(p, tmp_path / name) for p in paths)
        assert all(os.path.getsize(p) > 0 for p in paths)
    assert out["port"] == out["ref"]
    assert "trajectory.png" in out["port"] and "tracking.gif" in out["port"] and len(out["port"]) == 5


def test_viewer_without_matplotlib(tmp_path, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    vw = Viewer()
    _stream(vw)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with caplog.at_level(logging.WARNING, logger="legoslam.viewer"):
        assert vw.save(str(tmp_path / "none")) == []
    assert not (tmp_path / "none").exists()


def _corridor(n):
    return SyntheticPlanesDataset(n_frames=n, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


def test_driver_feeds_the_viewer(tmp_path):
    """`viewer_every_n > 0`: a feature overlay every N frames, a map snapshot
    per keyframe, the stream rendered by `save_visualization`."""
    vo = VisualOdometry(config=Config({**OVERRIDES, "viewer_every_n": 2}), dataset=_corridor(5), ba_mode="off",
                        device="cpu")
    assert vo.init()
    vo.run()
    vw = vo.viewer
    assert len(vw.trajectory) == 5 and [r.index for r in vw.frames] == [0, 2, 4]
    assert len(vw.map_history) == int(vo.keyframe_flags().sum()) >= 2
    assert all(len(r.features) > 30 for r in vw.frames)
    paths = vo.save_visualization(str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == ["frame_00000.png", "frame_00002.png", "frame_00004.png",
                                                         "tracking.gif", "trajectory.png"]
    assert len(vw.map_history) == int(vo.keyframe_flags().sum()) + 1   # the final state is added
    vo.save_trajectory(str(tmp_path / "t.tum"), fmt="tum")
    assert np.loadtxt(tmp_path / "t.tum").shape == (5, 8)
    with pytest.raises(ValueError, match="format"):
        vo.save_trajectory(str(tmp_path / "t.x"), fmt="x")


def test_final_state_visualization(tmp_path):
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_corridor(3), ba_mode="off", device="cpu")
    assert vo.init()
    vo.run()
    paths = vo.save_visualization(str(tmp_path), last_frame=np.zeros((160, 240)))
    assert sorted(os.path.basename(p) for p in paths) == ["features.png", "trajectory.png"]


def test_init_reads_dataset_dir(tmp_path):
    """Without a dataset, `init()` reads `dataset_dir` as a KITTI sequence."""
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset, write_kitti_frame, write_kitti_sequence

    ds = _corridor(3)
    ds.init()
    f, cx, cy = 260.0, 120.0, 80.0
    P0 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -f * 0.54
    write_kitti_sequence(str(tmp_path), P0, P1, ds.gt_T_wc)
    for i in range(3):
        fr = ds.next_frame()
        write_kitti_frame(str(tmp_path), i, fr.left, fr.right)
    vo = VisualOdometry(config=Config({**OVERRIDES, "dataset_dir": str(tmp_path), "image_scale": 1.0}),
                        ba_mode="off", device="cpu")
    assert vo.init() and isinstance(vo.dataset, KittiDataset)
    assert vo.dataset.rig.right.baseline == pytest.approx(0.54)
    vo.run()
    assert len(vo.outputs) == 3 and vo.statuses()[-1] == 1   # the 8-bit frames track
    np.testing.assert_allclose(vo.dataset.ground_truth, ds.gt_T_wc, atol=1e-9)
    assert not VisualOdometry(config=Config({"dataset_dir": str(tmp_path / "none")}), device="cpu").init()


def test_synthetic_dataset_equals_reference():
    """The blob-cloud world renders to the same bytes in both packages."""
    from legoslam_tpu.pipeline.dataset import SyntheticDataset as JSynthetic
    from legoslam_tpu_torch.pipeline.dataset import SyntheticDataset

    kw = dict(n_frames=3, shape=(60, 90), n_points=400, seed=4)
    ds, ref = SyntheticDataset(**kw), JSynthetic(**kw)
    assert ds.init() and ref.init()
    np.testing.assert_array_equal(ds.ground_truth, ref.ground_truth)
    assert ds.rig.right.baseline == float(ref.rig.right.baseline)
    while (fr := ds.next_frame()) is not None:
        jf = ref.next_frame()
        assert fr.frame_id == jf.frame_id
        np.testing.assert_array_equal(fr.left, jf.left)
        np.testing.assert_array_equal(fr.right, jf.right)
    assert ref.next_frame() is None
