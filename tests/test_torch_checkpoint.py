"""The port's checkpoints (utils/checkpoint.py, `VisualOdometry.save_checkpoint`
/ `load_checkpoint`) against the JAX package's file format and runs.

The corridor is tests/test_torch_vo.py's (12 frames, small capacities), with
window BA inline at `ba_assembly_precision: f32` in both packages.  A port
run resumed from its own checkpoint after 6 frames equals the uninterrupted
run bit for bit on the CPU.  A checkpoint the reference writes after 6 frames
resumes in the port, and one the port writes resumes in the reference; each
resumed run is held to the other package's uninterrupted run at the VO
parity bars (tests/test_torch_vo.py: statuses and keyframe flags equal,
camera positions within 5e-2 m).  Saving drains the loop hook only, so with
loop closure off the run that saved goes on as if it had not.
"""

import numpy as np
import pytest
import torch

from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.state import carry_to_numpy
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.utils import checkpoint
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_vo import F32, OVERRIDES

N = 12
STOP = 6
POS_ATOL = 5e-2


def _dataset(cls):
    return cls(n_frames=N, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)


def _port(**kw):
    vo = VisualOdometry(config=Config({**OVERRIDES, **F32, **kw}), dataset=_dataset(TDataset), device="cpu")
    assert vo.init()
    return vo


def _reference():
    vo = JVisualOdometry(config=JConfig({**OVERRIDES, **F32}), dataset=_dataset(JDataset))
    assert vo.init()
    return vo


def _run_saving(vo, path):
    """Step STOP frames, save a checkpoint to `path`, step to the end."""
    for _ in range(STOP):
        assert vo.step()
    vo.save_checkpoint(path)
    while vo.step():
        pass


def _held(statuses, kf, T_wc, ref_statuses, ref_kf, ref_T_wc):
    np.testing.assert_array_equal(statuses, ref_statuses)
    np.testing.assert_array_equal(kf, ref_kf)
    np.testing.assert_allclose(T_wc[:, :3, 3], ref_T_wc[:, :3, 3], rtol=0, atol=POS_ATOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's and the reference's uninterrupted runs, each saving a
    checkpoint after STOP frames on the way."""
    d = tmp_path_factory.mktemp("ckpt")
    port, ref = _port(), _reference()
    _run_saving(port, str(d / "port.npz"))
    _run_saving(ref, str(d / "ref.npz"))
    return {"dir": d, "port": port, "ref": ref}


def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": [np.asarray(3, np.int32), None, (np.ones(2),)]}
    p = checkpoint.save_pytree(str(tmp_path / "t"), tree, meta={"k": 1})
    assert p.endswith("t.npz")
    out, meta = checkpoint.load_pytree(str(tmp_path / "t"), tree)
    assert meta == {"k": 1} and out["b"][1] is None
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert out["b"][0].dtype == np.int32 and int(out["b"][0]) == 3
    np.testing.assert_array_equal(out["b"][2][0], np.ones(2))


def test_pytree_mismatch_fails(tmp_path):
    p = checkpoint.save_pytree(str(tmp_path / "t.npz"), {"a": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.load_pytree(p, {"a": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.load_pytree(p, {"a": np.zeros((2, 2), np.int32)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(p, {"a": np.zeros((2, 2), np.float32), "b": np.zeros(1)})


def test_vo_checkpoint_mismatch_fails(runs):
    """A VO with other capacities refuses the checkpoint; one that ran no
    frame has nothing to save."""
    vo = _port(max_features=256)
    with pytest.raises(ValueError, match="leaf"):
        vo.load_checkpoint(str(runs["dir"] / "port.npz"))
    with pytest.raises(ValueError, match="no frames"):
        _port().save_checkpoint(str(runs["dir"] / "x.npz"))


def test_leaves_follow_the_reference_flatten_order(runs):
    """Both packages write the same leaves, in the same order, shapes and
    dtypes, with the same metadata keys."""
    import jax

    meta_p = checkpoint.read_meta(str(runs["dir"] / "port.npz"))
    meta_r = checkpoint.read_meta(str(runs["dir"] / "ref.npz"))
    assert meta_p["n_leaves"] == meta_r["n_leaves"] and meta_p["user"].keys() == meta_r["user"].keys()
    assert meta_p["user"]["frame_ids"] == meta_r["user"]["frame_ids"] == list(range(STOP))
    assert meta_p["user"]["next_index"] == meta_r["user"]["next_index"] == STOP
    with np.load(runs["dir"] / "port.npz") as p, np.load(runs["dir"] / "ref.npz") as r:
        for i in range(meta_r["n_leaves"]):
            a, b = p[f"leaf_{i:04d}"], r[f"leaf_{i:04d}"]
            assert a.shape == b.shape and a.dtype == b.dtype, i
    carry = carry_to_numpy(runs["port"].carry)
    assert len(checkpoint._flatten(carry)) == len(jax.tree_util.tree_leaves(runs["ref"].carry))


def test_resume_equals_uninterrupted_run(runs):
    """Bit for bit on the CPU, frame ids and the dataset's cursor included."""
    full = runs["port"]
    vo = _port()
    vo.load_checkpoint(str(runs["dir"] / "port.npz"))
    assert vo.dataset.current_index == STOP and len(vo.outputs) == STOP and vo.frame_ids == list(range(STOP))
    assert vo.frontend_status() == full.outputs[STOP - 1].status
    while vo.step():
        pass
    assert vo.frame_ids == full.frame_ids
    np.testing.assert_array_equal(vo.trajectory_T_cw(), full.trajectory_T_cw())
    np.testing.assert_array_equal(vo.statuses(), full.statuses())
    assert torch.equal(vo.carry.wmap.lm_pos, full.carry.wmap.lm_pos)
    np.testing.assert_array_equal([float(o.ba_chi) for o in vo.outputs], [float(o.ba_chi) for o in full.outputs])


def test_reference_checkpoint_resumes_in_port(runs):
    ref = runs["ref"]
    vo = _port()
    vo.load_checkpoint(str(runs["dir"] / "ref.npz"))
    assert vo.dataset.current_index == STOP
    while vo.step():
        pass
    assert vo.frame_ids == list(ref.frame_ids)
    _held(vo.statuses(), vo.keyframe_flags(), vo.trajectory_T_wc(),
          np.asarray(ref.statuses()), np.asarray([bool(o.kf_inserted) for o in ref.outputs]), ref.trajectory_T_wc())


def test_port_checkpoint_resumes_in_reference(runs):
    port = runs["port"]
    ref = _reference()
    ref.load_checkpoint(str(runs["dir"] / "port.npz"))
    assert ref.dataset.current_index == STOP
    ref.run()
    assert list(ref.frame_ids) == port.frame_ids
    _held(np.asarray(ref.statuses()), np.asarray([bool(o.kf_inserted) for o in ref.outputs]), ref.trajectory_T_wc(),
          port.statuses(), port.keyframe_flags(), port.trajectory_T_wc())


def test_resume_reads_the_precision_from_the_config(runs):
    """A checkpoint holds no config, in the reference as here, so a resumed
    run assembles window BA at the precision of the config it was made with:
    the f32 run's checkpoint resumed under the default (bf16) goes on at
    bf16, and its BA chi parts from the f32 run's from the first keyframe
    after the resume."""
    import json

    meta = checkpoint.read_meta(str(runs["dir"] / "port.npz"))
    assert "assembly" not in json.dumps(meta)
    full = runs["port"]
    assert full.ba_cfg.assembly_precision == "f32"
    vo = VisualOdometry(config=Config(OVERRIDES), dataset=_dataset(TDataset), device="cpu")
    assert vo.init()
    vo.load_checkpoint(str(runs["dir"] / "port.npz"))
    assert vo.ba_cfg.assembly_precision == "bf16"
    while vo.step():
        pass
    chi, chi_full = ([float(o.ba_chi) for o in r.outputs] for r in (vo, full))
    np.testing.assert_array_equal(chi[:STOP], chi_full[:STOP])
    first = STOP + int(np.argmax(full.keyframe_flags()[STOP:]))
    assert full.keyframe_flags()[first] and vo.keyframe_flags()[first]
    assert np.isfinite(chi[first]) and chi[first] != chi_full[first]
