"""The reference modes of the port against the JAX reference: `track_mode:
frame`, `stereo_matcher: klt`, `klt_inverse`, `lm_engine: blocks`,
`lm_strategy: strategy1` (tests/test_reference_modes.py).

Two reference runs of the 14-frame test corridor (tests/test_torch_vo.py's
scene and small capacities, window BA inline at `ba_assembly_precision:
f32`), one with `track_mode: frame`, one with `stereo_matcher: klt`, serve:
- the units on a handed-over carry: the reference's carry after 7 frames of
  the frame-mode run (`state.carry_from_numpy`) goes through
  `track_last_frame` (frame mode with its forward-backward gate) and
  `find_features_in_right` (klt) in both packages; success masks agree
  >= 95%, positions within 5e-2 px where both succeed (the pyramid bars of
  tests/test_torch_klt.py; a lane at a squared gate threshold may fall
  either way);
- the whole slice: statuses and keyframe flags equal on every frame, both
  ATE < 0.15 m, and the two trajectories within 5e-2 m of each other (RMSE)
  after a rigid alignment.  The alignment is needed because the window's
  gauge is free (every window pose is free, tests/test_torch_backend.py):
  each BA may move the window by a rigid motion that depends on the order
  of its sums, and the frames after it follow.  Unaligned, the runs part by
  0.058 m (frame) and 0.048 m (klt) at frame 2, after the first BA with
  two keyframes, and by at most 0.143 m and 0.068 m; aligned, by 0.016 m
  and 0.017 m.

`klt_inverse`, `blocks_engine` and `strategy1` run through the port's
driver alone under the gates of tests/test_reference_modes.py:37-48 (their
units have parity tests in test_torch_klt*.py, test_torch_schur.py and
test_torch_backend.py).  `strategy1` has an ATE bar of 0.25 m, not 0.15 m:
its damping (1e-5 and falling) holds the free gauge so loosely that every
BA moves the window by decimetres at equal chi, in both packages (on this
corridor the reference ends at ATE 0.027 m with bf16 assembly, 0.069 m with
f32, the port at 0.171 m, with BA chi 7.55, 7.77 and 7.38 on the last
keyframe).  So all three also hold the motion between consecutive frames
to the ground truth's within 0.1 m on every frame that does not follow a
keyframe, which no gauge jump touches (measured at most 0.060 m, where
strategy1 jumps 0.279 m on a frame after a keyframe).

That explanation is itself held against the reference
(`test_strategy1_differs_from_reference_by_gauge_only`): a third reference
run, under `strategy1`, must agree with the port in everything a rigid
motion of the window cannot touch.  Statuses, keyframe flags and keyframe
ids are equal; the BA chi of every keyframe agrees within 10% (measured
1.702 / 1.702, 4.203 / 4.362, 7.377 / 7.774); the motion between
consecutive frames agrees within 0.03 m on every frame that does not follow
a keyframe (measured at most 0.017 m), while on the three frames that do,
the two runs part by 0.103, 0.275 and 0.311 m and the reference itself
jumps 0.089 and 0.211 m off the ground truth; and the final window's
keyframe poses relative to its oldest keyframe agree within 0.02
(measured 0.006).
As whole trajectories the two runs are 0.198 m apart after a rigid
alignment, so the 0.05 m bar of the frame and klt modes cannot hold here.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from legoslam_tpu.ops import pyramid as j_pyr
from legoslam_tpu.pipeline import frontend as j_frontend
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.utils import evaluation as j_eval
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.ops import pyramid as t_pyr
from legoslam_tpu_torch.pipeline import frontend, state
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_vo import F32, N_FRAMES, OVERRIDES, _dataset
from tests.torch_parity import agreement, assert_close, j, t, to_numpy, tree_to_numpy

HANDOVER = 7
WINDOW_REL_BAR = 0.02  # entries of T_k T_oldest^-1 over the final window
MODES = {
    "frame_tracking": dict(track_mode="frame"),
    "klt_stereo": dict(stereo_matcher="klt"),
    "klt_inverse": dict(klt_inverse=True),
    "blocks_engine": dict(lm_engine="blocks"),
    "strategy1": dict(lm_strategy="strategy1"),
}


def run_reference(mode, handover=None):
    """The reference's 14-frame inline-BA run in `mode`; with `handover`,
    its carry (and the jitted step's input frame) copied after that many
    frames."""
    ds = _dataset(JDataset)
    vo = JVisualOdometry(config=JConfig({**OVERRIDES, **F32, **MODES[mode]}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    carry = None
    for k in range(N_FRAMES):
        assert vo.step()
        if k + 1 == handover:
            carry = tree_to_numpy(vo.carry)
    return {
        "statuses": vo.statuses(),
        "kf": np.asarray([bool(o.kf_inserted) for o in vo.outputs]),
        "T_wc": vo.trajectory_T_wc(),
        "ba_chi": np.asarray([float(o.ba_chi) for o in vo.outputs]),
        "gt_T_wc": ds.gt_T_wc,
        "carry": carry,
        "rig": ds.rig,
    }


@pytest.fixture(scope="module")
def reference_frame():
    return run_reference("frame_tracking", handover=HANDOVER)


@pytest.fixture(scope="module")
def reference_klt_stereo():
    return run_reference("klt_stereo")


@pytest.fixture(scope="module")
def reference_strategy1():
    return run_reference("strategy1", handover=N_FRAMES)


def _run_port(mode):
    ds = _dataset(TDataset)
    vo = VisualOdometry(config=Config({**OVERRIDES, **F32, **MODES[mode]}), dataset=ds, device="cpu")
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    return vo, ds


def _frames(index):
    ds = _dataset(TDataset)
    ds.init()
    for _ in range(index):
        ds.next_frame()
    return ds.next_frame()


def _jfeats(d):
    return j_frontend.Features(**{k: jnp.asarray(v) for k, v in d.items()})


def test_track_last_frame_frame_mode(reference_frame):
    d = reference_frame["carry"]
    carry = state.carry_from_numpy(d)
    rig = state.rig_from_numpy(tree_to_numpy(reference_frame["rig"]))
    cfg = frontend.FrontendConfig.from_config(Config({**OVERRIDES, **MODES["frame_tracking"]}))
    jcfg = j_frontend.FrontendConfig.from_config(JConfig({**OVERRIDES, **MODES["frame_tracking"]}))
    assert cfg.track_mode == jcfg.track_mode == "frame" and cfg.track_fb_threshold == jcfg.track_fb_threshold > 0
    fr = _frames(HANDOVER)
    T_prior = se3.se3_orthonormalize(carry.rel_motion @ carry.T_cur)
    pyr_cur = tuple(t_pyr.build_pyramid(t(fr.left), cfg.klt.levels))
    out = frontend.track_last_frame(cfg, rig, carry.pyr_last, pyr_cur, carry.feats, carry.wmap.lm_pos, T_prior,
                                    rel_motion=carry.rel_motion)
    jpyr_cur = tuple(j_pyr.build_pyramid(j(fr.left), jcfg.klt.levels))
    ref = j_frontend.track_last_frame(
        jcfg._replace(klt=jcfg.klt._replace(backend="xla")), reference_frame["rig"],
        tuple(jnp.asarray(p) for p in d["pyr_last"]), jpyr_cur, _jfeats(d["feats"]), jnp.asarray(d["wmap"]["lm_pos"]),
        j(to_numpy(T_prior)), rel_motion=jnp.asarray(d["rel_motion"]))
    ok_p, ok_r = to_numpy(out.valid), np.asarray(ref.valid)
    assert d["feats"]["valid"].sum() > 100 and ok_r.sum() > 60
    assert agreement(ok_p, ok_r) >= 0.95
    assert_close(to_numpy(out.uv), np.asarray(ref.uv), 5e-2, where=ok_p & ok_r)
    assert not to_numpy(out.has_right).any()
    # the gate bites: without it more lanes survive, in both packages
    loose = frontend.track_last_frame(cfg._replace(track_fb_threshold=0.0), rig, carry.pyr_last, pyr_cur,
                                      carry.feats, carry.wmap.lm_pos, T_prior, rel_motion=carry.rel_motion)
    assert to_numpy(loose.valid).sum() >= ok_p.sum()
    assert (to_numpy(loose.valid) | ~ok_p).all()


def test_find_features_in_right_klt(reference_frame):
    """The klt stereo matcher on the handed-over features (they lie in the
    last frame, whose left pyramid the carry holds)."""
    d = reference_frame["carry"]
    carry = state.carry_from_numpy(d)
    rig = state.rig_from_numpy(tree_to_numpy(reference_frame["rig"]))
    cfg = frontend.FrontendConfig.from_config(Config({**OVERRIDES, **MODES["klt_stereo"]}))
    jcfg = j_frontend.FrontendConfig.from_config(JConfig({**OVERRIDES, **MODES["klt_stereo"]}))
    assert cfg.stereo_matcher == "klt" and cfg.stereo_fb_threshold == jcfg.stereo_fb_threshold > 0
    fr = _frames(HANDOVER - 1)
    pyr_r = tuple(t_pyr.build_pyramid(t(fr.right), cfg.klt.levels))
    out = frontend.find_features_in_right(cfg, rig, carry.pyr_last, pyr_r, carry.feats, carry.wmap.lm_pos, carry.T_cur)
    ref = j_frontend.find_features_in_right(
        jcfg._replace(klt=jcfg.klt._replace(backend="xla")), reference_frame["rig"],
        tuple(jnp.asarray(p) for p in d["pyr_last"]), tuple(j_pyr.build_pyramid(j(fr.right), jcfg.klt.levels)),
        _jfeats(d["feats"]), jnp.asarray(d["wmap"]["lm_pos"]), jnp.asarray(d["T_cur"]))
    ok_p, ok_r = to_numpy(out.has_right), np.asarray(ref.has_right)
    assert ok_r.sum() > 40
    assert agreement(ok_p, ok_r) >= 0.95
    assert_close(to_numpy(out.uv_r), np.asarray(ref.uv_r), 5e-2, where=ok_p & ok_r)
    # rectified rig: matches lie on the same row, to the left
    dy = np.abs(to_numpy(out.uv_r)[:, 1] - to_numpy(out.uv)[:, 1])[ok_p]
    assert np.median(dy) < 0.2 and (to_numpy(out.uv_r)[ok_p, 0] < to_numpy(out.uv)[ok_p, 0]).mean() > 0.9
    np.testing.assert_array_equal(to_numpy(out.uv), d["feats"]["uv"])


def test_unknown_modes_raise():
    cfg = frontend.FrontendConfig()
    with pytest.raises(ValueError, match="track_mode"):
        frontend.track_last_frame(cfg._replace(track_mode="flow"), None, None, None, None, None, None)
    with pytest.raises(ValueError, match="stereo_matcher"):
        frontend.find_features_in_right(cfg._replace(stereo_matcher="sgm"), None, None, None,
                                        state.Features.empty(cfg.caps), None, None)


@pytest.mark.parametrize("mode", ["frame_tracking", "klt_stereo"])
def test_mode_matches_reference(mode, request):
    ref = request.getfixturevalue("reference_frame" if mode == "frame_tracking" else "reference_klt_stereo")
    vo, ds = _run_port(mode)
    np.testing.assert_array_equal(vo.statuses(), ref["statuses"])
    np.testing.assert_array_equal(vo.keyframe_flags(), ref["kf"])
    assert (vo.statuses() != FrontendStatus.LOST).all()
    assert (vo.statuses()[2:] == FrontendStatus.TRACKING_GOOD).all()
    T_wc = vo.trajectory_T_wc()
    assert evaluation.ate_rmse(T_wc[:, :3, 3], ref["T_wc"][:, :3, 3]) < 5e-2  # rigidly aligned
    gt = ref["gt_T_wc"][:, :3, 3]
    assert evaluation.ate_rmse(T_wc[:, :3, 3], gt) < 0.15
    assert j_eval.ate_rmse(ref["T_wc"][:, :3, 3], gt) < 0.15
    assert np.isfinite([float(o.ba_chi) for o in vo.outputs]).any()


@pytest.mark.parametrize("mode", ["klt_inverse", "blocks_engine", "strategy1"])
def test_reference_mode_end_to_end(mode):
    vo, ds = _run_port(mode)
    statuses = vo.statuses()
    assert (statuses != FrontendStatus.LOST).all(), (mode, statuses)
    assert (statuses[2:] == FrontendStatus.TRACKING_GOOD).all(), (mode, statuses)
    T_wc = vo.trajectory_T_wc()
    ate = evaluation.ate_rmse(T_wc[:, :3, 3], ds.gt_T_wc[:, :3, 3])
    assert ate < (0.25 if mode == "strategy1" else 0.15), (mode, ate)
    assert np.isfinite([float(o.ba_chi) for o in vo.outputs]).any(), mode
    # frame-to-frame motion, on the frames that do not follow a keyframe
    step = np.linalg.inv(T_wc[:-1]) @ T_wc[1:]
    gt_step = np.linalg.inv(ds.gt_T_wc[:-1]) @ ds.gt_T_wc[1:]
    quiet = ~vo.keyframe_flags()[:-1]
    assert quiet.sum() >= 8
    assert np.abs(step[quiet, :3, 3] - gt_step[quiet, :3, 3]).max() < 0.1, mode


def test_strategy1_differs_from_reference_by_gauge_only(reference_strategy1):
    ref = reference_strategy1
    vo, ds = _run_port("strategy1")
    np.testing.assert_array_equal(vo.statuses(), ref["statuses"])
    kf = vo.keyframe_flags()
    np.testing.assert_array_equal(kf, ref["kf"])
    chi = np.asarray([float(o.ba_chi) for o in vo.outputs])
    assert kf.sum() >= 4 and np.isfinite(chi[kf]).all()
    np.testing.assert_allclose(chi[kf], ref["ba_chi"][kf], rtol=0.1, atol=1e-3)
    T_wc = vo.trajectory_T_wc()
    step = np.linalg.inv(T_wc[:-1]) @ T_wc[1:]
    ref_step = np.linalg.inv(ref["T_wc"][:-1]) @ ref["T_wc"][1:]
    apart = np.linalg.norm(step[:, :3, 3] - ref_step[:, :3, 3], axis=-1)
    assert apart[~kf[:-1]].max() < 0.03
    # the final window, up to its rigid placement
    wmap, d = vo.carry.wmap, ref["carry"]["wmap"]
    valid = d["kf_valid"]
    np.testing.assert_array_equal(to_numpy(wmap.kf_valid), valid)
    np.testing.assert_array_equal(to_numpy(wmap.kf_id), d["kf_id"])
    oldest = int(np.argmin(np.where(valid, d["kf_id"], np.iinfo(np.int32).max)))

    def relative(T):
        T = np.asarray(T, np.float64)
        return (T @ np.linalg.inv(T[oldest]))[valid]

    rel_p, rel_r = relative(to_numpy(wmap.kf_pose)), relative(d["kf_pose"])
    assert valid.sum() >= 3
    assert np.abs(rel_p - rel_r).max() < WINDOW_REL_BAR
