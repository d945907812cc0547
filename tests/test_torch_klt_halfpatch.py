"""Parity of the port with the JAX reference at the half-patches, edge counts
and depths the card's kernels widened to take (klt_half_patch 0..9,
max_features above 4,096, klt_pyramid_levels above 8).

The port's plain versions (which the card's kernels reproduce bit for bit,
tests/test_torch_kernels_gpu.py) against the reference at h = 1, 5 and 9,
at the bars tests/test_torch_klt.py and tests/test_torch_klt_frame.py use
at h = 3: anchors 1e-3; one anchored level against the XLA path and the
Pallas level kernel in interpret mode, masks agree > 97% and positions
within 2e-2 px; the anchored pyramid with its ZNCC gate and the frame-mode
pyramid, > 95% and 5e-2 px.  The bilinear sampler (`interp.sample_patches`,
whose row pass XLA fuses on some image shapes) gives the reference's
`sample_patches_matmul` bits at those half-patches on every level of the
driver's 188x620 pyramid.  Scanline stereo at h = 5: test_torch_ops.py's
bars (masks >= 97%, 2e-2 px).  The plain pose at 8,192 edges: test_torch_pose's
bars (T within 1e-3, masks > 98%, |dn_in| <= max(3, 2%)).  A 6-frame
`VisualOdometry` run at klt_half_patch 5 (BA off): statuses and keyframe
flags equal, camera positions within 2e-2 m (test_torch_vo.py's bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.ops import detect as j_detect
from legoslam_tpu.ops import interp as j_interp
from legoslam_tpu.ops import klt as j_klt
from legoslam_tpu.ops import klt_pallas
from legoslam_tpu.ops import pyramid as j_pyr
from legoslam_tpu.ops import stereo as j_stereo
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu.utils.config import Config as JConfig
from legoslam_tpu_torch.kernels import klt as klt_k
from legoslam_tpu_torch.kernels import pose as pose_k
from legoslam_tpu_torch.ops import interp as t_interp
from legoslam_tpu_torch.ops import klt as t_klt
from legoslam_tpu_torch.ops import pyramid as t_pyr
from legoslam_tpu_torch.ops import stereo as t_stereo
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_pose import J_INTR, T_INTR, _problem
from tests.test_torch_vo import OVERRIDES
from tests.torch_parity import agreement, assert_close, j, t, to_numpy

HALF_PATCHES = [1, 5, 9]


def _scene(seed, H=94, W=310, n=64, margin=15, shift=(1, 2)):
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(0, 1, (12, 39)), jnp.float32)
    img1 = np.asarray(jax.image.resize(base, (H, W), "bilinear") * 255.0)
    img2 = np.roll(img1, shift, (0, 1))
    kp1 = np.stack([rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return img1, img2, kp1, valid


def _anchors(img1, kp1, levels, half_patch):
    cfg = j_klt.KLTConfig(levels=levels, half_patch=half_patch)
    return np.asarray(j_klt.extract_anchors(tuple(j_pyr.build_pyramid(j(img1), levels)), j(kp1), cfg))


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
def test_sampler_is_the_references(half_patch):
    """The halo windows of every level of a 188x620 pyramid, bit for bit."""
    rng = np.random.default_rng(half_patch)
    img = rng.uniform(0, 255, (188, 620)).astype(np.float32)
    halo = 2 * half_patch + 3
    for lvl in t_pyr.build_pyramid(t(img), 6):  # one level's bits into both samplers
        H, W = lvl.shape
        c = np.stack([rng.uniform(-3, W + 3, 256), rng.uniform(-3, H + 3, 256)], -1).astype(np.float32)
        ref = np.asarray(j_interp.sample_patches_matmul(j(to_numpy(lvl)), j(c), halo))
        port = to_numpy(t_interp.sample_patches(lvl, t(c), halo))
        assert np.array_equal(port, ref), ((H, W), float(np.abs(port - ref).max()))


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
def test_extract_anchors(half_patch):
    img1, _, kp1, _ = _scene(0)
    cfg = t_klt.KLTConfig(levels=3, half_patch=half_patch)
    port = t_klt.extract_anchors(t_pyr.build_pyramid(t(img1), 3), t(kp1), cfg)
    assert port.shape[2:] == (2 * half_patch + 3, 2 * half_patch + 3)
    assert_close(to_numpy(port), _anchors(img1, kp1, 3, half_patch), 1e-3)


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
def test_level_matches_xla_and_pallas(half_patch):
    img1, img2, kp1, valid = _scene(1)
    anchors = _anchors(img1, kp1, 1, half_patch)[:, 0]
    cfg_j = j_klt.KLTConfig(levels=1, half_patch=half_patch)
    cfg_t = t_klt.KLTConfig(levels=1, half_patch=half_patch)
    kp_t, ok_t = to_numpy(t_klt.klt_level_anchored(t(anchors), t(img2), t(kp1), t(kp1), t(valid), cfg_t))
    kp_x, ok_x = to_numpy(j_klt.klt_level_anchored(j(anchors), j(img2), j(kp1), j(kp1), j(valid), cfg_j))
    kp_p, ok_p = to_numpy(klt_pallas.klt_level_anchored_pallas(
        j(anchors), j(img2), j(kp1), j(kp1), j(valid),
        patch=2 * half_patch + 1, iterations=10, eps=1e-2, block=64, interpret=True,
    ))
    for kp_r, ok_r in ((kp_x, ok_x), (kp_p, ok_p)):
        assert agreement(ok_t, ok_r) > 0.97
        assert (ok_t & ok_r).sum() > 20
        assert_close(kp_t, kp_r, 2e-2, where=ok_t & ok_r)


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
def test_pyramid_anchored_with_gate(half_patch):
    """3 levels at KITTI half resolution, n=128, with the ZNCC gate."""
    img1, img2, kp1, valid = _scene(2, H=188, W=620, n=128)
    anchors = _anchors(img1, kp1, 3, half_patch)
    guess = kp1 + np.asarray([1.5, 0.5], np.float32)
    kp_x, ok_x = to_numpy(j_klt.klt_pyramid_anchored(
        j(anchors), j(kp1), tuple(j_pyr.build_pyramid(j(img2), 3)), j(guess), j(valid),
        j_klt.KLTConfig(levels=3, half_patch=half_patch, backend="xla"), min_zncc=0.5,
    ))
    kp_t, ok_t = to_numpy(klt_k.klt_pyramid_anchored_eager(
        t(anchors), t(kp1), tuple(t_pyr.build_pyramid(t(img2), 3)), t(guess), t(valid),
        t_klt.KLTConfig(levels=3, half_patch=half_patch), min_zncc=0.5,
    ))
    assert agreement(ok_t, ok_x) > 0.95
    assert (ok_t & ok_x).sum() > 40
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
def test_pyramid_frame_mode(half_patch):
    """Frame mode, 4 levels of 188x620, n=128, a (5, 2) px shift."""
    img1, img2, kp1, valid = _scene(3, H=188, W=620, n=128, margin=4, shift=(2, 5))
    jp = tuple(tuple(j_pyr.build_pyramid(j(im), 4)) for im in (img1, img2))
    tp = tuple(tuple(t_pyr.build_pyramid(t(im), 4)) for im in (img1, img2))
    kp_x, ok_x = to_numpy(j_klt.klt_pyramid(*jp, j(kp1), j(kp1), j(valid),
                                            j_klt.KLTConfig(levels=4, half_patch=half_patch, backend="xla")))
    kp_t, ok_t = to_numpy(t_klt.klt_pyramid(*tp, t(kp1), t(kp1), t(valid),
                                            t_klt.KLTConfig(levels=4, half_patch=half_patch)))
    assert agreement(ok_t, ok_x) > 0.95
    assert (ok_t & ok_x).sum() > 60
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)


def test_stereo_match_half_patch_5():
    ds = JDataset(n_frames=1, shape=(160, 240), focal=260.0, baseline=0.54)
    ds.init()
    fr = ds.next_frame()
    kp, ok = j_detect.detect(j(fr.left), j_detect.GFTTConfig(max_corners=150, min_distance=6))
    kp, ok = np.asarray(kp), np.asarray(ok)
    fxb = 260.0 * float(np.float32(0.54))
    d_min, d_max = fxb / 50.0, fxb / 2.0
    uv_j, ok_j = to_numpy(j_stereo.match(j_pyr.build_pyramid(j(fr.left), 1), j_pyr.build_pyramid(j(fr.right), 1),
                                         j(kp), j(ok), d_min, d_max, j_stereo.ScanlineConfig(half_patch=5)))
    uv_t, ok_t = to_numpy(t_stereo.match(t_pyr.build_pyramid(t(fr.left), 1), t_pyr.build_pyramid(t(fr.right), 1),
                                         t(kp), t(ok), d_min, d_max, t_stereo.ScanlineConfig(half_patch=5)))
    assert ok_j.sum() > 30
    assert agreement(ok_t, ok_j) >= 0.97
    assert_close(uv_t, uv_j, 2e-2, where=ok_j & ok_t)


def test_pose_at_8192_edges():
    """The plain pose (the card's K2 reads these edges from global memory)
    against the reference's `lm.estimate_pose`, which has no edge cap."""
    T_prior, P, uv, valid, T_true = _problem(3, n=8192)
    T_t, in_t, n_t = pose_k.estimate_pose_eager(T_INTR, t(T_prior), t(P), t(uv), t(valid))
    T_x, in_x, n_x = j_lm.estimate_pose(J_INTR, j(T_prior), j(P), j(uv), j(valid))
    T_t, in_t, in_x = to_numpy(T_t), to_numpy(in_t), np.asarray(in_x)
    assert_close(T_t, T_true, 5e-3)
    assert_close(T_t, np.asarray(T_x), 1e-3)
    assert agreement(in_t, in_x) > 0.98
    assert abs(int(n_t) - int(n_x)) <= max(3, 0.02 * len(in_x))


VO_FRAMES = 6


def test_vo_at_half_patch_5():
    """Six frames of test_torch_vo.py's corridor, BA off, klt_half_patch 5
    (anchors, tracking and its ZNCC gate at 11x11)."""
    over = {**OVERRIDES, "klt_half_patch": 5}

    def dataset(cls):
        return cls(n_frames=VO_FRAMES, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)

    ref = JVisualOdometry(config=JConfig(over), dataset=dataset(JDataset), inline_ba=False)
    assert ref.init()
    ref.run()
    vo = VisualOdometry(config=Config(over), dataset=dataset(TDataset), ba_mode="off", device="cpu")
    assert vo.init()
    vo.run()
    assert tuple(vo.carry.feats.anchor.shape[2:]) == (13, 13)
    kf_ref = np.asarray([bool(o.kf_inserted) for o in ref.outputs])
    np.testing.assert_array_equal(vo.statuses(), ref.statuses())
    np.testing.assert_array_equal(vo.keyframe_flags(), kf_ref)
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    assert_close(vo.trajectory_T_wc()[:, :3, 3], ref.trajectory_T_wc()[:, :3, 3], 2e-2)
