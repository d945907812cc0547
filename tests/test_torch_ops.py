"""Parity of the port's image ops (legoslam_tpu_torch/ops) with the JAX
reference on the same NumPy inputs.

Tolerances: pyramids and patches 1e-3 on 0..255 images (the reference
samples through one-hot matmuls, which sum in another order); detection
compares the *set* of corners (top-k may order ties differently); the
occupancy mask is exact; stereo ok-masks agree >= 97% and right positions
within 2e-2 px where both are ok.
"""

import numpy as np
import pytest

from legoslam_tpu.ops import detect as j_detect
from legoslam_tpu.ops import interp as j_interp
from legoslam_tpu.ops import pyramid as j_pyr
from legoslam_tpu.ops import stereo as j_stereo
from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.ops import detect as t_detect
from legoslam_tpu_torch.ops import interp as t_interp
from legoslam_tpu_torch.ops import prefix
from legoslam_tpu_torch.ops import pyramid as t_pyr
from legoslam_tpu_torch.ops import stereo as t_stereo
from tests.torch_parity import agreement, assert_close, both, j, t, to_numpy


@pytest.fixture(scope="module")
def stereo_frame():
    ds = SyntheticPlanesDataset(n_frames=1, shape=(160, 240), focal=260.0, baseline=0.54)
    ds.init()
    fr = ds.next_frame()
    return fr.left, fr.right


def _noise_image(rng, H=94, W=155):
    return rng.uniform(0.0, 255.0, (H, W)).astype(np.float32)


def test_build_pyramid():
    img = _noise_image(np.random.default_rng(0), 95, 157)  # odd sizes truncate
    ref = j_pyr.build_pyramid(j(img), 4)
    port = t_pyr.build_pyramid(t(img), 4)
    for r, p in zip(ref, port):
        assert r.shape == p.shape
        assert_close(to_numpy(p), np.asarray(r), 1e-3)


@pytest.mark.parametrize("patch", [7, 9])
def test_sample_patches(patch):
    rng = np.random.default_rng(1)
    img = _noise_image(rng)
    centers = np.stack([rng.uniform(-6, 161, 200), rng.uniform(-6, 100, 200)], -1).astype(np.float32)
    centers[:4] = [[0, 0], [154, 93], [154.5, 93.5], [-30, 200]]  # corners, beyond the border
    ref, port = both(lambda i, c: j_interp.sample_patches(i, c, patch),
                     lambda i, c: t_interp.sample_patches(i, c, patch), img, centers)
    assert_close(port, ref, 1e-3)


@pytest.mark.parametrize("n", [5, 16, 17, 100, 250])
def test_prefix_sum_rounds_like_the_reference(n):
    """The port's float32 prefix sum is the reference's jnp.cumsum bit for bit."""
    import jax.numpy as jnp

    x = np.random.default_rng(n).uniform(0, 1e5, (3, n, 4)).astype(np.float32)
    ref = np.asarray(jnp.cumsum(j(x), axis=1))
    np.testing.assert_array_equal(to_numpy(prefix.cumsum(t(x), 1)), ref)


def test_detect(stereo_frame):
    img = stereo_frame[0]
    cfg_j = j_detect.GFTTConfig(max_corners=150, min_distance=6)
    cfg_t = t_detect.GFTTConfig(max_corners=150, min_distance=6)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 240, 60), rng.uniform(0, 160, 60)], -1).astype(np.float32)
    valid = rng.uniform(size=60) > 0.3
    mask_j = j_detect.occupancy_mask(img.shape, j(uv), j(valid), 6)
    mask_t = t_detect.occupancy_mask(img.shape, t(uv), t(valid), 6)
    np.testing.assert_array_equal(to_numpy(mask_t), np.asarray(mask_j))
    (pj, vj), (pt, vt) = both(lambda i, m: j_detect.detect(i, cfg_j, m),
                              lambda i, m: t_detect.detect(i, cfg_t, m), img, np.asarray(mask_j))
    assert vj.sum() == vt.sum() > 50
    assert set(map(tuple, pj[vj])) == set(map(tuple, pt[vt]))


def test_occupancy_mask_invalid_lane_never_clears():
    """An invalid lane sharing a valid lane's pixel must not clear it."""
    uv = np.asarray([[10.2, 20.4], [10.0, 20.0], [50.0, 5.0]], np.float32)
    valid = np.asarray([True, False, False])
    ref, port = both(lambda u, v: j_detect.occupancy_mask((40, 80), u, v, 2),
                     lambda u, v: t_detect.occupancy_mask((40, 80), u, v, 2), uv, valid)
    np.testing.assert_array_equal(port, ref)
    assert port[20, 10] and port.sum() == 25


def test_stereo_match(stereo_frame):
    left, right = stereo_frame
    kp, ok = j_detect.detect(j(left), j_detect.GFTTConfig(max_corners=150, min_distance=6))
    kp, ok = np.asarray(kp), np.asarray(ok)
    fxb = 260.0 * float(np.float32(0.54))
    args = (left, right, kp, ok)
    ref, port = both(
        lambda l, r, k, v: j_stereo.match(j_pyr.build_pyramid(l, 1), j_pyr.build_pyramid(r, 1), k, v, fxb / 50.0, fxb / 2.0),
        lambda l, r, k, v: t_stereo.match(t_pyr.build_pyramid(l, 1), t_pyr.build_pyramid(r, 1), k, v, fxb / 50.0, fxb / 2.0),
        *args,
    )
    (uv_j, ok_j), (uv_t, ok_t) = ref, port
    assert ok_j.sum() > 30
    assert agreement(ok_t, ok_j) >= 0.97
    assert_close(uv_t, uv_j, 2e-2, where=ok_j & ok_t)
