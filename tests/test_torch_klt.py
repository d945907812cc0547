"""Parity of the port's anchored KLT with the JAX reference.

The port's plain version (kernels/klt.py klt_pyramid_anchored_eager, built
from ops/klt.py) against the reference's XLA path and its two Pallas level
kernels in interpret mode, with the bars of tests/test_klt_pallas.py: one
level, masks agree > 97% and positions within 2e-2 px; the 3-level pyramid
at 188x620, > 95% and 5e-2 px.  Against the tile kernel the masks may differ
where its lanes leave their tile (which the port, like ops/klt.py, never
fails): > 97%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.ops import klt as j_klt
from legoslam_tpu.ops import klt_pallas
from legoslam_tpu.ops import pyramid as j_pyr
from legoslam_tpu_torch.kernels import klt as klt_k
from legoslam_tpu_torch.ops import klt as t_klt
from legoslam_tpu_torch.ops import pyramid as t_pyr
from tests.torch_parity import agreement, assert_close, j, t, to_numpy


def _scene(seed, H=94, W=310, n=64):
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(0, 1, (12, 39)), jnp.float32)
    img1 = np.asarray(jax.image.resize(base, (H, W), "bilinear") * 255.0)
    img2 = np.roll(img1, (1, 2), (0, 1))
    kp1 = np.stack([rng.uniform(15, W - 15, n), rng.uniform(15, H - 15, n)], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return img1, img2, kp1, valid


def _anchors(img1, kp1, levels):
    """Reference anchors (N, levels, 9, 9) as NumPy (inputs for both sides)."""
    cfg = j_klt.KLTConfig(levels=levels)
    return np.asarray(j_klt.extract_anchors(tuple(j_pyr.build_pyramid(j(img1), levels)), j(kp1), cfg))


def test_extract_anchors():
    img1, _, kp1, _ = _scene(0)
    port = t_klt.extract_anchors(t_pyr.build_pyramid(t(img1), 3), t(kp1), t_klt.KLTConfig(levels=3))
    assert_close(to_numpy(port), _anchors(img1, kp1, 3), 1e-3)


@pytest.mark.parametrize("inverse", [False, True])
def test_level_matches_xla_and_pallas(inverse):
    img1, img2, kp1, valid = _scene(1)
    anchors = _anchors(img1, kp1, 1)[:, 0]
    cfg_j = j_klt.KLTConfig(levels=1, inverse=inverse)
    cfg_t = t_klt.KLTConfig(levels=1, inverse=inverse)
    kp_t, ok_t = to_numpy(t_klt.klt_level_anchored(t(anchors), t(img2), t(kp1), t(kp1), t(valid), cfg_t))
    kp_x, ok_x = to_numpy(j_klt.klt_level_anchored(j(anchors), j(img2), j(kp1), j(kp1), j(valid), cfg_j))
    kp_p, ok_p = to_numpy(klt_pallas.klt_level_anchored_pallas(
        j(anchors), j(img2), j(kp1), j(kp1), j(valid),
        patch=7, iterations=10, eps=1e-2, inverse=inverse, block=64, interpret=True,
    ))
    for kp_r, ok_r in ((kp_x, ok_x), (kp_p, ok_p)):
        assert agreement(ok_t, ok_r) > 0.97
        assert (ok_t & ok_r).sum() > 20
        assert_close(kp_t, kp_r, 2e-2, where=ok_t & ok_r)


def test_pyramid_matches_xla():
    """3 levels at KITTI half resolution, n=128, plus the ZNCC gate."""
    img1, img2, kp1, valid = _scene(2, H=188, W=620, n=128)
    anchors = _anchors(img1, kp1, 3)
    guess = kp1 + np.asarray([1.5, 0.5], np.float32)
    kp_x, ok_x = to_numpy(j_klt.klt_pyramid_anchored(
        j(anchors), j(kp1), tuple(j_pyr.build_pyramid(j(img2), 3)), j(guess), j(valid),
        j_klt.KLTConfig(levels=3, backend="xla"),
    ))
    kp_t, ok_t = to_numpy(klt_k.klt_pyramid_anchored_eager(
        t(anchors), t(kp1), tuple(t_pyr.build_pyramid(t(img2), 3)), t(guess), t(valid),
        t_klt.KLTConfig(levels=3),
    ))
    assert agreement(ok_t, ok_x) > 0.95
    assert (ok_t & ok_x).sum() > 40
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)


def test_level_vs_tile_kernel():
    """The C2 gap: the tile kernel fails lanes leaving their 32x256 tile; the
    port keeps iterating them, as ops/klt.py does."""
    img1, img2, kp1, valid = _scene(3, H=188, W=620, n=128)
    anchors = _anchors(img1, kp1, 1)[:, 0]
    guess = kp1 + np.asarray([2.5, -1.0], np.float32)
    kp_t, ok_t = to_numpy(t_klt.klt_level_anchored(
        t(anchors), t(img2), t(kp1), t(guess), t(valid), t_klt.KLTConfig(levels=1)))
    kp_p, ok_p = to_numpy(klt_pallas.klt_level_anchored_tile_pallas(
        j(anchors), j(img2), j(kp1), j(guess), j(valid), interpret=True))
    assert agreement(ok_t, ok_p) > 0.97
    assert (ok_t & ok_p).sum() > 40
    assert_close(kp_t, kp_p, 2e-2, where=ok_t & ok_p)


def test_dispatch_on_cpu():
    """auto runs the plain version on CPU tensors; kernel refuses them."""
    img1, img2, kp1, valid = _scene(4, n=16)
    args = (t(_anchors(img1, kp1, 2)), t(kp1), tuple(t_pyr.build_pyramid(t(img2), 2)), t(kp1), t(valid))
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    kp_a, ok_a = t_klt.klt_pyramid_anchored(*args, t_klt.KLTConfig(levels=2))
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(*args, t_klt.KLTConfig(levels=2))
    assert torch.equal(kp_a, kp_e) and torch.equal(ok_a, ok_e)
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0
    with pytest.raises(RuntimeError):
        t_klt.klt_pyramid_anchored(*args, t_klt.KLTConfig(levels=2, backend="kernel"))
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(*args, t_klt.KLTConfig(levels=2))
    with pytest.raises(ValueError):
        t_klt.klt_pyramid_anchored(*args, t_klt.KLTConfig(levels=2, backend="xla"))
