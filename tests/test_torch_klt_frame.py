"""Parity of the port's frame-mode KLT (ops/klt.py `klt_level`, `klt_pyramid`,
`track`; plain version kernels/klt.py `klt_pyramid_eager`) with the JAX
reference's XLA path (`backend="xla"`), on the same NumPy inputs.

Bars, those of tests/test_torch_klt.py: one level, success masks agree > 97%
and positions within 2e-2 px where both succeed; the pyramid, > 95% and
5e-2 px.  The images are a smooth random texture and its copy rolled by a
few pixels; keypoints reach to 4 px of the border, where the 9x9 windows of
the coarse levels clamp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.ops import klt as j_klt
from legoslam_tpu.ops import pyramid as j_pyr
from legoslam_tpu_torch.kernels import klt as klt_k
from legoslam_tpu_torch.ops import klt as t_klt
from legoslam_tpu_torch.ops import pyramid as t_pyr
from tests.torch_parity import agreement, assert_close, j, t, to_numpy


def _scene(seed, H=94, W=310, n=96, shift=(1, 2), margin=4):
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(0, 1, (H // 8, W // 8)), jnp.float32)
    img1 = np.asarray(jax.image.resize(base, (H, W), "bilinear") * 255.0)
    img2 = np.roll(img1, shift, (0, 1))
    kp1 = np.stack([rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return img1, img2, kp1, valid


def _pyramids(img1, img2, levels):
    jp = tuple(tuple(j_pyr.build_pyramid(j(im), levels)) for im in (img1, img2))
    tp = tuple(tuple(t_pyr.build_pyramid(t(im), levels)) for im in (img1, img2))
    return jp, tp


@pytest.mark.parametrize("inverse", [False, True])
def test_level_matches_xla(inverse):
    img1, img2, kp1, valid = _scene(1)
    guess = kp1 + np.asarray([1.0, 0.5], np.float32)
    kp_x, ok_x = to_numpy(j_klt.klt_level(j(img1), j(img2), j(kp1), j(guess), j(valid),
                                          j_klt.KLTConfig(inverse=inverse)))
    kp_t, ok_t = to_numpy(t_klt.klt_level(t(img1), t(img2), t(kp1), t(guess), t(valid),
                                          t_klt.KLTConfig(inverse=inverse)))
    assert agreement(ok_t, ok_x) > 0.97
    assert (ok_t & ok_x).sum() > 40
    assert_close(kp_t, kp_x, 2e-2, where=ok_t & ok_x)
    assert not ok_t[~valid].any()
    np.testing.assert_array_equal(kp_t[~valid], guess[~valid])  # invalid lanes pass through


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_pyramid_matches_xla(levels, inverse):
    H, W = (188, 620) if levels == 4 else (94, 310)  # the driver's and the loop closer's shapes
    img1, img2, kp1, valid = _scene(2, H=H, W=W, n=128, shift=(2, 5))
    (jp1, jp2), (tp1, tp2) = _pyramids(img1, img2, levels)
    kp_x, ok_x = to_numpy(j_klt.klt_pyramid(jp1, jp2, j(kp1), j(kp1), j(valid),
                                            j_klt.KLTConfig(levels=levels, inverse=inverse, backend="xla")))
    kp_t, ok_t = to_numpy(t_klt.klt_pyramid(tp1, tp2, t(kp1), t(kp1), t(valid),
                                            t_klt.KLTConfig(levels=levels, inverse=inverse)))
    assert agreement(ok_t, ok_x) > 0.95
    assert (ok_t & ok_x).sum() > 60
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)
    # most lanes found the shift
    found = np.abs(kp_t - kp1 - np.asarray([5.0, 2.0], np.float32)).max(-1) < 0.3
    assert (found & ok_t).sum() > 0.6 * valid.sum()


def _restart_case(levels=4):
    """Identical images and guesses 400 px to the right: the lanes of the
    right part start outside the image, their coarsest-level windows clamp
    onto the border, the normal matrix is singular and the level fails."""
    img1, _, kp1, valid = _scene(3, H=188, W=620, n=128, shift=(0, 0))
    guess = kp1 + np.asarray([400.0, 0.0], np.float32)
    outside = valid & (kp1[:, 0] + 400.0 > 640.0)
    return img1, kp1, valid, guess, outside


def test_restart_from_kp1_matches_xla():
    levels = 4
    img1, kp1, valid, guess, outside = _restart_case(levels)
    (jp1, _), (tp1, _) = _pyramids(img1, img1, levels)
    # the restart rule is exercised: these lanes fail the coarsest level ...
    s = 0.5 ** (levels - 1)
    _, ok_top = to_numpy(t_klt.klt_level(tp1[-1], tp1[-1], t(kp1 * s), t(guess * s), t(valid), t_klt.KLTConfig()))
    assert outside.sum() > 30 and not ok_top[outside].any()
    kp_x, ok_x = to_numpy(j_klt.klt_pyramid(jp1, jp1, j(kp1), j(guess), j(valid),
                                            j_klt.KLTConfig(levels=levels, backend="xla")))
    kp_t, ok_t = to_numpy(t_klt.klt_pyramid(tp1, tp1, t(kp1), t(guess), t(valid), t_klt.KLTConfig(levels=levels)))
    assert agreement(ok_t, ok_x) > 0.95
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)
    # ... and, restarted from kp1 on identical images, end on kp1 (a restart
    # from the guess, the anchored rule, would fail them on every level)
    home = ok_t & (np.abs(kp_t - kp1).max(-1) < 0.1)
    assert home[outside].mean() > 0.9
    home_x = ok_x & (np.abs(kp_x - kp1).max(-1) < 0.1)
    assert home_x[outside].mean() > 0.9


def test_track_and_backward_pass():
    """`track` builds both pyramids; the backward pass takes `valid` = the
    forward pass's success and starts from kp1, as the forward-backward
    gates of the frontend and the loop closer run it."""
    img1, img2, kp1, valid = _scene(4, n=96, shift=(1, 3))
    cfg_j, cfg_t = j_klt.KLTConfig(levels=3, backend="xla"), t_klt.KLTConfig(levels=3)
    kp_x, ok_x = to_numpy(j_klt.track(j(img1), j(img2), j(kp1), j(kp1), j(valid), cfg_j))
    kp_t, ok_t = to_numpy(t_klt.track(t(img1), t(img2), t(kp1), t(kp1), t(valid), cfg_t))
    assert agreement(ok_t, ok_x) > 0.95
    assert_close(kp_t, kp_x, 5e-2, where=ok_t & ok_x)
    # backward from the reference's forward result, on both sides
    bk_x, okb_x = to_numpy(j_klt.track(j(img2), j(img1), j(kp_x), j(kp1), j(ok_x), cfg_j))
    bk_t, okb_t = to_numpy(t_klt.track(t(img2), t(img1), t(kp_x), t(kp1), t(ok_x), cfg_t))
    assert agreement(okb_t, okb_x) > 0.95
    assert_close(bk_t, bk_x, 5e-2, where=okb_t & okb_x)
    assert not okb_t[~ok_x].any()
    rt = np.linalg.norm(bk_t - kp1, axis=-1)
    assert (okb_t & (rt < 0.8)).sum() > 0.6 * valid.sum()


@pytest.mark.parametrize("inverse", [False, True])
def test_gn_iteration_count(inverse):
    """Asking for the GN lane-iterations changes no output; every valid lane
    runs 1 .. iterations per level, and exactly 1 when capped at 1."""
    levels = 3
    img1, img2, kp1, valid = _scene(5, n=48)
    _, (tp1, tp2) = _pyramids(img1, img2, levels)
    args = (tp1, tp2, t(kp1), t(kp1 + np.float32(1.0)), t(valid))
    cfg = t_klt.KLTConfig(levels=levels, inverse=inverse)
    kp_a, ok_a = klt_k.klt_pyramid_eager(*args, cfg)
    count = torch.full((1,), 7, dtype=torch.int32)
    kp_b, ok_b = t_klt.klt_pyramid(*args, cfg, gn_iterations=count)
    assert torch.equal(kp_a, kp_b) and torch.equal(ok_a, ok_b)
    lanes = int(valid.sum()) * levels
    assert lanes < int(count) <= lanes * cfg.iterations
    klt_k.klt_pyramid_eager(*args, cfg._replace(iterations=1), gn_iterations=count)
    assert int(count) == lanes


def test_dispatch_on_cpu():
    """auto runs the plain version on CPU tensors; kernel refuses them."""
    img1, img2, kp1, valid = _scene(6, n=16)
    _, (tp1, tp2) = _pyramids(img1, img2, 2)
    args = (tp1, tp2, t(kp1), t(kp1), t(valid))
    n0 = klt_k.klt_pyramid_kernel.launches
    kp_a, ok_a = t_klt.klt_pyramid(*args, t_klt.KLTConfig(levels=2))
    kp_e, ok_e = klt_k.klt_pyramid_eager(*args, t_klt.KLTConfig(levels=2))
    assert torch.equal(kp_a, kp_e) and torch.equal(ok_a, ok_e)
    assert klt_k.klt_pyramid_kernel.launches == n0
    with pytest.raises(RuntimeError):
        t_klt.klt_pyramid(*args, t_klt.KLTConfig(levels=2, backend="kernel"))
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_kernel(*args, t_klt.KLTConfig(levels=2))
    with pytest.raises(ValueError):
        t_klt.klt_pyramid(*args, t_klt.KLTConfig(levels=2, backend="xla"))
