"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX (the GPU machine has none); run there with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py`.
Without a CUDA device every test skips.  Bars: KLT masks agree >= 99% and
positions within 1e-2 px where both succeed (sums in another order can move
a lane across the 1e-2 px convergence test by one GN step); pose entries
within 1e-3 and inlier masks >= 99%.
"""

import numpy as np
import pytest
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.kernels import klt as klt_k
from legoslam_tpu_torch.kernels import pose as pose_k
from legoslam_tpu_torch.ops import klt, pyramid
from legoslam_tpu_torch.solver import lm, reprojection

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _smooth_image(rng, H, W):
    base = torch.from_numpy(rng.uniform(0, 1, (1, 1, H // 8 + 2, W // 8 + 2)).astype(np.float32))
    img = torch.nn.functional.interpolate(base, size=(H, W), mode="bicubic", align_corners=False)[0, 0]
    return img * 255.0


def _klt_case(dev, levels, inverse, n=512, H=188, W=620, seed=0):
    rng = np.random.default_rng(seed)
    img1 = _smooth_image(rng, H, W)
    img2 = torch.roll(img1, (1, 2), (0, 1))
    kp = torch.from_numpy(np.stack([rng.uniform(12, W - 12, n), rng.uniform(12, H - 12, n)], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    cfg = klt.KLTConfig(levels=levels, inverse=inverse)
    anchors = klt.extract_anchors(pyramid.build_pyramid(img1, levels + 1), kp, cfg._replace(levels=levels + 1))
    guess = kp + torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32))
    pyr2 = tuple(p.to(dev) for p in pyramid.build_pyramid(img2, levels + 1))
    return anchors.to(dev), kp.to(dev), pyr2, guess.to(dev), valid.to(dev), cfg


@pytest.mark.parametrize("levels,inverse", [(3, False), (3, True), (1, False), (4, False)])
def test_klt_kernel_matches_eager(cuda, levels, inverse):
    args = _klt_case(cuda, levels, inverse)
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    kp_k, ok_k = klt_k.klt_pyramid_anchored_kernel(*args)
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(*args)
    torch.cuda.synchronize()
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0 + 1
    ok_k, ok_e = ok_k.cpu().numpy(), ok_e.cpu().numpy()
    assert (ok_k == ok_e).mean() >= 0.99
    both = ok_k & ok_e
    assert both.sum() > 200
    np.testing.assert_allclose(kp_k.cpu().numpy()[both], kp_e.cpu().numpy()[both], rtol=0, atol=1e-2)


def test_klt_auto_dispatch_launches_kernel(cuda):
    args = _klt_case(cuda, 3, False, n=128)
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    klt.klt_pyramid_anchored(*args)
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0 + 1


def test_klt_kernel_refuses_bad_input(cuda):
    anchors, kp, pyr2, guess, valid, cfg = _klt_case(cuda, 3, False, n=64)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors.double(), kp, pyr2, guess, valid, cfg)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr2, guess, valid, cfg._replace(half_patch=4))


def _pose_case(dev, n=512, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 60.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    T_true = se3.se3_exp(torch.tensor([0.1, -0.05, 0.3, 0.01, 0.02, -0.01])).double().numpy()
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[: n // 10] += rng.normal(0, 30.0, (n // 10, 2))
    valid = rng.uniform(size=n) > 0.05
    T_prior = se3.se3_exp(torch.tensor([0.12, -0.03, 0.25, 0.0, 0.025, 0.0]))
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return intr, T_prior.to(dev), f32(P), f32(uv), torch.from_numpy(valid).to(dev)


@pytest.mark.parametrize("strategy", ["default", "strategy1"])
def test_pose_kernel_matches_eager(cuda, strategy):
    intr, T, P, uv, valid = _pose_case(cuda)
    cfg = lm.LMConfig(strategy=strategy)
    n0 = pose_k.estimate_pose_kernel.launches
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, valid, cfg=cfg)
    T_e, in_e, n_e = pose_k.estimate_pose_eager(intr, T, P, uv, valid, cfg=cfg)
    torch.cuda.synchronize()
    assert pose_k.estimate_pose_kernel.launches == n0 + 1
    np.testing.assert_allclose(T_k.cpu().numpy(), T_e.cpu().numpy(), rtol=0, atol=1e-3)
    assert (in_k == in_e).float().mean().item() >= 0.99
    assert int(n_k) == int(in_k.sum())


def test_pose_kernel_all_invalid(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=64)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, torch.zeros_like(valid))
    assert torch.isfinite(T_k).all() and int(n_k) == 0 and not bool(in_k.any())


def test_pose_dispatch_picks_kernel_on_cuda(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=128)
    n0 = pose_k.estimate_pose_kernel.launches
    pose_k.estimate_pose(intr, T, P, uv, valid)
    assert pose_k.estimate_pose_kernel.launches == n0 + 1
