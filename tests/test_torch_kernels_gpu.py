"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX (the GPU machine has none); run there with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py`.
Without a CUDA device every test skips.  Bars: KLT masks agree >= 99% and
positions within 1e-2 px where both succeed (sums in another order can move
a lane across the 1e-2 px convergence test by one GN step).  Work counts:
the KLT kernel's GN lane-iterations within max(8, 2%) of the plain
version's (a lane moved by one GN step moves the count by one).  The pose
kernel computes its plain version's bits: pose, inlier mask, n_in and each
round's LM attempts equal.

The frame-mode entry of the KLT kernel is held to the same bars, forward
and backward, and its restart rule on lanes that fail the coarsest level.
Both KLT entries give their plain versions' bits at every half-patch they
are instantiated for (0..9) and over 9 levels of 376x1240; the pose kernel
at edge counts on both sides of its shared copy's capacity.

Window BA has no kernel of its own (PyTorch ops); its card run is held
against the same call on a CPU copy of the map with chip_smoke.py's bars,
and two card runs on one map must give the same bits (the BA sums run in
an order fixed by the graph, solver/schur.py).
So are loop verification (`LoopCloser._verify`) and `marginalize`.

Each window BA attempt on the card is a replay of one captured CUDA graph
(solver/ba_graph.py): the result is the eager LM loop's bit for bit, a
signature is captured once, and the async backend's worker thread captures
and replays it with the same results as an inline solve.

`process_chunk` on the card is its stepwise run bit for bit; the async
backend's side stream must keep its snapshot intact until the merge; the
device pose graph gives the same bits twice and agrees with the CPU.

Scanline stereo's kernel (K3) gives its plain version's bits at every
disparity width and half-patch it is tested at, in one launch with no host
read, and takes the first disparity where costs tie.

Every synchronization of a tracking frame and of a keyframe frame happens
inside one of the program's `read` spans (utils/timer.py), and an explicit
`torch.cuda.synchronize()`, such as the benchmark's spans end in, is not
counted as one.
"""

import numpy as np
import pytest
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.kernels import klt as klt_k
from legoslam_tpu_torch.kernels import pose as pose_k
from legoslam_tpu_torch.ops import klt, pyramid
from legoslam_tpu_torch.solver import lm, reprojection
from legoslam_tpu_torch.utils import timer

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


def _klt_case(dev, levels, inverse, n=512, H=188, W=620, seed=0, half_patch=3):
    rng = np.random.default_rng(seed)
    img1 = _smooth_image(rng, H, W)
    img2 = torch.roll(img1, (1, 2), (0, 1))
    kp = torch.from_numpy(np.stack([rng.uniform(12, W - 12, n), rng.uniform(12, H - 12, n)], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    cfg = klt.KLTConfig(levels=levels, inverse=inverse, half_patch=half_patch)
    anchors = klt.extract_anchors(pyramid.build_pyramid(img1, levels + 1), kp, cfg._replace(levels=levels + 1))
    guess = kp + torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32))
    pyr2 = tuple(p.to(dev) for p in pyramid.build_pyramid(img2, levels + 1))
    return anchors.to(dev), kp.to(dev), pyr2, guess.to(dev), valid.to(dev), cfg


@pytest.mark.parametrize("levels", [1, 3, 4])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [512, 130])  # 130 lanes: the last block holds 2 of its 4 warps
def test_klt_kernel_matches_eager(cuda, levels, inverse, n):
    args = _klt_case(cuda, levels, inverse, n=n)
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    it_k = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    it_e = torch.zeros((1,), dtype=torch.int32, device=cuda)
    kp_k, ok_k = klt_k.klt_pyramid_anchored_kernel(*args, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_anchored_eager(*args, gn_iterations=it_e)
    kp_0, ok_0 = klt_k.klt_pyramid_anchored_kernel(*args)
    torch.cuda.synchronize()
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0 + 2
    assert torch.equal(kp_0, kp_k) and torch.equal(ok_0, ok_k)  # counting changes nothing
    ok_k, ok_e = ok_k.cpu().numpy(), ok_e.cpu().numpy()
    assert (ok_k == ok_e).mean() >= 0.99
    both = ok_k & ok_e
    assert both.sum() > 200 * n // 512
    np.testing.assert_allclose(kp_k.cpu().numpy()[both], kp_e.cpu().numpy()[both], rtol=0, atol=1e-2)
    assert abs(int(it_k) - int(it_e)) <= max(8, 0.02 * int(it_e)), (int(it_k), int(it_e))


def test_klt_kernel_is_reproducible(cuda):
    args = _klt_case(cuda, 3, False)
    kp_a, ok_a = klt_k.klt_pyramid_anchored_kernel(*args)
    kp_b, ok_b = klt_k.klt_pyramid_anchored_kernel(*args)
    assert torch.equal(kp_a, kp_b) and torch.equal(ok_a, ok_b)


def test_klt_auto_dispatch_launches_kernel(cuda):
    args = _klt_case(cuda, 3, False, n=128)
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    klt.klt_pyramid_anchored(*args)
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0 + 1


def _bits(x):
    """A float tensor's bits (NaN equal to itself)."""
    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    return torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(a[1], b[1])


# Every half-patch the kernels are instantiated for (the reference's Pallas
# kernels take halo = 2 h + 3 <= 21).
HALF_PATCHES = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
@pytest.mark.parametrize("inverse", [False, True])
def test_klt_kernel_bit_for_bit_at_half_patch(cuda, half_patch, inverse):
    """K1 anchored at each half-patch gives its plain version's bits:
    positions, masks after the ZNCC gate, and the GN lane-iterations."""
    args = _klt_case(cuda, 3, inverse, half_patch=half_patch)
    it_k = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    it_e = torch.zeros((1,), dtype=torch.int32, device=cuda)
    n0 = klt_k.klt_pyramid_anchored_kernel.launches
    out_k = klt_k.klt_pyramid_anchored_kernel(*args, gn_iterations=it_k)
    out_e = klt_k.klt_pyramid_anchored_eager(*args, gn_iterations=it_e)
    torch.cuda.synchronize()
    assert klt_k.klt_pyramid_anchored_kernel.launches == n0 + 1
    assert _same_bits(out_k, out_e), float((out_k[0] - out_e[0]).abs().max())
    assert int(it_k) == int(it_e) > 0
    if half_patch > 0:  # a 1x1 patch has a singular normal matrix
        assert int(out_k[1].sum()) > 100, int(out_k[1].sum())


@pytest.mark.parametrize("half_patch", HALF_PATCHES)
@pytest.mark.parametrize("inverse", [False, True])
def test_klt_frame_kernel_bit_for_bit_at_half_patch(cuda, half_patch, inverse):
    """K1 in frame mode at each half-patch: the plain version's bits,
    forward and then backward from the kernel's forward result."""
    pyr1, pyr2, kp, guess, valid, cfg = _frame_case(cuda, 4, inverse, half_patch=half_patch)
    it_k = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    it_e = torch.zeros((1,), dtype=torch.int32, device=cuda)
    fw_k = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp, guess, valid, cfg, gn_iterations=it_k)
    fw_e = klt_k.klt_pyramid_eager(pyr1, pyr2, kp, guess, valid, cfg, gn_iterations=it_e)
    bk_k = klt_k.klt_pyramid_kernel(pyr2, pyr1, fw_k[0], kp, fw_k[1], cfg)
    bk_e = klt_k.klt_pyramid_eager(pyr2, pyr1, fw_k[0], kp, fw_k[1], cfg)
    torch.cuda.synchronize()
    assert _same_bits(fw_k, fw_e) and _same_bits(bk_k, bk_e)
    assert int(it_k) == int(it_e) > 0
    if half_patch > 0:
        assert int(fw_k[1].sum()) > 100, int(fw_k[1].sum())


@pytest.mark.parametrize("inverse", [False, True])
def test_klt_frame_kernel_at_nine_levels(cuda, inverse):
    """Frame mode over 9 levels of 376x1240 (the coarsest 1x4 px): the plain
    version's bits, forward and backward."""
    pyr1, pyr2, kp, guess, valid, cfg = _frame_case(cuda, 9, inverse, H=376, W=1240, shift=(3, 5))
    assert tuple(pyr1[8].shape) == (1, 4) and len(pyr1) == 9
    fw_k = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp, guess, valid, cfg)
    fw_e = klt_k.klt_pyramid_eager(pyr1, pyr2, kp, guess, valid, cfg)
    bk_k = klt_k.klt_pyramid_kernel(pyr2, pyr1, fw_k[0], kp, fw_k[1], cfg)
    bk_e = klt_k.klt_pyramid_eager(pyr2, pyr1, fw_k[0], kp, fw_k[1], cfg)
    torch.cuda.synchronize()
    assert _same_bits(fw_k, fw_e) and _same_bits(bk_k, bk_e)
    assert int(fw_k[1].sum()) > 200, int(fw_k[1].sum())


def test_klt_kernel_refuses_bad_input(cuda):
    """The wrappers refuse a half-patch past the reference's halo of 21 and
    a level without a row, beside malformed tensors."""
    anchors, kp, pyr2, guess, valid, cfg = _klt_case(cuda, 3, False, n=64)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors.double(), kp, pyr2, guess, valid, cfg)
    with pytest.raises(ValueError, match="halo"):
        klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr2, guess, valid, cfg._replace(half_patch=10))
    pyr1, pyr2f, kpf, guessf, validf, cfgf = _frame_case(cuda, 9, False, n=64)
    assert pyr1[8].shape[0] == 0  # 188 rows have none left at level 8
    with pytest.raises(ValueError, match="row"):
        klt_k.klt_pyramid_kernel(pyr1, pyr2f, kpf, guessf, validf, cfgf)
    with pytest.raises(ValueError, match="halo"):
        klt_k.klt_pyramid_kernel(pyr1, pyr2f, kpf, guessf, validf, cfgf._replace(levels=4, half_patch=10))
    # The levels go to the kernel as separate pointers: a strided level is refused.
    wide = torch.zeros((pyr2[1].shape[0], pyr2[1].shape[1] + 4), device=cuda)
    wide[:, : pyr2[1].shape[1]] = pyr2[1]
    strided = (pyr2[0], wide[:, : pyr2[1].shape[1]], *pyr2[2:])
    assert not strided[1].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        klt_k.klt_pyramid_anchored_kernel(anchors, kp, strided, guess, valid, cfg)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr2, guess, valid, cfg,
                                          gn_iterations=torch.zeros(1, dtype=torch.int64, device=cuda))


def _frame_case(dev, levels, inverse, n=512, H=188, W=620, seed=0, shift=(1, 2), half_patch=3):
    """Two images a shift apart, keypoints up to the border (so some 9x9
    windows clamp on the coarse levels) and guesses a few px off."""
    rng = np.random.default_rng(seed)
    img1 = _smooth_image(rng, H, W)
    img2 = torch.roll(img1, shift, (0, 1))
    kp = torch.from_numpy(np.stack([rng.uniform(2, W - 2, n), rng.uniform(2, H - 2, n)], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    guess = kp + torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32))
    pyr1 = tuple(p.to(dev) for p in pyramid.build_pyramid(img1, levels))
    pyr2 = tuple(p.to(dev) for p in pyramid.build_pyramid(img2, levels))
    cfg = klt.KLTConfig(levels=levels, inverse=inverse, half_patch=half_patch)
    return pyr1, pyr2, kp.to(dev), guess.to(dev), valid.to(dev), cfg


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [512, 130])
def test_klt_frame_kernel_matches_eager(cuda, levels, inverse, n):
    """K1 in frame mode (templates sampled from the first pyramid inside the
    launch, restart from kp1) against `klt_pyramid_eager`, forward and then
    backward with `valid` = the forward pass's success; the anchored bars."""
    pyr1, pyr2, kp, guess, valid, cfg = _frame_case(cuda, levels, inverse, n=n)
    n0 = klt_k.klt_pyramid_kernel.launches
    it_k = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    it_e = torch.zeros((1,), dtype=torch.int32, device=cuda)
    kp_k, ok_k = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp, guess, valid, cfg, gn_iterations=it_k)
    kp_e, ok_e = klt_k.klt_pyramid_eager(pyr1, pyr2, kp, guess, valid, cfg, gn_iterations=it_e)
    kp_0, ok_0 = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp, guess, valid, cfg)
    assert torch.equal(kp_0, kp_k) and torch.equal(ok_0, ok_k)
    assert abs(int(it_k) - int(it_e)) <= max(8, 0.02 * int(it_e)), (int(it_k), int(it_e))
    # backward, from the kernel's forward result on both sides
    bk_k, okb_k = klt_k.klt_pyramid_kernel(pyr2, pyr1, kp_k, kp, ok_k, cfg)
    bk_e, okb_e = klt_k.klt_pyramid_eager(pyr2, pyr1, kp_k, kp, ok_k, cfg)
    torch.cuda.synchronize()
    assert klt_k.klt_pyramid_kernel.launches == n0 + 3
    for (a, oa), (b, ob) in (((kp_k, ok_k), (kp_e, ok_e)), ((bk_k, okb_k), (bk_e, okb_e))):
        oa, ob = oa.cpu().numpy(), ob.cpu().numpy()
        assert (oa == ob).mean() >= 0.99
        both = oa & ob
        assert both.sum() > 200 * n // 512
        np.testing.assert_allclose(a.cpu().numpy()[both], b.cpu().numpy()[both], rtol=0, atol=1e-2)
    assert not bool((okb_k & ~ok_k).any())  # a lane invalid on the way back never succeeds


def test_klt_frame_kernel_restarts_from_kp1(cuda):
    """Guesses 400 px to the right put the lanes of the right part of the
    image outside it: on the coarsest level their windows clamp onto the
    border, the normal matrix is singular and the lane fails.  Such a lane
    must restart the next level from kp1 inside the launch (the images are
    identical, so it then converges back onto kp1); restarting from the
    guess, the anchored rule, would fail it on every level."""
    pyr1, pyr2, kp, _, valid, cfg = _frame_case(cuda, 4, False, shift=(0, 0))
    guess = (kp + torch.tensor([400.0, 0.0], device=cuda)).contiguous()
    kp_k, ok_k = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp, guess, valid, cfg)
    kp_e, ok_e = klt_k.klt_pyramid_eager(pyr1, pyr2, kp, guess, valid, cfg)
    assert (ok_k == ok_e).float().mean().item() >= 0.97
    both = (ok_k & ok_e).cpu().numpy()
    np.testing.assert_allclose(kp_k.cpu().numpy()[both], kp_e.cpu().numpy()[both], rtol=0, atol=2e-2)
    outside = valid & (kp[:, 0] + 400.0 > 640.0)
    home = ok_k & ((kp_k - kp).norm(dim=-1) < 0.1)
    assert int(outside.sum()) > 100
    assert home[outside].float().mean().item() > 0.9, home[outside].float().mean().item()


def test_klt_frame_auto_dispatch_and_bad_input(cuda):
    pyr1, pyr2, kp, guess, valid, cfg = _frame_case(cuda, 3, False, n=64)
    n0 = klt_k.klt_pyramid_kernel.launches
    klt.klt_pyramid(pyr1, pyr2, kp, guess, valid, cfg)
    klt.track(pyr1[0], pyr2[0], kp, guess, valid, cfg)
    assert klt_k.klt_pyramid_kernel.launches == n0 + 2
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_kernel(pyr1[:2], pyr2, kp, guess, valid, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        klt_k.klt_pyramid_kernel((pyr1[0].t().contiguous().t(), *pyr1[1:]), pyr2, kp, guess, valid, cfg)
    kp_c, ok_c = klt_k.klt_pyramid_kernel(pyr1, pyr2, kp[:0], guess[:0], valid[:0], cfg)
    assert kp_c.shape == (0, 2) and ok_c.shape == (0,)


# A prior this many rad off the true rotation (about x): the LM steps then
# take the retraction's sinf branch (above se3's small angle, 0.05 rad).
LARGE_ANGLE = 0.3


def _pose_case(dev, n=512, seed=0, large_angle=False):
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 60.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    T_true = se3.se3_exp(torch.tensor([0.1, -0.05, 0.3, 0.01, 0.02, -0.01])).double().numpy()
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[: n // 10] += rng.normal(0, 30.0, (n // 10, 2))
    valid = rng.uniform(size=n) > 0.05
    xi_prior = [0.1, -0.05, 0.3, 0.01 + LARGE_ANGLE, 0.02, -0.01] if large_angle else [0.12, -0.03, 0.25, 0.0, 0.025, 0.0]
    T_prior = se3.se3_exp(torch.tensor(xi_prior))
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return intr, T_prior.to(dev), f32(P), f32(uv), torch.from_numpy(valid).to(dev)


@pytest.mark.parametrize("verification", [False, True])
@pytest.mark.parametrize("strategy", ["default", "strategy1"])
@pytest.mark.parametrize("n,large_angle", [(0, False), (1, False), (31, False), (33, False), (64, False),
                                           (511, False), (512, False), (513, False), (1000, False), (4096, False),
                                           (512, True), (4097, False), (6000, False), (8192, False), (16384, False)])
def test_pose_kernel_matches_eager(cuda, strategy, n, large_angle, verification, monkeypatch):
    """Bit for bit, at edge counts on either side of csrc/pose.cu's chunks
    of 32 and of its ring of 16 chunks, on either side of its shared copy's
    capacity (`shared_edges`: 4,097 and 6,000 edges in shared memory, 8,192
    and 16,384 read from global memory), and with a prior LARGE_ANGLE rad
    off, whose steps take the retraction's sinf branch (the plain version's
    torch.sin, CUDA's sinf on the card)."""
    intr, T, P, uv, valid = _pose_case(cuda, n=n, large_angle=large_angle)
    cfg = lm.LMConfig(strategy=strategy)
    kw = {"cfg": cfg, "verification": verification, "drop_kernel_after": 3 if verification else 2}
    n0 = pose_k.estimate_pose_kernel.launches
    at_k = torch.full((4,), -1, dtype=torch.int32, device=cuda)
    at_e = torch.zeros((4,), dtype=torch.int32, device=cuda)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, valid, attempts=at_k, **kw)
    steps, retract = [], se3.retract

    def recording_retract(T_, dx):
        steps.append(float(torch.linalg.vector_norm(dx[3:])))
        return retract(T_, dx)

    monkeypatch.setattr(se3, "retract", recording_retract)
    T_e, in_e, n_e = pose_k.estimate_pose_eager(intr, T, P, uv, valid, attempts=at_e, **kw)
    monkeypatch.undo()
    if large_angle:
        assert max(steps) >= 0.05, max(steps)  # the sinf branch was taken
    T_0, in_0, n_0 = pose_k.estimate_pose_kernel(intr, T, P, uv, valid, **kw)
    torch.cuda.synchronize()
    assert pose_k.estimate_pose_kernel.launches == n0 + 2
    assert torch.equal(T_0, T_k) and torch.equal(in_0, in_k)  # reproducible; counting changes nothing
    assert torch.equal(T_k, T_e), (T_k - T_e).abs().max()
    assert in_k.shape == (n,) and int(n_k) == int(in_k.sum())
    assert torch.equal(in_k, in_e) and int(n_k) == int(n_e)
    a_k, a_e = at_k.cpu().numpy(), at_e.cpu().numpy()
    assert (a_k >= 1).all() and (a_k <= cfg.iterations * cfg.false_cnt_threshold).all()
    assert np.array_equal(a_k, a_e), (a_k, a_e)


def test_pose_kernel_shared_capacity(cuda):
    """The shared copy holds what the opt-in shared memory leaves beside the
    ring (some 6,700 edges on an H100), so test_pose_kernel_matches_eager's
    edge counts take both instantiations."""
    cap = pose_k.shared_edges(cuda)
    assert 6000 <= cap < 8192, cap


def test_pose_kernel_refuses_bad_input(cuda):
    """Malformed tensors are refused; no edge count is (past the shared
    copy's capacity the kernel reads its edges from global memory)."""
    intr, T, P, uv, valid = _pose_case(cuda, n=64)
    with pytest.raises(ValueError):
        pose_k.estimate_pose_kernel(intr, T, P, uv, valid, attempts=torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        pose_k.estimate_pose_kernel(intr, T, P.double(), uv, valid)
    with pytest.raises(ValueError, match="contiguous"):
        pose_k.estimate_pose_kernel(intr, T, P, uv.t().contiguous().t(), valid)
    big = pose_k.shared_edges(cuda) + 1
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P[:1].expand(big, 3).contiguous(),
                                                 uv[:1].expand(big, 2).contiguous(), valid[:1].expand(big).contiguous())
    assert torch.isfinite(T_k).all() and in_k.shape == (big,) and int(n_k) == int(in_k.sum())


def test_pose_kernel_all_invalid(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=64)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, torch.zeros_like(valid))
    assert torch.isfinite(T_k).all() and int(n_k) == 0 and not bool(in_k.any())


def test_pose_dispatch_picks_kernel_on_cuda(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=128)
    n0 = pose_k.estimate_pose_kernel.launches
    pose_k.estimate_pose(intr, T, P, uv, valid)
    assert pose_k.estimate_pose_kernel.launches == n0 + 1


def _stereo_cases():
    """tests/stereo_cases.py, loaded by path (the card's Python has a
    `tests` package of its own)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("stereo_cases",
                                                  os.path.join(os.path.dirname(__file__), "stereo_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The rigs of tests/stereo_cases.py: D = 7 (rows_sum's C < 8 order), 28 and
# 27 (KITTI 00 and 05 at half resolution: four partial sums), 98 (chip_smoke's
# plane world: 96 columns row by row) and 390 (two levels of carries).
STEREO_RIGS = ["d7", "kitti00", "kitti05", "smoke", "near"]


@pytest.mark.parametrize("rig", STEREO_RIGS)
@pytest.mark.parametrize("half_patch", [1, 3, 5, 9])
@pytest.mark.parametrize("n", [512, 150])  # 150 lanes: the last block holds 2 of its 4 warps
def test_stereo_kernel_bit_for_bit(cuda, rig, half_patch, n):
    """K3 gives the plain version's bits on the same card, uv_r and ok:
    invalid lanes, lanes off the image (strips that leave it) and lanes in a
    texture that repeats every 5 px (ambiguous) among them."""
    from legoslam_tpu_torch.kernels import stereo as stereo_k

    pyr_l, pyr_r, kp, valid, d_min, d_max = _stereo_cases().stereo_case(rig, n, device=cuda)
    cfg = stereo_k.ScanlineConfig(half_patch=half_patch)
    n0 = stereo_k.match_kernel.launches
    out_k = stereo_k.match_kernel(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    out_e = stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    torch.cuda.synchronize()
    assert stereo_k.match_kernel.launches == n0 + 1
    assert _same_bits(out_k, out_e), int((_bits(out_k[0]) != _bits(out_e[0])).any(-1).sum())
    assert 0.4 * int(valid.sum()) < int(out_k[1].sum()) < int(valid.sum())


def test_stereo_kernel_at_a_fused_row_shape_and_half_patch_0(cuda):
    """94x310, whose bilinear row pass is a fused multiply-add, and a 1x1
    patch: the plain version's bits."""
    from legoslam_tpu_torch.kernels import stereo as stereo_k

    cases = _stereo_cases()
    for half_patch, shape in ((3, (94, 310)), (9, (94, 310)), (0, (188, 620))):
        args = cases.stereo_case("kitti00", 150, shape, device=cuda)
        cfg = stereo_k.ScanlineConfig(half_patch=half_patch)
        assert _same_bits(stereo_k.match_kernel(*args, cfg), stereo_k.match_eager(*args, cfg)), (half_patch, shape)


def test_stereo_tied_costs_take_the_first_disparity(cuda):
    """A constant right image ties every disparity's cost: kernel and plain
    version on the card both take the first (x_r = x - d_hi)."""
    from legoslam_tpu_torch.kernels import stereo as stereo_k

    cases = _stereo_cases()
    pyr_l, pyr_r, kp, valid, d_min, d_max = cases.tied_case(device=cuda)
    d_hi = cases.first_disparity(d_min, d_max)
    for uv, ok in (stereo_k.match_kernel(pyr_l, pyr_r, kp, valid, d_min, d_max),
                   stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max)):
        assert torch.equal(uv[:, 0], kp[:, 0] - float(d_hi)) and not bool(ok.any())


def test_stereo_kernel_is_one_launch_and_no_host_read(cuda):
    """One `match_kernel` call (through the dispatching `ops.stereo.match`)
    raises `launches` by exactly 1 and makes no synchronization; the plain
    version reads `stereo_refine` to the host on every iteration."""
    from legoslam_tpu_torch.kernels import stereo as stereo_k
    from legoslam_tpu_torch.ops import stereo as stereo_ops

    args = _stereo_cases().stereo_case("kitti00", 512, device=cuda)
    stereo_k.match_kernel(*args)  # built and loaded
    torch.cuda.synchronize()
    n0 = stereo_k.match_kernel.launches
    _, reads = timer.count_host_reads(lambda: stereo_ops.match(*args))
    assert stereo_k.match_kernel.launches == n0 + 1 and reads == 0
    _, reads_plain = timer.count_host_reads(lambda: stereo_k.match_eager(*args))
    assert reads_plain >= 1


def test_stereo_kernel_refuses_bad_input(cuda):
    from legoslam_tpu_torch.kernels import stereo as stereo_k

    pyr_l, pyr_r, kp, valid, d_min, d_max = _stereo_cases().stereo_case("kitti00", 64, device=cuda)
    cfg = stereo_k.ScanlineConfig()
    with pytest.raises(ValueError, match="half_patch"):
        stereo_k.match_kernel(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg._replace(half_patch=10))
    with pytest.raises(ValueError, match="strip"):
        stereo_k.match_kernel(pyr_l, pyr_r, kp, valid, d_min, 3000.0, cfg)
    with pytest.raises(ValueError, match="image"):
        stereo_k.match_kernel((pyr_l[0].double(),), pyr_r, kp, valid, d_min, d_max, cfg)
    with pytest.raises(ValueError, match="valid"):
        stereo_k.match_kernel(pyr_l, pyr_r, kp, valid.float(), d_min, d_max, cfg)


@pytest.mark.parametrize("n", [256, 8192])
def test_verify_pose_gives_the_bits_under_its_own_kernel_name(cuda, n):
    """`verify_pose` (the loop verifier's entry) launches the pose kernel's
    second entry, `loop_verify_pose_kernel`, and gives the plain version's
    verification bits; tracking's `estimate_pose` still launches
    `estimate_pose_kernel` with the bits it gave before.  A profiler tells
    the two apart by name, and what wraps `estimate_pose` sees tracking's
    call alone."""
    from torch.profiler import ProfilerActivity, profile

    intr, T, P, uv, valid = _pose_case(cuda, n=n)
    kw = {"chi2_th": 5.991, "outer_iterations": 4, "drop_kernel_after": 3, "cfg": lm.LMConfig(iterations=10)}
    seen = []
    raw = pose_k.estimate_pose

    def wrapped(*a, **k):
        seen.append(k.get("verification", False))
        return raw(*a, **k)

    pose_k.estimate_pose = wrapped
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            v = pose_k.verify_pose(intr, T, P, uv, valid, **kw)
            t = pose_k.estimate_pose(intr, T, P, uv, valid)
            torch.cuda.synchronize()
    finally:
        pose_k.estimate_pose = raw
    assert seen == [False]
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("loop_verify_pose_kernel" in x for x in names) == 1, names
    assert sum("estimate_pose_kernel" in x for x in names) == 1, names
    v_e = pose_k.estimate_pose_eager(intr, T, P, uv, valid, verification=True, **kw)
    t_e = pose_k.estimate_pose_eager(intr, T, P, uv, valid)
    for got, want in ((v, v_e), (t, t_e)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("linear_solver", ["cholesky", "pcg"])
def test_ba_step_card_matches_cpu(cuda, monkeypatch, linear_solver):
    """`backend.ba_step` at the default capacities (K=16, L=2048, E=5120, 512
    lanes) on the card against the same call on a CPU copy of the map, at
    f32: at the default path's bf16 an ulp between card and CPU can move a
    cross term by 2^-8 and chi past the bar, as the reference's own chi
    moves across XLA's instruction sets (chip_smoke.py step 6).  The
    map is the one the default path hands to its third BA (the corridor,
    a keyframe every second frame): the window optimized before, the new
    keyframe and its landmarks not.  Bars of chip_smoke.py: chi 1e-3
    relative, poses relative to the oldest keyframe 1e-3, outlier verdicts
    >= 99% and observation counts equal where they agree.  With Cholesky
    the card reads from the host once per LM attempt, no more."""
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.state import Capacities
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    calls = []
    ba_step = backend.ba_step

    def keep_args(*args):
        calls.append(args)
        return ba_step(*args)

    monkeypatch.setattr(backend, "ba_step", keep_args)
    ds = SyntheticPlanesDataset(n_frames=5, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 2,
                     "linear_solver": linear_solver})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.device.type == "cuda" and vo.ba_mode == "inline" and vo.init()
    while vo.step():
        pass
    assert len(calls) == 3
    cfg, rig, wmap, ba_cfg = calls[-1]
    assert cfg.caps == Capacities() and int(wmap.num_keyframes()) == 3
    assert ba_cfg.assembly_precision == "bf16"
    ba_cfg = ba_cfg._replace(assembly_precision="f32")
    (map_g, st_g), reads = timer.count_host_reads(lambda: ba_step(cfg, rig, wmap, ba_cfg))
    map_c, st_c = ba_step(cfg, rig.to("cpu"), wmap.to("cpu"), ba_cfg)
    assert map_g.lm_pos.is_cuda and st_g.chi.is_cuda
    assert st_g.iterations >= 1 and np.isfinite(float(st_g.chi))
    if linear_solver == "cholesky":
        assert reads == st_g.attempts, (reads, st_g.attempts)
    np.testing.assert_allclose(float(st_g.chi), float(st_c.chi), rtol=1e-3)
    valid = wmap.kf_valid.cpu().numpy()
    oldest = int(np.argmax(valid))

    def relative(T):
        T = T.double().cpu().numpy()
        return (T @ np.linalg.inv(T[oldest]))[valid]

    np.testing.assert_allclose(relative(map_g.kf_pose), relative(map_c.kf_pose), rtol=0, atol=1e-3)
    agree = np.ones(tuple(wmap.kf_lm.shape), bool)
    for name in ("kf_obs_left", "kf_obs_right"):
        a, b = getattr(map_g, name).cpu().numpy(), getattr(map_c, name).numpy()
        assert (a == b).mean() >= 0.99
        agree &= a == b
    kf_lm = wmap.kf_lm.cpu().numpy()
    ids = kf_lm[agree & (kf_lm >= 0)]
    np.testing.assert_array_equal(map_g.lm_obs.cpu().numpy()[ids], map_c.lm_obs.numpy()[ids])


def test_ba_step_is_reproducible(cuda, monkeypatch):
    """Two `backend.ba_step` calls on one map at the default capacities give
    bit-equal maps and stats, without torch.use_deterministic_algorithms."""
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    calls = []
    ba_step = backend.ba_step
    monkeypatch.setattr(backend, "ba_step", lambda *a: (calls.append(a), ba_step(*a))[1])
    ds = SyntheticPlanesDataset(n_frames=5, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 2})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init() and not torch.are_deterministic_algorithms_enabled()
    while vo.step():
        pass
    cfg, rig, wmap, ba_cfg = calls[-1]
    (m1, s1), (m2, s2) = ba_step(cfg, rig, wmap, ba_cfg), ba_step(cfg, rig, wmap, ba_cfg)
    for name in ("lm_pos", "lm_obs", "kf_pose", "kf_obs_left", "kf_obs_right"):
        assert torch.equal(getattr(m1, name), getattr(m2, name)), name
    assert torch.equal(s1.chi, s2.chi) and s1.attempts == s2.attempts and s1.iterations == s2.iterations


def test_loop_verify_card_matches_cpu(cuda):
    """`LoopCloser._verify` (frame-mode K1 forward and backward, then K2's
    verification rounds) on the card against the same closer on the CPU: a
    revisit 0.4 m ahead and 2 degrees off.  The verdict equal, the inlier
    count within 10%, the measured transform within 2e-2 m and 0.1 degrees
    (KLT lanes at a gate threshold may fall either way)."""
    from legoslam_tpu_torch.pipeline import loop_closure
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset

    H, W, focal = 160, 240, 260.0
    ds = SyntheticPlanesDataset(n_frames=2, shape=(H, W), focal=focal, baseline=0.54)
    c, s = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    T_B = np.eye(4)
    T_B[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T_B[:3, 3] = [0.05, 0.0, 0.4]

    def view(T_wc):
        """Image, a 12-px grid of pixels and their exact world points."""
        img, depth = ds._render_with_depth(T_wc, ds.rig.left)
        us, vs = np.meshgrid(np.arange(20, W - 20, 12), np.arange(20, H - 20, 12))
        uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float64)
        z = depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
        ok = np.isfinite(z) & (z < 60)
        uv, z = uv[ok], z[ok]
        p_cam = np.stack([(uv[:, 0] - W / 2) / focal * z, (uv[:, 1] - H / 2) / focal * z, z], -1)
        return img, uv, p_cam @ T_wc[:3, :3].T + T_wc[:3, 3]

    closers = [loop_closure.LoopCloser(ds.rig, device=d) for d in ("cuda", "cpu")]
    # the detector shut: add_keyframe only stores the records
    for lc in closers:
        lc.cfg.zncc_min = 1.1
        for k, T_wc in enumerate((np.eye(4), T_B)):
            img, uv, pw = view(T_wc)
            assert lc.add_keyframe(k, img, np.linalg.inv(T_wc), uv, pw) is None
    n0, p0 = klt_k.klt_pyramid_kernel.launches, pose_k.estimate_pose_kernel.launches
    (ok_g, M_g, n_g), (ok_c, M_c, n_c) = (lc._verify(0) for lc in closers)
    assert klt_k.klt_pyramid_kernel.launches == n0 + 4  # forward and reverse measurement, 2 launches each
    assert pose_k.estimate_pose_kernel.launches == p0 + 2
    assert ok_g and ok_c and n_g >= 50 and abs(n_g - n_c) <= 0.1 * n_c
    assert np.linalg.norm(M_g[:3, 3] - M_c[:3, 3]) < 2e-2
    ang = np.arccos(np.clip((np.trace(M_g[:3, :3].T @ M_c[:3, :3]) - 1) / 2, -1, 1))
    assert ang < np.deg2rad(0.1)
    M_true = np.linalg.inv(T_B)
    assert np.linalg.norm(M_g[:3, 3] - M_true[:3, 3]) < 0.08


@pytest.mark.parametrize("zero_rows", [(), (24, 25, 26, 27, 28, 29)])
def test_marginalize_card_matches_cpu(cuda, zero_rows):
    """`marginalize` on the card (eigh on cuSOLVER) against the CPU (LAPACK)
    on a well-conditioned system: H, b and J^T J within 1e-4 of the largest
    entry; `sqrt_J` itself is not unique."""
    from legoslam_tpu_torch.solver import marginalization

    rng = np.random.default_rng(0)
    n = 30
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    keep = np.ones(n)
    keep[list(zero_rows)] = 0.0
    H = torch.from_numpy((((Q * rng.uniform(1.0, 40.0, n)) @ Q.T) * keep[:, None] * keep[None, :]).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=n) * keep).astype(np.float32))
    mask = torch.zeros(n, dtype=torch.bool)
    mask[12:18] = True
    f_c = marginalization.marginalize(H, b, mask, 6)
    f_g = marginalization.marginalize(H.to(cuda), b.to(cuda), mask.to(cuda), 6)
    assert all(x.is_cuda for x in f_g)
    scale = float(f_c.H.abs().max())
    assert float((f_g.H.cpu() - f_c.H).abs().max()) <= 1e-4 * scale
    assert float((f_g.b.cpu() - f_c.b).abs().max()) <= 1e-4 * float(f_c.b.abs().max())
    assert float(((f_g.sqrt_J.T @ f_g.sqrt_J).cpu() - f_c.sqrt_J.T @ f_c.sqrt_J).abs().max()) <= 1e-4 * scale
    jte_g, jte_c = (f_g.sqrt_J.T @ f_g.err).cpu(), f_c.sqrt_J.T @ f_c.err
    assert float((jte_g - jte_c).abs().max()) <= 1e-3 * float(jte_c.abs().max())


def _third_ba_map(monkeypatch):
    """The map the default path hands to its third BA (as above), with its
    configuration and rig, on the card."""
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    calls = []
    ba_step = backend.ba_step
    monkeypatch.setattr(backend, "ba_step", lambda *a, **kw: (calls.append(a), ba_step(*a, **kw))[1])
    ds = SyntheticPlanesDataset(n_frames=5, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 2})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init()
    while vo.step():
        pass
    monkeypatch.setattr(backend, "ba_step", ba_step)
    return calls[-1]


def test_chunk_equals_stepwise_on_the_card(cuda):
    """`process_chunk` on frames already on the card is `process_frame` in a
    loop: the same bits, and the kernels launched once per tracking frame."""
    from legoslam_tpu_torch.pipeline import frontend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import initial_carry, process_chunk, process_frame
    from legoslam_tpu_torch.utils.config import Config

    ds = SyntheticPlanesDataset(n_frames=10, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    ds.init()
    frames = [ds.next_frame() for _ in range(10)]
    il = torch.from_numpy(np.stack([f.left for f in frames])).to(cuda)
    ir = torch.from_numpy(np.stack([f.right for f in frames])).to(cuda)
    cfg = frontend.FrontendConfig.from_config(Config({"stereo_depth_inferior_limit": 2.0,
                                                      "stereo_depth_superior_limit": 50.0,
                                                      "detect_mask_half": 6, "gftt_min_distance": 6}))
    rig = ds.rig.to(cuda)
    carry = initial_carry(cfg, il.shape[1:], torch.float32, cuda)
    outs = []
    for k in range(10):
        carry, out = process_frame(cfg, rig, carry, il[k], ir[k], k)
        outs.append(out)
    n_klt, n_pose = klt_k.klt_pyramid_anchored_kernel.launches, pose_k.estimate_pose_kernel.launches
    carry2, chunk = process_chunk(cfg, rig, initial_carry(cfg, il.shape[1:], torch.float32, cuda), il, ir, range(10))
    tracking = sum(o.status != 0 and k > 0 for k, o in enumerate(outs))
    assert klt_k.klt_pyramid_anchored_kernel.launches - n_klt == tracking
    assert pose_k.estimate_pose_kernel.launches - n_pose == tracking
    assert torch.equal(chunk.T_cw, torch.stack([o.T_cw for o in outs]))
    assert chunk.status.tolist() == [o.status for o in outs] and chunk.T_cw.is_cuda
    assert torch.equal(carry2.wmap.kf_pose, carry.wmap.kf_pose) and torch.equal(carry2.wmap.lm_pos, carry.wmap.lm_pos)


def test_async_snapshot_survives_until_the_merge(cuda, monkeypatch):
    """A solve on the side stream reads its snapshot while the main stream
    frees the caller's copy and writes garbage into freshly allocated
    memory: the merged map is bit-equal to the synchronous `ba_step` of the
    same map (the snapshot was neither freed nor overwritten early), and
    `poll` does not merge before the side stream is done."""
    from legoslam_tpu_torch.pipeline import async_backend, backend

    cfg, rig, wmap, ba_cfg = _third_ba_map(monkeypatch)
    m_sync, _ = backend.ba_step(cfg, rig, wmap, ba_cfg)

    class Slow(async_backend.AsyncBackend):
        def _solve(self, snap):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of device time on the side stream first
            return super()._solve(snap)

    ab = Slow(cfg, rig, ba_cfg, dispatch_every=1, device=cuda)
    copy = wmap.map(lambda x: x.clone() if torch.is_tensor(x) else x.map(torch.clone))
    ab.observe()
    ab.dispatch(copy)
    del copy
    junk = [torch.full((1 << 20,), float("nan"), device=cuda) for _ in range(64)]
    merged = copy_or_none = None
    for _ in range(10_000):
        merged = ab.poll(wmap)
        if merged is not wmap:
            break
        copy_or_none = torch.empty(1 << 16, device=cuda).fill_(7.0)
    else:
        merged = ab.flush(wmap)
    del junk, copy_or_none
    torch.cuda.synchronize()
    assert ab.stats == {"dispatched": 1, "merged": 1, "skipped": 0}
    for name in ("lm_pos", "lm_obs", "kf_pose", "kf_obs_left", "kf_obs_right"):
        assert torch.equal(getattr(merged, name), getattr(m_sync, name)), name


def test_async_vo_on_the_card(cuda):
    """`ba_mode: async` with "auto" on one card: the side stream of the same
    device; every solve merged, every frame TRACKING_GOOD."""
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    ds = SyntheticPlanesDataset(n_frames=14, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "ba_mode": "async"})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init()
    ab = vo.async_backend
    assert (ab.ba_device is None) == (torch.cuda.device_count() == 1) and ab._stream is not None
    vo.run()
    assert (vo.statuses() == 1).all()
    assert ab.stats["merged"] == ab.stats["dispatched"] >= 1 and ab.pending is None


def test_pose_graph_is_reproducible_and_matches_cpu(cuda):
    """`pose_graph.optimize` on the card twice gives the same bits (its sums
    in a fixed order), and agrees with the CPU: chi within 1e-4 relative,
    poses within 1e-4, both run to convergence (the default stop rule, a chi
    change under 1e-5, ends before 1e-4 of a chi of ~5e-3 is resolved)."""
    from legoslam_tpu_torch.solver import lm, pose_graph

    cfg = lm.LMConfig(iterations=50, diff_chi_threshold=1e-10)

    rng = np.random.default_rng(0)
    n = 40
    step = se3.se3_exp(torch.tensor([0.0, 0, 0.5, 0, 2 * np.pi / n, 0]))
    gt = [torch.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    e_i, e_j, meas, est = [], [], [], [gt[0]]
    for i in range(1, n):
        rel = se3.se3_exp(torch.from_numpy(rng.normal(scale=0.02, size=6).astype(np.float32))) @ (
            gt[i] @ torch.linalg.inv(gt[i - 1]))
        e_i.append(i), e_j.append(i - 1), meas.append(rel), est.append(rel @ est[-1])
    e_i.append(n - 1), e_j.append(0), meas.append(gt[n - 1] @ torch.linalg.inv(gt[0]))
    E = len(e_i)
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    graph = pose_graph.PoseGraph(e_i=torch.tensor(e_i), e_j=torch.tensor(e_j), T_meas=torch.stack(meas),
                                 weight=torch.tensor([1.0] * (n - 1) + [100.0] * (E - n + 1)),
                                 valid=torch.ones(E, dtype=torch.bool), fixed=fixed)
    P0 = torch.stack(est)
    on_card = pose_graph.PoseGraph(*(x.to(cuda) if x is not None else None for x in graph))
    (P1, r1), (P2, r2) = (pose_graph.optimize(P0.to(cuda), on_card, cfg=cfg) for _ in range(2))
    Pc, rc = pose_graph.optimize(P0, graph, cfg=cfg)
    assert torch.equal(P1, P2) and torch.equal(r1.chi, r2.chi)
    np.testing.assert_allclose(float(r1.chi), float(rc.chi), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(P1.cpu().numpy(), Pc.numpy(), rtol=0, atol=1e-4)


def test_every_frame_sync_is_a_named_read(cuda):
    """Under a profiler, with the benchmark's own spans around the port's
    stages (each ending in `torch.cuda.synchronize()`, portbench/hooks.py):
    a tracking frame's synchronizations are its `read` spans, one each, and
    a keyframe frame's (window BA included) all happen inside its `read`
    spans, none of which is empty; an explicit synchronize counts none."""
    from torch.profiler import ProfilerActivity, profile

    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config
    from portbench.hooks import Hooks

    ds = SyntheticPlanesDataset(n_frames=8, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 3})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init()
    for _ in range(4):  # init, then the window past its first BA
        assert vo.step()
    hooks = Hooks().install()
    try:
        hooks.spans = hooks.sync = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            while vo.step():
                pass
            with timer.span("frame", frame=-2):
                torch.cuda.synchronize()
    finally:
        hooks.remove()
    record = timer.records()
    frames = [s for s in record if s.name == "frame"]
    assert frames[-1].frame == -2 and frames[-1].syncs == 0
    branches = {f.attrs["branch"] for f in frames[:-1]}
    assert {"track", "keyframe"} <= branches, branches
    for f in frames[:-1]:
        reads = [s for s in record if s.name == "read" and s.frame == f.frame]
        assert f.syncs == sum(r.syncs for r in reads) and all(r.syncs >= 1 for r in reads), (f, reads)
        if f.attrs["branch"] == "track":
            assert f.syncs == len(reads), (f, reads)
    assert timer.count_host_reads(torch.cuda.synchronize)[1] == 0


def _lm_bits():
    """tests/lm_bits.py, loaded by path (the card's Python has a `tests`
    package of its own)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("lm_bits", os.path.join(os.path.dirname(__file__), "lm_bits.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def full_windows():
    """The last three window BA calls of a 38-frame run of the corridor on
    the card (a keyframe every second frame): 15 keyframes each, the window
    full, at the default capacities (K=16, L=2048, E=5120)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config

    calls = []
    ba_step = backend.ba_step
    backend.ba_step = lambda *a, **kw: (calls.append(a), ba_step(*a, **kw))[1]
    try:
        ds = SyntheticPlanesDataset(n_frames=38, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
        config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                         "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 2})
        vo = VisualOdometry(config=config, dataset=ds)
        assert vo.init()
        vo.run()
    finally:
        backend.ba_step = ba_step
    assert (vo.statuses() == 1).all()
    windows = calls[-3:]
    assert [int(w[2].num_keyframes()) for w in windows] == [15, 15, 15]
    return windows


def _window_problem(window):
    from legoslam_tpu_torch.pipeline import backend
    from legoslam_tpu_torch.solver import schur

    cfg, rig, wmap, _ = window
    p, _ = backend.build_problem(cfg, rig, wmap)
    KW, NF = cfg.caps.window, cfg.caps.max_features
    return p, schur.order_for(p.graph, KW, p.points.shape[0], widths=(2 * NF, 2 * KW, 2))


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_ba_graph_gives_the_eager_loops_bits(cuda, full_windows, monkeypatch, precision, prior):
    """`lm.solve_ba` on the card, each LM attempt a replay of the captured
    CUDA graph (solver/ba_graph.py), returns the plain host-decided loop's
    (tests/lm_bits.py `host_decided_lm`, op by op on the card) poses,
    points, chi, lambda, iterations and attempts bit for bit on
    three full windows, at bf16 and f32 assembly, with and without a pose
    prior.  The signature is captured at its first solve and the other
    windows replay it without a new capture; a solve reads the host once
    per attempt; its `lm_attempt` spans say `graph` 1."""
    from torch.profiler import ProfilerActivity, profile

    from legoslam_tpu_torch.solver import ba_graph, robust

    bits = _lm_bits()
    monkeypatch.setattr(ba_graph, "_SOLVERS", {})
    captures = []
    capture = ba_graph._Solver._capture
    monkeypatch.setattr(ba_graph._Solver, "_capture", lambda self, *a: (captures.append(1), capture(self, *a))[1])
    cfg = lm.LMConfig(assembly_precision=precision)
    for k, window in enumerate(full_windows):
        p, order = _window_problem(window)
        pose_prior = bits.pose_prior(p.poses, 11 + k) if prior else None
        (st, res), reads = timer.count_host_reads(lambda: lm.solve_ba(
            p.graph, p.poses, p.points, cfg=cfg, pose_prior=pose_prior, order=order))
        fns = lm.ba_functions(p.graph, order, lm.ba_prior(pose_prior) if prior else None, robust.HUBER, 5.991, cfg)
        host = bits.host_decided_lm(fns, lm.BAState(p.poses, p.points), cfg)
        bits.assert_same_lm_bits(res, host)
        assert st is res.state and st.poses.is_cuda and res.attempts >= res.iterations >= 1
        assert reads == res.attempts, (reads, res.attempts)
        assert len(captures) == 1 and len(ba_graph._SOLVERS) == 1
    with profile(activities=[ProfilerActivity.CPU]):
        _, res = lm.solve_ba(p.graph, p.poses, p.points, cfg=cfg, pose_prior=pose_prior, order=order)
    attempts = [s for s in timer.records() if s.name == "lm_attempt"]
    assert len(attempts) == res.attempts and all(a.attrs["graph"] == 1 for a in attempts)
    assert not any(s.name == "lm_capture" for s in timer.records()) and len(captures) == 1


def test_async_ba_captures_and_replays_on_its_worker(cuda, monkeypatch):
    """`ba_mode: async` on the card: the window solve's CUDA graph is
    captured on the async backend's worker thread, while the frame loop
    tracks on its own, and replayed there; each async solve's result is
    bit-equal to the inline solve of the same snapshot (`solve_window` on
    this thread, replaying the same graphs)."""
    import threading

    from legoslam_tpu_torch.pipeline import async_backend, backend
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.solver import ba_graph
    from legoslam_tpu_torch.utils.config import Config

    monkeypatch.setattr(ba_graph, "_SOLVERS", {})
    threads = []
    capture = ba_graph._Solver._capture
    monkeypatch.setattr(ba_graph._Solver, "_capture",
                        lambda self, *a: (threads.append(threading.get_ident()), capture(self, *a))[1])
    solves = []
    solve = async_backend.AsyncBackend._solve
    monkeypatch.setattr(async_backend.AsyncBackend, "_solve",
                        lambda self, wmap: (lambda out: (solves.append((wmap, out)), out)[1])(solve(self, wmap)))
    ds = SyntheticPlanesDataset(n_frames=14, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                     "detect_mask_half": 6, "gftt_min_distance": 6, "ba_mode": "async"})
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init()
    ab = vo.async_backend
    assert ab.ba_device is None or torch.cuda.device_count() > 1
    vo.run()
    torch.cuda.synchronize()
    assert (vo.statuses() == 1).all() and ab.stats["merged"] == ab.stats["dispatched"] == len(solves) >= 2
    assert len(threads) == 1 and threads[0] != threading.get_ident()
    for wmap, out in solves:
        inline = backend.solve_window(ab.cfg, ab.rig, wmap, ab.ba_cfg)
        for name in ("poses", "points", "out_l", "out_r"):
            assert torch.equal(getattr(out, name), getattr(inline, name)), name
        assert torch.equal(out.stats.chi, inline.stats.chi) and torch.equal(out.stats.lam, inline.stats.lam)
        assert (out.stats.iterations, out.stats.attempts) == (inline.stats.iterations, inline.stats.attempts)
    assert len(threads) == 1  # the inline solves replayed the worker's graphs
