"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX (the GPU machine has none); run there with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py`.
Without a CUDA device every test skips.  Bars: KLT masks agree >= 99% and
positions within 1e-2 px where both succeed (sums in another order can move
a lane across the 1e-2 px convergence test by one GN step); pose entries
within 1e-3 and inlier masks >= 99%.  Work counts: the kernels' GN
lane-iterations within max(8, 2%) of the plain version's (a lane moved by
one GN step moves the count by one); LM attempts within
false_cnt_threshold + 3 per round: near convergence the chi change of a
step is at the float rounding level, so one run may accept it and stop
where the other rejects it and runs a rejection chain of up to
false_cnt_threshold attempts, and the iteration or two around it.

The frame-mode entry of the KLT kernel is held to the same bars, forward
and backward, and its restart rule on lanes that fail the coarsest level.

Window BA has no kernel of its own (PyTorch ops); its card run is held
against the same call on a CPU copy of the map with chip_smoke.py's bars.
So are loop verification (`LoopCloser._verify`) and `marginalize`.
"""

import warnings

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


def test_klt_kernel_refuses_bad_input(cuda):
    anchors, kp, pyr2, guess, valid, cfg = _klt_case(cuda, 3, False, n=64)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors.double(), kp, pyr2, guess, valid, cfg)
    with pytest.raises(ValueError):
        klt_k.klt_pyramid_anchored_kernel(anchors, kp, pyr2, guess, valid, cfg._replace(half_patch=4))
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


def _frame_case(dev, levels, inverse, n=512, H=188, W=620, seed=0, shift=(1, 2)):
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
    return pyr1, pyr2, kp.to(dev), guess.to(dev), valid.to(dev), klt.KLTConfig(levels=levels, inverse=inverse)


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
@pytest.mark.parametrize("n", [0, 64, 512, 1000])
def test_pose_kernel_matches_eager(cuda, strategy, n):
    intr, T, P, uv, valid = _pose_case(cuda, n=n)
    cfg = lm.LMConfig(strategy=strategy)
    n0 = pose_k.estimate_pose_kernel.launches
    at_k = torch.full((4,), -1, dtype=torch.int32, device=cuda)
    at_e = torch.zeros((4,), dtype=torch.int32, device=cuda)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, valid, cfg=cfg, attempts=at_k)
    T_e, in_e, n_e = pose_k.estimate_pose_eager(intr, T, P, uv, valid, cfg=cfg, attempts=at_e)
    T_0, in_0, n_0 = pose_k.estimate_pose_kernel(intr, T, P, uv, valid, cfg=cfg)
    torch.cuda.synchronize()
    assert pose_k.estimate_pose_kernel.launches == n0 + 2
    assert torch.equal(T_0, T_k) and torch.equal(in_0, in_k)  # reproducible; counting changes nothing
    np.testing.assert_allclose(T_k.cpu().numpy(), T_e.cpu().numpy(), rtol=0, atol=1e-3)
    assert in_k.shape == (n,) and int(n_k) == int(in_k.sum())
    if n:
        assert (in_k == in_e).float().mean().item() >= 0.99
    a_k, a_e = at_k.cpu().numpy(), at_e.cpu().numpy()
    assert (a_k >= 1).all() and (a_k <= cfg.iterations * cfg.false_cnt_threshold).all()
    assert (np.abs(a_k - a_e) <= cfg.false_cnt_threshold + 3).all(), (a_k, a_e)


def test_pose_kernel_refuses_bad_input(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=64)
    with pytest.raises(ValueError):
        pose_k.estimate_pose_kernel(intr, T, P, uv, valid, attempts=torch.zeros(3, dtype=torch.int32, device=cuda))
    big = pose_k.MAX_EDGES + 1
    with pytest.raises(ValueError, match="edges"):
        pose_k.estimate_pose_kernel(intr, T, P[:1].expand(big, 3).contiguous(), uv[:1].expand(big, 2).contiguous(),
                                    valid[:1].expand(big).contiguous())


def test_pose_kernel_all_invalid(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=64)
    T_k, in_k, n_k = pose_k.estimate_pose_kernel(intr, T, P, uv, torch.zeros_like(valid))
    assert torch.isfinite(T_k).all() and int(n_k) == 0 and not bool(in_k.any())


def test_pose_dispatch_picks_kernel_on_cuda(cuda):
    intr, T, P, uv, valid = _pose_case(cuda, n=128)
    n0 = pose_k.estimate_pose_kernel.launches
    pose_k.estimate_pose(intr, T, P, uv, valid)
    assert pose_k.estimate_pose_kernel.launches == n0 + 1


@pytest.mark.parametrize("linear_solver", ["cholesky", "pcg"])
def test_ba_step_card_matches_cpu(cuda, monkeypatch, linear_solver):
    """`backend.ba_step` at the default capacities (K=16, L=2048, E=5120, 512
    lanes) on the card against the same call on a CPU copy of the map.  The
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
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            map_g, st_g = ba_step(cfg, rig, wmap, ba_cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
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


def test_loop_verify_card_matches_cpu(cuda):
    """`LoopCloser._verify` (frame-mode K1 forward and backward, then the
    plain pose rounds) on the card against the same closer on the CPU: a
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
    n0 = klt_k.klt_pyramid_kernel.launches
    (ok_g, M_g, n_g), (ok_c, M_c, n_c) = (lc._verify(0) for lc in closers)
    assert klt_k.klt_pyramid_kernel.launches == n0 + 4  # forward and reverse measurement, 2 launches each
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
