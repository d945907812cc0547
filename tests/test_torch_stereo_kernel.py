"""Scanline stereo's CUDA kernel (csrc/stereo.cu, K3) against its plain
version, on the CPU.

- The kernel's source compiled for the host (tests/stereo_host.py: each
  warp's lanes in turn) gives `match_eager`'s bits, uv_r and ok, on rigs
  whose disparity count takes each of `rows_sum`'s orders (D < 8, 8..31,
  >= 32) and one or two levels of carries in the window sums' prefix scan,
  at half-patches 0 to 9 (the rows past 16 summed apart at 9), on an image
  shape whose bilinear row pass is a fused multiply-add, with invalid lanes,
  lanes off the image and lanes in a texture that repeats.
- Tied costs: both take the first disparity, as torch.min does.
- The refinement run lane by lane, each until it stops or runs 6
  iterations (the kernel's loop, written plainly here), gives the batched
  loop's bits.
- `match` on CPU tensors runs the plain version, and the program's `stereo`
  spans say so (`kernel` 0); `match_kernel` refuses CPU tensors.
- `stereo_kernel_share` (portbench) reads those spans.

The card's run of the kernel itself is in tests/test_torch_kernels_gpu.py."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from legoslam_tpu_torch.kernels import stereo as stereo_k
from legoslam_tpu_torch.ops import stereo as stereo_ops
from legoslam_tpu_torch.ops.rounding import patch_sum
from legoslam_tpu_torch.utils import timer
from portbench.harness import reader
from tests import stereo_cases, stereo_host
from tests.test_torch_trace import _vo


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = stereo_host.build(str(tmp_path_factory.mktemp("stereo_host")))
    if lib is None:
        pytest.skip("needs g++ to compile csrc/stereo.cu for the host")
    return lib


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same(a, b):
    return torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(a[1], b[1])


CASES = ([(rig, h, (188, 620), 512) for rig in stereo_cases.RIGS for h in (1, 3, 5, 9)]
         + [(rig, 3, (94, 310), 150) for rig in stereo_cases.RIGS]  # 94x310: the fused row pass
         + [("kitti00", 0, (188, 620), 150)])


@pytest.mark.parametrize("rig, half_patch, shape, n", CASES)
def test_kernel_source_gives_the_plain_bits(host, rig, half_patch, shape, n):
    pyr_l, pyr_r, kp, valid, d_min, d_max = stereo_cases.stereo_case(rig, n, shape)
    cfg = stereo_ops.ScanlineConfig(half_patch=half_patch)
    plain = stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    mine = stereo_host.match(host, pyr_l[0], pyr_r[0], kp, valid, d_min, d_max, cfg)
    assert _same(mine, plain), int((_bits(mine[0]) != _bits(plain[0])).any(-1).sum())
    ok = plain[1]
    if half_patch > 0:  # a 1x1 patch has no variance: no lane passes the ZNCC gate
        assert 0.4 * int(valid.sum()) < int(ok.sum()) < int(valid.sum()), (int(ok.sum()), int(valid.sum()))
    assert not bool((ok & ~valid).any())


def test_tied_costs_take_the_first_disparity(host):
    """A constant right image ties every disparity's cost: the first wins
    (u = 1, so x_r = x - d_hi) and the uniqueness gate fails every lane."""
    pyr_l, pyr_r, kp, valid, d_min, d_max = stereo_cases.tied_case()
    d_hi = stereo_cases.first_disparity(d_min, d_max)
    for uv, ok in (stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max),
                   stereo_host.match(host, pyr_l[0], pyr_r[0], kp, valid, d_min, d_max)):
        assert torch.equal(uv[:, 0], kp[:, 0] - float(d_hi)) and not bool(ok.any())


def _refine_per_lane(strip, patch_l, u0, active0, iterations, ran):
    """The kernel's refinement: each lane on its own, until it stops or
    `iterations` have run (single-lane slices through the same ops)."""
    u = u0.clone()
    for n in range(u0.shape[0]):
        un, last, active = u0[n : n + 1], float("inf"), bool(active0[n])
        for it in range(iterations):
            if not active:
                break
            ran[n] = it + 1
            halo = stereo_k._sample_halo(strip[n : n + 1], un)
            win, gx = halo[:, :, 1:-1], 0.5 * (halo[:, :, 2:] - halo[:, :, :-2])
            err = patch_l[n : n + 1] - win
            c, h, b = patch_sum(torch.stack([err * err, gx * gx, err * gx]))
            upd = torch.where(h > 1e-9, b / torch.where(h > 0, h, 1.0), 0.0)
            apply = not bool(last < c) and bool(torch.isfinite(upd))
            if apply:
                un, last = un + upd, c
            active = apply and bool(upd.abs() >= 1e-2)
        u[n] = un[0]
    return u


@pytest.mark.parametrize("seed, half_patch", [(0, 3), (1, 3), (2, 1), (3, 5), (4, 9)])
def test_refinement_lane_by_lane_gives_the_batched_bits(monkeypatch, seed, half_patch):
    pyr_l, pyr_r, kp, valid, d_min, d_max = stereo_cases.stereo_case("kitti00", 96, seed=seed)
    cfg = stereo_ops.ScanlineConfig(half_patch=half_patch)
    batched = stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    ran = np.zeros(96, np.int64)
    monkeypatch.setattr(stereo_k, "_refine", lambda s, p, u, a, k: _refine_per_lane(s, p, u, a, k, ran))
    per_lane = stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
    assert _same(per_lane, batched)
    assert len(set(ran[ran > 0])) >= 2, np.bincount(ran)  # lanes stop at different iterations


def test_cpu_tensors_take_the_plain_version_and_the_span_says_so():
    """Stereo init and a keyframe frame on the CPU under a profiler: every
    `stereo` span has `kernel` 0 and the kernel never launched."""
    n0 = stereo_k.match_kernel.launches
    with profile(activities=[ProfilerActivity.CPU]):
        vo = _vo()
        assert vo.step() and vo.step()
    spans = [s for s in timer.records() if s.name == "stereo"]
    assert len(spans) >= 2 and all(s.attrs == {"kernel": 0} for s in spans), spans
    assert stereo_k.match_kernel.launches == n0


def test_the_kernel_refuses_cpu_tensors():
    pyr_l, pyr_r, kp, valid, d_min, d_max = stereo_cases.stereo_case("kitti00", 16)
    with pytest.raises(ValueError, match="CUDA"):
        stereo_k.match_kernel(pyr_l, pyr_r, kp, valid, d_min, d_max)
    uv, ok = stereo_ops.match(pyr_l, pyr_r, kp, valid, d_min, d_max)
    assert _same((uv, ok), stereo_k.match_eager(pyr_l, pyr_r, kp, valid, d_min, d_max))


T0 = 5_000_000_000  # ns, the traced frames' start on the host clock


@pytest.mark.parametrize("kernels, share", [((1, 1, 1), 1.0), ((1, 0), 0.5), ((0, 0), 0.0), ((None, None), None),
                                            ((), None)])
def test_stereo_kernel_share_reads_the_spans(monkeypatch, kernels, share):
    spans = [timer.Span("stereo", k, -1, 1, k, {} if g is None else {"kernel": g}, T0 + 10 * k, T0 + 10 * k + 5, 0)
             for k, g in enumerate(kernels)]
    spans.append(timer.Span("stereo", 99, -1, 1, 99, {"kernel": 0}, T0 + 2000, T0 + 2010, 0))  # after the frames
    monkeypatch.setattr(timer, "records", lambda: spans)
    ctx = types.SimpleNamespace(frames=[{"start": 1e-9 * T0, "done": 1e-9 * (T0 + 1000)}])
    assert reader("stereo_kernel_share")(ctx) == share
