"""Inputs for the scanline stereo tests, on any device, with no JAX (the
GPU tests load this file by path).

A rig is (f * b in px m, nearest depth m, farthest depth m); its disparity
count D (kernels/stereo.py `disparities`) decides which of `rows_sum`'s
orders the cross term takes (D < 8, 8 <= D < 32, D >= 32) and how many
levels of carries the window sums' prefix scan has.
"""

from __future__ import annotations

import numpy as np
import torch

from legoslam_tpu_torch.kernels import stereo as stereo_k

# KITTI at half resolution: f 359.428 px (00) / 353.546 px (05), baseline 0.5372 m.
FXB_00 = 359.428 * 0.5372
FXB_05 = 353.5456 * 0.5372
RIGS = {
    "d7": (FXB_00, 60.0, 200.0),         # D = 7: the cross term's C < 8 order, a one-chunk scan
    "kitti00": (FXB_00, 8.0, 200.0),     # D = 28: four partial sums in every column
    "kitti05": (FXB_05, 8.0, 250.0),     # D = 27
    "smoke": (360.0 * 0.54, 2.0, 50.0),  # chip_smoke's plane world, D = 98: 96 columns row by row
    "near": (FXB_00, 0.5, 200.0),        # D = 390: two levels of carries
}


def disparity_range(rig: str):
    """(d_min, d_max) as frontend.find_features_in_right computes them."""
    fxb, z_near, z_far = RIGS[rig]
    return fxb / z_far, fxb / max(z_near, 0.5)


def _smooth(rng, H, W, cell=6):
    base = torch.from_numpy(rng.uniform(0, 1, (1, 1, H // cell + 3, W // cell + 3)).astype(np.float32))
    img = torch.nn.functional.interpolate(base, size=(H, W), mode="bicubic", align_corners=False)[0, 0]
    return img * 255.0


def stereo_case(rig: str, n: int = 512, shape=(188, 620), seed: int = 0, device="cpu"):
    """(pyr_l, pyr_r, kp, valid, d_min, d_max): a textured left image, the
    right one the left moved by a subpixel disparity inside the rig's range
    plus noise, and a band of rows with a texture that repeats every 5 px
    (ambiguous lanes).  Keypoints anywhere up to 8 px past the border (some
    strips leave the image), a tenth of the lanes invalid."""
    rng = np.random.default_rng(seed)
    H, W = shape
    d_min, d_max = disparity_range(rig)
    left = _smooth(rng, H, W)
    band = slice(H // 2, H // 2 + max(8, H // 8))
    x = torch.arange(W, dtype=torch.float32)
    left[band] = 128.0 + 80.0 * torch.sin(2.0 * np.pi * x / 5.0)[None, :]
    shift = min(0.5 * (d_min + d_max), 0.5 * W) + 0.37  # subpixel: the refinement has work to do
    xs = np.clip(np.arange(W) + shift, 0, W - 1)
    i0 = np.minimum(np.floor(xs).astype(np.int64), W - 2)
    f = torch.from_numpy((xs - i0).astype(np.float32))
    right = (1.0 - f) * left[:, i0] + f * left[:, i0 + 1]
    right = right + torch.from_numpy(rng.normal(0, 1.5, (H, W)).astype(np.float32))
    kp = np.stack([rng.uniform(-8, W + 8, n), rng.uniform(-8, H + 8, n)], -1).astype(np.float32)
    kp[: n // 8, 1] = rng.uniform(band.start, band.stop - 1, n // 8)  # in the repeated band
    valid = rng.uniform(size=n) > 0.1
    out = [left.contiguous(), right.contiguous(), torch.from_numpy(kp), torch.from_numpy(valid)]
    left, right, kp, valid = (t.to(device) for t in out)
    return (left,), (right,), kp, valid, d_min, d_max


def tied_case(n: int = 64, shape=(188, 620), seed: int = 1, device="cpu"):
    """A textured left image and a constant right one: every disparity's
    cost is the same number, so the winner is the first (the lane's x_r is
    x - d_hi) and every lane is ambiguous."""
    pyr_l, pyr_r, kp, valid, d_min, d_max = stereo_case("kitti00", n, shape, seed, device)
    return pyr_l, (torch.full_like(pyr_r[0], 97.0),), kp, torch.ones_like(valid), d_min, d_max


def first_disparity(d_min: float, d_max: float) -> int:
    """The disparity of the first cost column, d_hi."""
    return stereo_k.disparities(d_min, d_max)[0]
