"""Scanline stereo matching for a rectified rig (twin of
legoslam_tpu/ops/stereo.py, `match`).

Per keypoint: sample a (P x S) strip of the right image whose rows align
with the keypoint's row and whose columns span the disparity range; ZNCC
over all integer-disparity windows from prefix sums; a uniqueness gate;
parabolic subpixel; then Gauss-Newton on the continuous disparity inside
the strip.

`match` dispatches on the device (kernels/stereo.py): the CUDA kernel
(csrc/stereo.cu) for CUDA tensors, its plain PyTorch version for CPU
tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class ScanlineConfig(NamedTuple):
    half_patch: int = 3
    refine_iterations: int = 6
    uniqueness: float = 0.85     # best/second-best (1-ZNCC) ratio gate (< passes)
    min_zncc: float = 0.75       # final acceptance score at the refined match


def match(
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    kp: torch.Tensor,
    valid: torch.Tensor,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scanline match of left keypoints kp (N, 2) in the right image.

    d_min, d_max: static disparity range (from the rig's depth gates).
    Returns (uv_right (N, 2), ok (N,))."""
    from legoslam_tpu_torch.kernels import stereo as stereo_kernels

    return stereo_kernels.match(pyr_l, pyr_r, kp, valid, d_min, d_max, cfg)
