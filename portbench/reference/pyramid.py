# Frozen copy of legoslam_tpu_torch/ops/pyramid.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Image pyramids (twin of legoslam_tpu/ops/pyramid.py).

An exact 0.5 `cv::resize` INTER_LINEAR is a 2x2 mean with truncated odd
edges (algorithm.cpp:139-154)."""

from __future__ import annotations

from typing import List

import torch


def down2(img: torch.Tensor) -> torch.Tensor:
    """Half-resolution by exact 2x2 mean."""
    H, W = img.shape
    h, w = H // 2, W // 2
    return img[: 2 * h, : 2 * w].reshape(h, 2, w, 2).mean(dim=(1, 3))


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[level0 = img, level1 = down2(img), ...]."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(down2(pyr[-1]))
    return pyr
