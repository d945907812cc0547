"""The yardstick of the kernels' rooflines: the card's published peaks and
the work of K1 (csrc/klt_anchored.cu) and K2 (csrc/pose.cu) counted from
their inputs, copied from chip_smoke.py (`bound`, `klt_flop`,
`touched_pixels`, `klt_window_bytes`, `POSE_FLOP_PER_EDGE`)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# One H100 SXM (NVIDIA's data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores

# FLOPs of one pose edge per LM pass, as the function needs them:
# projection and Jacobian (~40), Huber weights with W symmetric (~15), the
# rows of J^T W (36) and the b terms (14), the sums of H's 21 upper entries
# (84), of b (12) and chi (1).  K2 also sums H's 15 lower entries and
# computes W10 apart from W01, to give the plain version's bits: not counted.
POSE_FLOP_PER_EDGE = 202


def bound(flop: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, kind): the least time the card could take for this work."""
    t_ops, t_bytes = flop / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def klt_flop(half_patch: int = 3) -> Tuple[int, int, int]:
    """FLOPs of one KLT GN iteration, of one lane's ZNCC gate and of one
    frame-mode template at `half_patch`.  An iteration: the window's
    bilinear samples (three lerps of 4), the terms (err 1, gradients 4,
    cost 2, H 6, b 4), the 2x2 solve; the gate: the patch's samples and 8
    for its sums a term; a template: its window's samples, per lane and
    level."""
    window, terms = (2 * half_patch + 3) ** 2, (2 * half_patch + 1) ** 2
    return window * 12 + terms * 17 + 20, terms * 20, window * 12


def touched_pixels(shape, lo, hi, radius: int = 4) -> int:
    """Pixels of one pyramid level inside the union of the lanes' windows.
    Lane n's window centre moved within the box `lo[n]`..`hi[n]` (x, y in
    this level's pixels); bilinear sampling of the halo window reads
    floor(centre - radius) .. floor(centre + radius) + 1, clamped to the
    image."""
    h, w = shape
    lo, hi = np.asarray(lo, np.float64).reshape(-1, 2), np.asarray(hi, np.float64).reshape(-1, 2)
    x0 = np.clip(np.floor(lo[:, 0] - radius), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(lo[:, 1] - radius), 0, h - 1).astype(np.int64)
    x1 = np.clip(np.floor(hi[:, 0] + radius) + 1, 0, w - 1).astype(np.int64)
    y1 = np.clip(np.floor(hi[:, 1] + radius) + 1, 0, h - 1).astype(np.int64)
    cover = np.zeros((h + 1, w + 1), np.int64)  # a 2-D difference array of the boxes
    np.add.at(cover, (y0, x0), 1)
    np.add.at(cover, (y0, x1 + 1), -1)
    np.add.at(cover, (y1 + 1, x0), -1)
    np.add.at(cover, (y1 + 1, x1 + 1), 1)
    return int((cover.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def klt_window_bytes(shapes: Sequence[Tuple[int, int]], scale: float, levels: int, valid: np.ndarray,
                     *tracks: np.ndarray, half_patch: int = 3) -> int:
    """Bytes of a float32 pyramid's first `levels` levels (of `shapes`) that
    a launch must read: per level, the union over the valid lanes of the
    windows along each lane's way.  `tracks` are (N, 2) level-0 positions
    the lane's window visited (its start and, where it succeeded, its end);
    the window is taken to have stayed inside their bounding box."""
    valid = np.asarray(valid, bool)
    pts = np.stack([np.asarray(t, np.float64)[valid] for t in tracks])  # (T, n, 2)
    pts = np.where(np.isfinite(pts), pts, pts[:1])
    lo, hi = pts.min(0), pts.max(0)
    return 4 * sum(touched_pixels(tuple(shapes[k]), lo * scale ** k, hi * scale ** k, half_patch + 1)
                   for k in range(levels))


def k1_anchored_work(n_lanes: int, valid: np.ndarray, gn: int, shapes, scale: float, levels: int, halo: int,
                     guess: np.ndarray, kp: np.ndarray, ok: np.ndarray, half_patch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one anchored launch: the GN lane-iterations and the
    gate; the valid lanes' templates, the pixels their windows touch
    between the guess and the result, the other inputs and the outputs."""
    n_valid = int(np.asarray(valid, bool).sum())
    per_iter, per_gate, _ = klt_flop(half_patch)
    tpl = n_valid * levels * halo * halo * 4
    end = np.where(np.asarray(ok, bool)[:, None], kp, guess)
    px = klt_window_bytes(shapes, scale, levels, valid, guess, end, half_patch=half_patch)
    nbytes = tpl + px + n_lanes * (2 * 4 + 2 * 4 + 1) + n_lanes * (2 * 4 + 1)
    return float(gn * per_iter + n_valid * per_gate), float(nbytes)


def k1_frame_work(n_lanes: int, valid: np.ndarray, gn: int, shapes, scale: float, levels: int,
                  kp1: np.ndarray, guess: np.ndarray, kp: np.ndarray, ok: np.ndarray,
                  half_patch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one frame-mode launch: the GN lane-iterations and
    the templates sampled at every level; the pixels the windows touch in
    the first pyramid (at kp1) and the second (between the guess and the
    result), the other inputs and the outputs."""
    n_valid = int(np.asarray(valid, bool).sum())
    per_iter, _, per_template = klt_flop(half_patch)
    end = np.where(np.asarray(ok, bool)[:, None], kp, guess)
    px = (klt_window_bytes(shapes, scale, levels, valid, kp1, half_patch=half_patch)
          + klt_window_bytes(shapes, scale, levels, valid, guess, end, half_patch=half_patch))
    nbytes = px + n_lanes * (2 * 2 * 4 + 1) + n_lanes * (2 * 4 + 1)
    return float(gn * per_iter + n_valid * levels * per_template), float(nbytes)


def k2_work(n_edges: int, n_valid: int, passes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one pose launch: `passes` LM passes (each round's
    first and every attempt) over the valid edges; the prior, each edge's
    point, measurement and flag, the pose, the inliers and their count."""
    return float(passes * n_valid * POSE_FLOP_PER_EDGE), float(16 * 4 + n_edges * (12 + 8 + 1) + 16 * 4 + n_edges + 4)
