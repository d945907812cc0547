"""Trajectory evaluation and export (twin of legoslam_tpu/utils/evaluation.py,
NumPy): Umeyama SE(3) alignment, ATE RMSE and KITTI trajectory export."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray):
    """Least-squares rigid alignment y ~ R x + t over (N, 3) point sets.

    Returns (R, t). Classic Umeyama (1991) closed form, without scale.
    """
    x = np.asarray(x, np.float64).T  # (3, N)
    y = np.asarray(y, np.float64).T
    mx, my = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    cov = yc @ xc.T / n
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, (my - R @ mx)[:, 0]


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, 3) position sequences."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    if align:
        R, t = umeyama_alignment(est, gt)
        est = (R @ est.T + t[:, None]).T
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def save_kitti_trajectory(path: str, poses_wc: Sequence[np.ndarray]) -> None:
    """Write world-from-camera poses as KITTI 12-number rows."""
    with open(path, "w") as f:
        for T in poses_wc:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")
