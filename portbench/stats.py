"""The arithmetic of the end-to-end and device metrics: percentiles over
all frames, latency from when a frame was due, the union of device
intervals, and the ATE (copied from the port's utils/evaluation.py)."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all `values`, linear between order statistics
    (numpy's default)."""
    if len(values) == 0:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def latencies(due: Sequence[float], done: Sequence[float]) -> List[float]:
    """Seconds from when each frame was due to when its pose was on the
    host.  In a closed loop a frame is due when the previous one is done;
    in an open loop on its schedule, so a stall's wait counts in every
    frame queued behind it."""
    if len(due) != len(done):
        raise ValueError("due and done differ in length")
    return [d1 - d0 for d0, d1 in zip(due, done)]


def open_loop_due(t0: float, rate_hz: float, n: int) -> List[float]:
    """Frame i is due at t0 + i / rate."""
    return [t0 + i / rate_hz for i in range(n)]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end) that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def umeyama_alignment(x: np.ndarray, y: np.ndarray):
    """Least-squares rigid alignment y ~ R x + t over (N, 3) point sets."""
    x = np.asarray(x, np.float64).T
    y = np.asarray(y, np.float64).T
    mx, my = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    cov = yc @ xc.T / x.shape[1]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, (my - R @ mx)[:, 0]


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray) -> float:
    """Absolute trajectory error RMSE after a rigid alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    R, t = umeyama_alignment(est, gt)
    err = (R @ est.T).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
