"""Host-side f64 pose-graph solver for loop closure (the port's own copy of
legoslam_tpu/solver/pose_graph_host.py: NumPy and SciPy, no device code).

The loop-closure pose graph is numerically treacherous in float32: a
keyframe chain's Hessian conditioning grows ~N^3, and the cost landscape has
near-degenerate "bow" directions, coordinated per-edge yaw deviations that
curve the chain for almost no chi.  Three f64 Gauss-Newton iterations from
the odometry integration converge quadratically to the same optimum every
time, so the loop closer solves here, on the host.

The pose graph is a control-plane solve: it runs on accepted loop closures
only (a few per sequence), over K keyframes (not landmarks), with a
block-tridiagonal + few-loop-blocks sparsity that SciPy's sparse LU factors
in milliseconds at KITTI scale (~1300 keyframes -> 7800x7800, ~60k nonzero
blocks).  Window BA stays on the device (solver/lm.py, solver/schur.py).

Edge model: measurement M_ij ~= T_i T_j^-1 over camera-from-world poses,
residual r = Log(M^-1 T_i T_j^-1), Jacobians J_i = Ad(M^-1), J_j = -I (exact
for the left-multiplicative retraction up to the small-residual
approximation, which GN re-linearizes away).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
# Imported with the module (which the loop closer imports when it is
# built), not at the first closure, whose frame would pay for it.
import scipy.sparse as sp
import scipy.sparse.linalg as spla


# ---------------------------------------------------------------------------
# f64 SE(3) (NumPy; geometry/se3.py works in float32 tensors)
# ---------------------------------------------------------------------------

def _hat(p: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -p[2], p[1]],
        [p[2], 0.0, -p[0]],
        [-p[1], p[0], 0.0],
    ])


def so3_log(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return th * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    ) / (2.0 * np.sin(th))


def se3_log(T: np.ndarray) -> np.ndarray:
    """(4,4) -> (6,) [rho, phi], matching geometry/se3.py ordering."""
    phi = so3_log(T[:3, :3])
    th = np.linalg.norm(phi)
    K = _hat(phi)
    if th < 1e-8:
        Vinv = np.eye(3) - 0.5 * K
    else:
        co = (1.0 - (th / 2.0) / np.tan(th / 2.0)) / th**2
        Vinv = np.eye(3) - 0.5 * K + co * (K @ K)
    return np.concatenate([Vinv @ T[:3, 3], phi])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    K = _hat(phi)
    if th < 1e-8:
        R = np.eye(3) + K + 0.5 * (K @ K)
        V = np.eye(3) + 0.5 * K + (K @ K) / 6.0
    else:
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / th**2
        c = (th - np.sin(th)) / th**3
        R = np.eye(3) + a * K + b * (K @ K)
        V = np.eye(3) + b * K + c * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def adjoint(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, 3:] = R
    A[:3, 3:] = _hat(t) @ R
    return A


# ---------------------------------------------------------------------------
# Gauss-Newton over chain + loop edges
# ---------------------------------------------------------------------------

def solve_chain_graph(
    rel: Sequence[np.ndarray],
    loop_edges: Sequence[Tuple[int, int, np.ndarray]],
    anchor: np.ndarray = None,
    odom_weight: float = 1.0,
    loop_weight: float = 20.0,
    iterations: int = 3,
    outlier_residual: float = 0.5,
) -> Tuple[np.ndarray, float, float, List[int]]:
    """Optimize a keyframe chain with loop closures, f64, deterministic.

    rel: list of n-1 odometry measurements T_{k+1} T_k^-1 (immutable).
    loop_edges: [(i, j, M_ij)] with M_ij ~= T_i T_j^-1.
    anchor: pose 0 (gauge; default identity).
    outlier_residual: after convergence, any loop edge whose residual
      translation exceeds this (meters) is dropped and the solve repeats
      once without it (a verified-but-wrong closure must not bend the
      chain; genuine post-solve loop residuals are ~measurement noise).

    Returns (poses (n,4,4) f64, chi_before, chi_after, dropped_edge_idx).
    The init is ALWAYS the odometry integration — deterministic, and
    measured to sit in the correct basin while warm starts from previously
    corrected chains get stuck in theirs.
    """
    n = len(rel) + 1
    edges = [(k + 1, k, np.asarray(rel[k], np.float64), odom_weight, -1)
             for k in range(n - 1)]
    edges += [(int(i), int(j), np.asarray(M, np.float64), loop_weight, idx)
              for idx, (i, j, M) in enumerate(loop_edges)]
    dropped: List[int] = []

    def integrate() -> np.ndarray:
        P = np.empty((n, 4, 4))
        P[0] = np.eye(4) if anchor is None else np.asarray(anchor, np.float64)
        for k in range(n - 1):
            P[k + 1] = rel[k] @ P[k]
        return P

    def chi_of(P, active) -> float:
        c = 0.0
        for (i, j, M, w, _) in active:
            r = se3_log(np.linalg.inv(M) @ P[i] @ np.linalg.inv(P[j]))
            c += w * float(r @ r)
        return 0.5 * c

    def gn(active):
        P = integrate()
        chi0 = chi_of(P, active)
        Minv_adj = {id(e): adjoint(np.linalg.inv(e[2])) for e in active}
        for _ in range(iterations):
            rows, cols, vals = [], [], []
            b = np.zeros(6 * n)

            def add_block(a, c, B):
                r0, c0 = 6 * a, 6 * c
                for u in range(6):
                    for v in range(6):
                        rows.append(r0 + u)
                        cols.append(c0 + v)
                        vals.append(B[u, v])

            for e in active:
                i, j, M, w, _ = e
                r = se3_log(np.linalg.inv(M) @ P[i] @ np.linalg.inv(P[j]))
                Ji = Minv_adj[id(e)]
                # Jj = -I
                if i != 0:
                    b[6 * i:6 * i + 6] += -w * (Ji.T @ r)
                    add_block(i, i, w * (Ji.T @ Ji))
                if j != 0:
                    b[6 * j:6 * j + 6] += w * r          # -w * Jj^T r
                    add_block(j, j, w * np.eye(6))
                if i != 0 and j != 0:
                    add_block(i, j, -w * Ji.T)
                    add_block(j, i, -w * Ji)
            add_block(0, 0, np.eye(6))  # gauge
            H = sp.csc_matrix(
                (vals, (rows, cols)), shape=(6 * n, 6 * n)
            )
            dx = spla.spsolve(H + 1e-9 * sp.identity(6 * n, format="csc"), b)
            for k in range(1, n):
                P[k] = se3_exp(dx[6 * k:6 * k + 6]) @ P[k]
        return P, chi0, chi_of(P, active)

    P, chi0, chi1 = gn(edges)
    # One outlier-rejection pass over loop edges.
    bad = []
    for (i, j, M, w, idx) in edges:
        if idx < 0:
            continue
        r = se3_log(np.linalg.inv(M) @ P[i] @ np.linalg.inv(P[j]))
        if np.linalg.norm(r[:3]) > outlier_residual:
            bad.append(idx)
    if bad and len(bad) < len(loop_edges):
        dropped = bad
        active = [e for e in edges if e[4] not in bad]
        P, chi0, chi1 = gn(active)
    return P, chi0, chi1, dropped
