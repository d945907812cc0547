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
approximation, which GN re-linearizes away).  These depend on the
measurement alone, so H is assembled and factored once per solve and each
Gauss-Newton iteration only solves its b against the factors; the per-edge
work runs as array operations over all edges (`se3_logs`, `se3_exps`,
`adjoints`, the stacked twins of the scalar helpers, which give their bits).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
# Imported with the module (which the loop closer imports when it is
# built), not at the first closure, whose frame would pay for it.
import scipy.sparse as sp
import scipy.sparse.linalg as spla


# ---------------------------------------------------------------------------
# f64 SE(3) (NumPy; geometry/se3.py works in float32 tensors), one pose at a
# time: the JAX package's helpers, bit for bit, and the reference the tests
# hold the stacked maps below to
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
# The same maps over stacks, one array operation for every edge: each
# element takes the scalar helpers' operations in their order (products
# through `@`, norms as sqrt of a dot), so a stack reads what a loop of the
# helpers reads.
# ---------------------------------------------------------------------------

def _norms(v: np.ndarray) -> np.ndarray:
    """(..., k) -> (...): np.linalg.norm of each vector (sqrt of its dot)."""
    return np.sqrt((v[..., None, :] @ v[..., :, None])[..., 0, 0])


def _pows(x: np.ndarray, k: int) -> np.ndarray:
    """x**k by the C library's pow, as the scalar helpers' NumPy scalars take
    it: NumPy's array power (and x*x) can round otherwise in the last place."""
    return np.array([math.pow(v, k) for v in x.ravel()]).reshape(x.shape)


def _hats(p: np.ndarray) -> np.ndarray:
    z = np.zeros(p.shape[:-1])
    x, y, w = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([np.stack([z, -w, y], -1),
                     np.stack([w, z, -x], -1),
                     np.stack([-y, x, z], -1)], -2)


def so3_logs(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3), `so3_log` of each."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)[..., None]
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(th < 1e-10, v / 2.0, th * v / (2.0 * np.sin(th)))


def se3_logs(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6), `se3_log` of each."""
    phi = so3_logs(T[..., :3, :3])
    th = _norms(phi)[..., None, None]
    K = _hats(phi)
    Vinv = np.eye(3) - 0.5 * K
    with np.errstate(divide="ignore", invalid="ignore"):
        co = (1.0 - (th / 2.0) / np.tan(th / 2.0)) / _pows(th, 2)
    Vinv = np.where(th < 1e-8, Vinv, Vinv + co * (K @ K))
    return np.concatenate([(Vinv @ T[..., :3, 3:])[..., 0], phi], -1)


def se3_exps(xi: np.ndarray) -> np.ndarray:
    """(..., 6) -> (..., 4, 4), `se3_exp` of each."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = _norms(phi)[..., None, None]
    K = _hats(phi)
    KK = K @ K
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / _pows(th, 2)
        c = (th - np.sin(th)) / _pows(th, 3)
    small = th < 1e-8
    R = np.where(small, np.eye(3) + K + 0.5 * KK, np.eye(3) + a * K + b * KK)
    V = np.where(small, np.eye(3) + 0.5 * K + KK / 6.0, np.eye(3) + b * K + c * KK)
    T = np.broadcast_to(np.eye(4), xi.shape[:-1] + (4, 4)).copy()
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    return T


def adjoints(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6, 6), `adjoint` of each."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    A = np.zeros(T.shape[:-2] + (6, 6))
    A[..., :3, :3] = R
    A[..., 3:, 3:] = R
    A[..., :3, 3:] = _hats(t) @ R
    return A


# ---------------------------------------------------------------------------
# Gauss-Newton over chain + loop edges
# ---------------------------------------------------------------------------

_U, _V = np.divmod(np.arange(36), 6)  # a 6x6 block's entries, row by row


def solve_chain_graph(
    rel: Sequence[np.ndarray],
    loop_edges: Sequence[Tuple[int, int, np.ndarray]],
    anchor: np.ndarray = None,
    odom_weight: float = 1.0,
    loop_weight: float = 20.0,
    iterations: int = 3,
    outlier_residual: float = 0.5,
    *,
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, float, float, List[int]]:
    """Optimize a keyframe chain with loop closures, f64, deterministic.

    rel: list of n-1 odometry measurements T_{k+1} T_k^-1 (immutable).
    loop_edges: [(i, j, M_ij)] with M_ij ~= T_i T_j^-1.
    anchor: pose 0 (gauge; default identity).
    outlier_residual: after convergence, any loop edge whose residual
      translation exceeds this (meters) is dropped and the solve repeats
      once without it (a verified-but-wrong closure must not bend the
      chain; genuine post-solve loop residuals are ~measurement noise).
    stats: if given, filled with `factorizations` (SuperLU factorizations
      made: 1, or 2 after an outlier pass) and `edges` (the edges of the
      last solve).

    Returns (poses (n,4,4) f64, chi_before, chi_after, dropped_edge_idx).
    The init is ALWAYS the odometry integration — deterministic, and
    measured to sit in the correct basin while warm starts from previously
    corrected chains get stuck in theirs.

    Every edge is one row of the arrays below.  H and b are assembled in
    the order of a loop over the edges, so that their duplicate entries sum
    in that order; H once per solve, b in every iteration.
    """
    n = len(rel) + 1
    edge_i = np.concatenate([np.arange(1, n), np.array([e[0] for e in loop_edges], int)])
    edge_j = np.concatenate([np.arange(n - 1), np.array([e[1] for e in loop_edges], int)])
    edge_M = np.concatenate([np.asarray(rel, np.float64).reshape(-1, 4, 4),
                             np.asarray([e[2] for e in loop_edges], np.float64).reshape(-1, 4, 4)])
    edge_w = np.concatenate([np.full(n - 1, float(odom_weight)), np.full(len(loop_edges), float(loop_weight))])
    factorizations = 0

    def integrate() -> np.ndarray:
        P = np.empty((n, 4, 4))
        P[0] = np.eye(4) if anchor is None else np.asarray(anchor, np.float64)
        for k in range(n - 1):
            P[k + 1] = rel[k] @ P[k]
        return P

    def residuals(P, e, Minv):
        return se3_logs(Minv @ P[edge_i[e]] @ np.linalg.inv(P[edge_j[e]]))

    def chi_of(w, r) -> float:
        # 0.5 (w_0 r_0.r_0 + w_1 r_1.r_1 + ...), summed in edge order
        terms = w * (r[:, None, :] @ r[:, :, None])[:, 0, 0]
        return 0.5 * float(np.cumsum(np.concatenate([[0.0], terms]))[-1])

    def gn(e):
        nonlocal factorizations
        i, j, w = edge_i[e], edge_j[e], edge_w[e]
        Minv = np.linalg.inv(edge_M[e])
        Ji = adjoints(Minv)
        Jit = np.swapaxes(Ji, -1, -2)
        # H's blocks (i,i), (j,j), (i,j), (j,i) of each edge, record 0's left
        # out, then the gauge block (0,0); each block's 36 entries row by row
        blocks = np.stack([w[:, None, None] * (Jit @ Ji), w[:, None, None] * np.eye(6),
                           -w[:, None, None] * Jit, -w[:, None, None] * Ji], 1)
        at = np.stack([np.stack([i, i], -1), np.stack([j, j], -1),
                       np.stack([i, j], -1), np.stack([j, i], -1)], 1)
        both = (i != 0) & (j != 0)
        keep = np.stack([i != 0, j != 0, both, both], 1)
        at = np.concatenate([at[keep], [[0, 0]]])
        vals = np.concatenate([blocks[keep].reshape(-1), np.eye(6).reshape(-1)])
        rows = (6 * at[:, :1] + _U).reshape(-1)
        cols = (6 * at[:, 1:] + _V).reshape(-1)
        H = sp.csc_matrix((vals, (rows, cols)), shape=(6 * n, 6 * n))
        lu = spla.splu(H + 1e-9 * sp.identity(6 * n, format="csc"))
        factorizations += 1
        # b's parts, -w Ji^T r at i and w r (= -w Jj^T r) at j, added in
        # the loop's order: edge by edge, each edge's i part then its j part
        bi = np.stack([i, j], 1)
        bkeep = bi != 0

        P = integrate()
        r = residuals(P, e, Minv)
        chi0 = chi_of(w, r)
        for _ in range(iterations):
            parts = np.stack([-w[:, None] * (Jit @ r[:, :, None])[..., 0], w[:, None] * r], 1)
            b = np.zeros((n, 6))
            np.add.at(b, bi[bkeep], parts[bkeep])
            dx = lu.solve(b.reshape(-1)).reshape(n, 6)
            P[1:] = se3_exps(dx[1:]) @ P[1:]
            r = residuals(P, e, Minv)
        return P, chi0, chi_of(w, r), r

    edges = np.arange(len(edge_i))
    P, chi0, chi1, r = gn(edges)
    # One outlier-rejection pass over loop edges (rows n-1... of r).
    bad = [int(k) for k in np.flatnonzero(_norms(r[n - 1:, :3]) > outlier_residual)]
    dropped: List[int] = []
    if bad and len(bad) < len(loop_edges):
        dropped = bad
        edges = np.delete(edges, n - 1 + np.asarray(bad))
        P, chi0, chi1, _ = gn(edges)
    if stats is not None:
        stats.update(factorizations=factorizations, edges=len(edges))
    return P, chi0, chi1, dropped
