"""Pose-graph optimization on the device (twin of
legoslam_tpu/solver/pose_graph.py).

All relative-pose constraints are lanes of one batched residual and
Jacobian computation; the dense (6N x 6N) normal equations are summed from
the per-edge 6x6 blocks, and the port's one LM loop (solver/lm.py
`lm_optimize`, the accept decision taken on the device) runs the
optimization, each attempt op by op.  The loop closer does not call this
module: it solves its pose graph in float64 on the host
(solver/pose_graph_host.py), as the reference's closer does.

Edge model: measurement M_ij ~= T_i T_j^-1 over camera-from-world poses,
residual r = Log(M_ij^-1 T_i T_j^-1), Gauss-Newton Jacobians in the
small-residual approximation (J_i = Ad(M^-1), J_j = -I), robustified by the
same kernels as BA.

The reference assembles H with one-hot matrix products, a layout for the
TPU's matrix unit.  Here each (E, 6, 6) block is added into its place in
the block grid: by `index_add_` on a CPU, which adds in edge order, and on
a card through `schur`'s padded tables, which sum each destination's edges
in edge order too, so two runs on a card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import lm as lm_ops
from legoslam_tpu_torch.solver import robust, schur


class PoseGraph(NamedTuple):
    """Fixed-shape constraint set over N poses.

    `weight` scales the translation components of the residual and
    `rot_weight` (None: `weight`) the rotation components: odometry's
    relative rotations are usually far more reliable than its relative
    translations, so a loop bends the chain through translations first when
    rotations weigh more."""

    e_i: torch.Tensor      # (E,) int first vertex
    e_j: torch.Tensor      # (E,) int second vertex
    T_meas: torch.Tensor   # (E, 4, 4) measured T_i T_j^-1
    weight: torch.Tensor   # (E,) translation information
    valid: torch.Tensor    # (E,) bool
    fixed: torch.Tensor    # (N,) bool gauge-fixing mask
    rot_weight: Optional[torch.Tensor] = None  # (E,) rotation information

    def comp_weight(self) -> torch.Tensor:
        """(E, 6) information per residual component, [rho, phi] order."""
        wr = self.rot_weight if self.rot_weight is not None else self.weight
        return torch.cat([self.weight[:, None].expand(-1, 3), wr[:, None].expand(-1, 3)], dim=-1)


class _Order(NamedTuple):
    """`schur`'s padded tables for the block grid and the gradient (a card)."""

    H: torch.Tensor   # (N * N, W) rows of the 4E block terms per grid block
    b: torch.Tensor   # (N, W) rows of the 2E gradient terms per vertex


def residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    rel = poses[graph.e_i.long()] @ se3.se3_inv(poses[graph.e_j.long()])
    return se3.se3_log(se3.se3_inv(graph.T_meas) @ rel)  # (E, 6)


def graph_chi(poses: torch.Tensor, graph: PoseGraph, kernel: str = robust.HUBER,
              delta: float = 5.991) -> torch.Tensor:
    """0.5 * robust chi2 of the whole graph, the quantity `optimize`
    minimizes."""
    r = residuals(graph, poses)
    rho0, _, _ = robust.rho(kernel, (graph.comp_weight() * r * r).sum(-1), delta)
    return 0.5 * torch.where(graph.valid, rho0, 0.0).sum()


def _terms(graph: PoseGraph, poses: torch.Tensor, kernel: str, delta: float):
    r = torch.where(graph.valid[:, None], residuals(graph, poses), 0.0)
    cw = graph.comp_weight()
    _, rho1, _ = robust.rho(kernel, (cw * r * r).sum(-1), delta)
    # Per-component effective information rho1 * diag(cw).
    wv = torch.where(graph.valid[:, None], rho1[:, None] * cw, 0.0)
    # Small-residual GN Jacobians: a left perturbation of T_i maps through
    # the measurement frame; one of T_j enters negated.
    Ji = se3.adjoint(se3.se3_inv(graph.T_meas))
    Jj = -torch.eye(6, dtype=poses.dtype, device=poses.device).expand_as(Ji)
    # Fixed vertices contribute no Jacobian (problem.cpp:297).
    Ji = torch.where(graph.fixed[graph.e_i.long()][:, None, None], 0.0, Ji)
    Jj = torch.where(graph.fixed[graph.e_j.long()][:, None, None], 0.0, Jj)
    return r, Ji, Jj, wv


def _dests(graph: PoseGraph, N: int):
    """Destinations of the 4E block terms in the (N * N) grid, [ii, ij, ji,
    jj] in edge order, and of the 2E gradient terms, [i, j]."""
    i, j = graph.e_i.long(), graph.e_j.long()
    return torch.cat([i * N + i, i * N + j, j * N + i, j * N + j]), torch.cat([i, j])


def build_order(graph: PoseGraph, N: int) -> _Order:
    """The padded tables of `graph`, as wide as its busiest destination (one
    host read)."""
    dH, db = _dests(graph, N)
    widths = torch.stack([torch.bincount(dH, minlength=N * N).amax(), torch.bincount(db, minlength=N).amax()])
    wH, wb = widths.tolist()
    keep = lambda d: torch.ones_like(d, dtype=torch.bool)  # noqa: E731
    return _Order(H=schur._segment_table(dH, keep(dH), N * N, max(wH, 1)),
                  b=schur._segment_table(db, keep(db), N, max(wb, 1)))


def _build(graph: PoseGraph, poses: torch.Tensor, kernel: str, delta: float, order: Optional[_Order] = None):
    """H (6N, 6N) and b (6N,) of the linearized graph: sums in edge order,
    through `order` where given (a card), by `index_add_` otherwise."""
    N = poses.shape[0]
    r, Ji, Jj, wv = _terms(graph, poses, kernel, delta)

    def jtj(Ja, Jb):  # Ja^T diag(wv) Jb per edge
        return torch.einsum("eca,ec,ecb->eab", Ja, wv, Jb).flatten(1)

    H_terms = torch.cat([jtj(Ji, Ji), jtj(Ji, Jj), jtj(Jj, Ji), jtj(Jj, Jj)])     # (4E, 36)
    b_terms = -torch.cat([torch.einsum("eca,ec->ea", Ji, wv * r),
                          torch.einsum("eca,ec->ea", Jj, wv * r)])                 # (2E, 6)
    if order is not None:
        Hg, b = schur._segment_sum(H_terms, order.H), schur._segment_sum(b_terms, order.b)
    else:
        dH, db = _dests(graph, N)
        Hg = H_terms.new_zeros((N * N, 36)).index_add_(0, dH, H_terms)
        b = b_terms.new_zeros((N, 6)).index_add_(0, db, b_terms)
    H = Hg.view(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    return H, b.reshape(-1)


def optimize(poses: torch.Tensor, graph: PoseGraph, kernel: str = robust.HUBER, delta: float = 5.991,
             cfg: lm_ops.LMConfig = lm_ops.LMConfig(iterations=15)) -> Tuple[torch.Tensor, lm_ops.LMResult]:
    """LM over the pose graph; fixed poses stay put (gauge).  On a card the
    sums' tables are built once (one host read), and LM reads the host once
    per attempt (solver/lm.py)."""
    N = poses.shape[0]
    order = build_order(graph, N) if poses.is_cuda else None

    def solve_fn(aux, lam):
        H, b = aux
        diag = torch.diagonal(H)
        damped = diag + lam * diag if cfg.strategy == "strategy1" else diag + lam
        damped = damped + torch.where(diag.abs() <= 1e-12, 1.0, 0.0)
        Hd = H.clone()
        Hd.diagonal().copy_(damped)
        return torch.linalg.solve(Hd, b).reshape(N, 6)

    def retract_fn(P, dx):
        return se3.retract(P, torch.where(graph.fixed[:, None], 0.0, dx))

    def dot_scale(aux, dx, lam):
        H, b = aux
        flat = dx.reshape(-1)
        if cfg.strategy == "strategy1":
            return 0.5 * torch.dot(flat, lam * torch.diagonal(H) * flat + b)
        return 0.5 * torch.dot(flat, lam * flat + b)

    fns = lm_ops.LMFunctions(
        chi_build=lambda P: (graph_chi(P, graph, kernel, delta), _build(graph, P, kernel, delta, order)),
        solve=solve_fn, retract=retract_fn, dot_scale=dot_scale,
        max_diag=lambda aux: torch.diagonal(aux[0]).abs().max(),
    )
    res = lm_ops.lm_optimize(fns, poses, cfg)
    return res.state, res
