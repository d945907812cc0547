"""Distributed window BA over a process group (twin of
legoslam_tpu/parallel/dist_ba.py).

Every process holds the whole BA graph and works on two slices of it:

- **edges** for the assembly: each rank sweeps its edge shard (residuals,
  Jacobians, robust weights) and sums the shard's blocks in edge order
  (`schur.build_blocks`, fixed-order tables on a card), and one
  `all_reduce` of the packed blocks and chi gives every rank the full
  normal equations: the reference C++'s OpenMP `buildHessian`
  (problem.cpp:282-284) across processes;
- **landmarks** for the elimination: each rank takes an L/world slice of
  the landmark blocks, inverts its 3x3 blocks, forms its part of the Schur
  complement (H_pl H_ll^-1 H_lp, the O(K^2 L) term) and back-substitutes
  its landmarks (problem.cpp:390-400, 426-429).  One `all_reduce` of the
  packed (S_off, b_off) and one `all_gather` of the landmark updates are
  the other collectives of an LM attempt.

The (6K)^2 damped pose solve and the LM control flow run replicated:
every rank computes the accept test from the same reduced values, reads
the same flags, and no rank parts from the others.

Usage: `solve_fn = make_dist_solve_fn(mesh)` plugs into
`pipeline.backend.ba_step(..., solve_fn=solve_fn)` (and `VisualOdometry`'s
`ba_solve_fn`); every rank makes the same calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.parallel.mesh import Mesh
from legoslam_tpu_torch.solver import lm as lm_ops
from legoslam_tpu_torch.solver import robust, schur


def _pad_edges(graph: schur.BAGraph, multiple: int) -> schur.BAGraph:
    """Pad the edge arrays to a multiple of `multiple` with invalid edges."""
    pad = (-graph.e_pose.shape[0]) % multiple
    if pad == 0:
        return graph

    def p(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    return graph._replace(e_pose=p(graph.e_pose), e_point=p(graph.e_point), e_cam=p(graph.e_cam),
                          e_uv=p(graph.e_uv), e_valid=p(graph.e_valid))


def _pad_points(graph: schur.BAGraph, points: torch.Tensor, multiple: int
                ) -> Tuple[schur.BAGraph, torch.Tensor, int]:
    """Pad the landmark axis to a multiple of `multiple`; padded slots are
    `point_valid = False`, solved to a zero update like any empty slot."""
    L = points.shape[0]
    pad = (-L) % multiple
    if pad == 0:
        return graph, points, L
    graph = graph._replace(point_valid=torch.cat([graph.point_valid, graph.point_valid.new_zeros(pad)]))
    return graph, torch.cat([points, points.new_zeros((pad, 3))]), L


def _shard(graph: schur.BAGraph, lo: int, hi: int) -> schur.BAGraph:
    return graph._replace(e_pose=graph.e_pose[lo:hi], e_point=graph.e_point[lo:hi], e_cam=graph.e_cam[lo:hi],
                          e_uv=graph.e_uv[lo:hi], e_valid=graph.e_valid[lo:hi])


def make_dist_solve_fn(mesh: Mesh, kernel: str = robust.HUBER, delta: float = 5.991):
    """A drop-in for the single-device LM solve of `backend.ba_step` that
    shards the edge and landmark work over `mesh`."""
    world, rank, group = mesh.world_size, mesh.rank, mesh.group

    def all_reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    def solve_fn(graph: schur.BAGraph, poses: torch.Tensor, points: torch.Tensor, cfg: lm_ops.LMConfig):
        graph = _pad_edges(graph, world)
        graph, points_p, L_orig = _pad_points(graph, points, world)
        K, L = poses.shape[0], points_p.shape[0]
        Es, Ls = graph.e_pose.shape[0] // world, L // world
        lo = rank * Ls
        g_loc = _shard(graph, rank * Es, (rank + 1) * Es)
        order = schur.order_for(g_loc, K, L)  # one host read for the solve, on a card
        pv_loc = graph.point_valid[lo:lo + Ls]
        sizes = (K * 36, L * 9, K * L * 18, K * 6, L * 3, 1)

        def chi_build(st: lm_ops.BAState):
            # The shard's blocks and chi, summed over the ranks in one reduction;
            # float32 whatever cfg.assembly_precision says, as the reference's
            # sharded build (dist_ba.py:130) has them.
            blocks, chi = schur.build_blocks(g_loc, st.poses, st.points, kernel, delta, with_chi=True, order=order)
            flat = all_reduce(torch.cat([blocks.Hpp.reshape(-1), blocks.Hll.reshape(-1), blocks.Hpl.reshape(-1),
                                         blocks.bp.reshape(-1), blocks.bl.reshape(-1), chi.reshape(1)]))
            Hpp, Hll, Hpl, bp, bl, chi = torch.split(flat, sizes)
            blocks = schur.BABlocks(Hpp=Hpp.view(K, 6, 6), Hll=Hll.view(L, 3, 3), Hpl=Hpl.view(K, L, 6, 3),
                                    bp=bp.view(K, 6), bl=bl.view(L, 3))
            return chi[0], (blocks, schur.blocks_diag(blocks))

        def solve_lin(aux, lam):
            blocks, _ = aux
            # This rank's landmark slots [lo, lo + Ls) (problem.cpp:380-404),
            # the landmark diagonal damped before the inversion.
            Hll_d = blocks.Hll[lo:lo + Ls].clone()
            Hll_d.diagonal(dim1=-2, dim2=-1).copy_(
                schur.damp_landmark_diag(Hll_d.diagonal(dim1=-2, dim2=-1), lam, cfg.strategy))
            inv_loc = schur._inv3x3_masked(Hll_d, pv_loc)
            Hpl_loc = blocks.Hpl[:, lo:lo + Ls]
            T1f = schur._flat_cross(torch.einsum("klab,lbc->klac", Hpl_loc, inv_loc))   # (6K, 3Ls)
            Hplf = schur._flat_cross(Hpl_loc)
            bl_loc = blocks.bl[lo:lo + Ls]
            off = all_reduce(torch.cat([(T1f @ Hplf.T).reshape(-1), T1f @ bl_loc.reshape(-1)]))
            S_off, b_off = off[:36 * K * K].view(6 * K, 6 * K), off[36 * K * K:]
            eye = torch.eye(K, dtype=blocks.Hpp.dtype, device=blocks.Hpp.device)
            S = (eye[:, None, :, None] * blocks.Hpp[:, :, None, :]).reshape(6 * K, 6 * K) - S_off
            dx_p = schur.damp_and_solve(S, blocks.bp.reshape(-1) - b_off, lam, cfg.strategy,
                                        method=cfg.linear_solver)
            # This rank's back-substitution (problem.cpp:426-429), gathered.
            rhs_loc = bl_loc - (Hplf.T @ dx_p).reshape(Ls, 3)
            dxl_loc = (inv_loc * rhs_loc[:, None, :]).sum(-1)
            dx_l = dxl_loc.new_empty((L, 3))
            dist.all_gather_into_tensor(dx_l, dxl_loc.contiguous(), group=group)
            return dx_p.reshape(-1, 6), dx_l

        def retract_fn(st: lm_ops.BAState, dx):
            dx_p, dx_l = dx
            finite = torch.isfinite(dx_l).all(-1, keepdim=True)
            points_n = st.points + torch.where(finite & graph.point_valid[:, None], dx_l, 0.0)
            return lm_ops.BAState(poses=se3.retract(st.poses, dx_p), points=points_n)

        def dot_scale(aux, dx, lam):
            blocks, diag = aux
            flat = torch.cat([dx[0].reshape(-1), dx[1].reshape(-1)])
            b = torch.cat([blocks.bp.reshape(-1), blocks.bl.reshape(-1)])
            if cfg.strategy == "strategy1":
                return 0.5 * torch.dot(flat, lam * diag * flat + b)
            return 0.5 * torch.dot(flat, lam * flat + b)

        fns = lm_ops.LMFunctions(chi_build=chi_build, solve=solve_lin, retract=retract_fn, dot_scale=dot_scale,
                                 max_diag=lambda aux: aux[1].abs().max())
        res = lm_ops.lm_optimize(fns, lm_ops.BAState(poses=poses, points=points_p), cfg)
        state = lm_ops.BAState(poses=res.state.poses, points=res.state.points[:L_orig])
        return state, res._replace(state=state)

    return solve_fn
