"""The bundle-adjustment engine: edge sweep, block assembly and the Schur
solve (twin of legoslam_tpu/solver/schur.py and solver/edge_soa.py, merged).

The reference keeps two engines that tests/test_edge_soa.py pins as equal:
the block pipeline of `schur.py` and the component-major `edge_soa.py`,
whose layout exists only for the TPU's registers and matrix unit (one-hot
contractions in place of gathers and segment sums, edge_soa.py:7-18).  Here
there is one engine: gathers per edge, the reference's default (`edge_soa`)
edge math, and `index_add_` over the pose and landmark indices.  Config
`lm_engine` "soa" and "blocks" both select it (`check_engine`); any other
value raises ValueError.  There is no bfloat16 assembly: the blocks are
assembled in float32, as the reference's `ba_assembly_precision: f32` does.

Re-designs `lego::Problem`'s dense pipeline (src/lego/base/problem.cpp):
`buildHessian` (:273-358) and `solveLinearEquation`'s Schur elimination of
the landmark blocks (:362-431), with the landmark diagonal damped as the
reference's default g2o binary does (`damp_landmark_diag`).

Shapes: K poses (6 DoF), L landmarks (3 DoF), E edges, each joining one
pose and one landmark through one of C camera extrinsics.  The cross blocks
stay dense at (K, L, 6, 3): 2.4 MB at K=16, L=2048.

`index_add_` on a CUDA tensor sums duplicate indices in no fixed order, so
the blocks may differ from run to run at float rounding level.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import reprojection, robust

ENGINES = ("soa", "blocks")


class BAGraph(NamedTuple):
    """Static-shape bundle-adjustment graph (constant during one solve).

    Masks express what the reference expresses by object presence:
    `e_valid` (edge exists), `point_valid` (landmark slot occupied),
    `pose_fixed` (`BaseVertex::setFixed`)."""

    e_pose: torch.Tensor    # (E,) int32 pose index per edge
    e_point: torch.Tensor   # (E,) int32 landmark index per edge
    e_cam: torch.Tensor     # (E,) int32 extrinsic index per edge
    e_uv: torch.Tensor      # (E, 2) pixel measurement
    e_valid: torch.Tensor   # (E,) bool
    exts: torch.Tensor      # (C, 4, 4) camera-from-rig extrinsics
    intr: reprojection.Intrinsics
    pose_fixed: torch.Tensor   # (K,) bool
    point_valid: torch.Tensor  # (L,) bool


class BABlocks(NamedTuple):
    """Assembled normal equations in block form."""

    Hpp: torch.Tensor   # (K, 6, 6) pose diagonal blocks
    Hll: torch.Tensor   # (L, 3, 3) landmark diagonal blocks
    Hpl: torch.Tensor   # (K, L, 6, 3) cross blocks
    bp: torch.Tensor    # (K, 6)
    bl: torch.Tensor    # (L, 3)


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown lm_engine {engine!r}; expected one of {ENGINES}")


def edge_mask(graph: BAGraph) -> torch.Tensor:
    return graph.e_valid & graph.point_valid[graph.e_point]


def _finite(points: torch.Tensor) -> torch.Tensor:
    """Non-finite landmark coordinates as 0, as the reference's assembly sweep
    has them (edge_soa.py:120-123); the outlier sweep takes them raw."""
    return torch.where(torch.isfinite(points), points, 0.0)


def _edge_core(graph: BAGraph, poses: torch.Tensor, points: torch.Tensor, jacobians: bool):
    """`EdgeProjection` (lego_types.h:188-261) for every edge, in the
    reference's default-engine form (edge_soa.py:94-191): p_cam = ext T p_w,
    r = z - (f X zinv + c) with zinv = 1 / (Z + 1e-18), the 2x6 pose
    Jacobian at the post-extrinsic point and J_point = J_pose[:, :3] R_ext R_cw.
    Returns r (E, 2) and, with `jacobians`, J = [J_pose | J_point] (E, 2, 9)."""
    T = poses[graph.e_pose]
    ext = graph.exts[graph.e_cam]
    p_cam = se3.transform(ext, se3.transform(T, points[graph.e_point]))
    zinv = 1.0 / (p_cam[:, 2] + reprojection._EPS)
    intr = graph.intr
    proj = torch.stack([intr.fx * p_cam[:, 0] * zinv + intr.cx, intr.fy * p_cam[:, 1] * zinv + intr.cy], dim=-1)
    r = graph.e_uv - proj
    if not jacobians:
        return r, None
    J_pose = reprojection._pose_jacobian(intr, p_cam)
    J_point = J_pose[:, :, :3] @ (ext[:, :3, :3] @ T[:, :3, :3])
    return r, torch.cat([J_pose, J_point], dim=-1)


def edge_chi2(graph: BAGraph, poses: torch.Tensor, points: torch.Tensor, kernel: str, delta: float) -> torch.Tensor:
    """Per-edge robust chi2 at the raw points, for the outlier classification
    (backend_lego.cpp:170-176; the reference's `soa_edge_chi2` on a graph
    made with `assembly=False`)."""
    r, _ = _edge_core(graph, poses, points, jacobians=False)
    return robust.rho(kernel, (r * r).sum(-1), delta)[0]


def robust_chi(graph: BAGraph, poses: torch.Tensor, points: torch.Tensor, kernel: str, delta: float) -> torch.Tensor:
    """0.5 * sum of robust chi2 over valid edges (problem.cpp:470-479)."""
    chi = edge_chi2(graph, poses, _finite(points), kernel, delta)
    return 0.5 * torch.where(edge_mask(graph), chi, 0.0).sum()


def build_blocks(graph: BAGraph, poses: torch.Tensor, points: torch.Tensor, kernel: str, delta: float,
                 with_chi: bool = False):
    """buildHessian (problem.cpp:273-358): per-edge blocks summed into the
    pose and landmark blocks by `index_add_`, the cross blocks on the flat
    index e_pose * L + e_point.

    Masking as the reference's (edge_soa.py:230-248): residuals of invalid
    edges are zeroed before the robust kernel, the rank-one term of W is
    kept only where the PSD guard holds (base_edge.cpp:55), pose Jacobians
    of fixed poses are zeroed.  `with_chi=True` also returns the robust chi
    at the same point, from the same sweep: (blocks, chi)."""
    K, L = poses.shape[0], points.shape[0]
    r, J = _edge_core(graph, poses, _finite(points), jacobians=True)
    vm = edge_mask(graph)
    r = torch.where(vm[:, None], r, 0.0)
    e2 = (r * r).sum(-1)
    rho0, rho1, rho2 = robust.rho(kernel, e2, delta)
    keep = rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1
    two_r2 = torch.where(keep, 2.0 * rho2, 0.0)
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    W = rho1[:, None, None] * eye2 + two_r2[:, None, None] * (r[:, :, None] * r[:, None, :])
    W = torch.where(vm[:, None, None], W, 0.0)
    drho = torch.where(vm, rho1, 0.0)
    pose_m = vm & ~graph.pose_fixed[graph.e_pose]
    col_m = torch.cat([pose_m[:, None].expand(-1, 6), vm[:, None].expand(-1, 3)], dim=1)
    J = torch.where(col_m[:, None, :], J, 0.0)

    JW = J.transpose(1, 2) @ W                      # (E, 9, 2)
    H_e = JW @ J                                    # (E, 9, 9)
    b_e = -drho[:, None] * (J * r[:, :, None]).sum(1)  # (E, 9): -rho' J^T r (problem.cpp:329)
    e_pose = graph.e_pose.long()
    e_point = graph.e_point.long()
    dt, dev = r.dtype, r.device
    Hpp = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(0, e_pose, H_e[:, :6, :6])
    Hll = torch.zeros((L, 3, 3), dtype=dt, device=dev).index_add_(0, e_point, H_e[:, 6:, 6:])
    Hpl = torch.zeros((K * L, 6, 3), dtype=dt, device=dev).index_add_(0, e_pose * L + e_point, H_e[:, :6, 6:])
    bp = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(0, e_pose, b_e[:, :6])
    bl = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(0, e_point, b_e[:, 6:])
    blocks = BABlocks(Hpp=Hpp, Hll=Hll, Hpl=Hpl.view(K, L, 6, 3), bp=bp, bl=bl)
    if with_chi:
        # Invalid edges have r = 0, so rho0 = 0 there for every kernel.
        return blocks, 0.5 * torch.where(vm, rho0, 0.0).sum()
    return blocks


def blocks_diag(blocks: BABlocks) -> torch.Tensor:
    """[diag(Hpp); diag(Hll)], pose-major then landmark-major."""
    return torch.cat([blocks.Hpp.diagonal(dim1=-2, dim2=-1).reshape(-1),
                      blocks.Hll.diagonal(dim1=-2, dim2=-1).reshape(-1)])


def _inv3x3_masked(A: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse; zero where invalid or near-singular.

    The reference inverts each landmark block (problem.cpp:396-400); a
    zeroed inverse makes an unconstrained landmark contribute nothing and
    receive a zero update, the masked equivalent of the vertex not existing."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    ok = valid & (det.abs() > 1e-20)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    adj = torch.stack([co00, co01, co02, co10, co11, co12, co20, co21, co22], dim=-1)
    return (adj * inv_det[..., None]).reshape(A.shape)


def damp_landmark_diag(diag: torch.Tensor, lam, strategy: str) -> torch.Tensor:
    """LM damping of the landmark diagonal entries, every vertex block
    included as g2o's Levenberg does (the reference's default binary).  The
    vendored LEGO solver leaves the landmark blocks undamped (problem.cpp:
    390-400), which in float32 lets a weakly constrained landmark's
    near-singular 3x3 block wreck the Schur system."""
    if strategy == "strategy1":
        return diag + lam * diag
    return diag + lam


def _flat_cross(Hpl: torch.Tensor) -> torch.Tensor:
    """(K, L, 6, 3) cross blocks as the (6K, 3L) matrix H_pl."""
    K, L = Hpl.shape[:2]
    return Hpl.permute(0, 2, 1, 3).reshape(6 * K, 3 * L)


def schur_reduce(blocks: BABlocks, point_valid: torch.Tensor, lam=0.0, strategy: str = "default"):
    """Eliminate the landmark blocks (problem.cpp:380-404), their diagonal
    damped first (`damp_landmark_diag`).

    Returns (S (6K, 6K) reduced pose system, pose diagonal not yet damped
    (`damp_and_solve`), bs (6K,), Hll_inv (L, 3, 3) of the damped blocks)."""
    K = blocks.Hpp.shape[0]
    Hll_d = blocks.Hll.clone()
    Hll_d.diagonal(dim1=-2, dim2=-1).copy_(
        damp_landmark_diag(blocks.Hll.diagonal(dim1=-2, dim2=-1), lam, strategy))
    Hll_inv = _inv3x3_masked(Hll_d, point_valid)
    T1f = _flat_cross(torch.einsum("klab,lbc->klac", blocks.Hpl, Hll_inv))  # H_pl H_ll^-1
    Hplf = _flat_cross(blocks.Hpl)
    eye = torch.eye(K, dtype=blocks.Hpp.dtype, device=blocks.Hpp.device)
    S = (eye[:, None, :, None] * blocks.Hpp[:, :, None, :]).reshape(6 * K, 6 * K) - T1f @ Hplf.T
    bs = blocks.bp.reshape(-1) - T1f @ blocks.bl.reshape(-1)
    return S, bs, Hll_inv


def back_substitute(blocks: BABlocks, Hll_inv: torch.Tensor, dx_p: torch.Tensor) -> torch.Tensor:
    """delta_landmark = Hll^-1 (bl - Hlp dx_p) (problem.cpp:426-429); (L, 3)."""
    rhs = blocks.bl - (_flat_cross(blocks.Hpl).T @ dx_p.reshape(-1)).reshape(-1, 3)
    return (Hll_inv * rhs[:, None, :]).sum(-1)


def damp_and_solve(S: torch.Tensor, bs: torch.Tensor, lam, strategy: str = "default",
                   method: str = "cholesky") -> torch.Tensor:
    """Damp the reduced system's diagonal and solve it.

    default: S_ii += lambda (problem.cpp:410-412); strategy1: S_ii +=
    lambda * S_ii (:414-417).  method "cholesky" (:420) or "pcg" (:422,
    :584-614).  A unit diagonal goes where the system has no support (fixed
    poses, empty slots), so those unknowns get a zero update.

    Where the damped system is not positive definite the step is all NaN,
    as the reference's `cho_factor` gives, and the LM driver rejects it;
    `cholesky_ex` reports the failure without a host read."""
    diag = S.diagonal()
    damped = diag + lam * diag if strategy == "strategy1" else diag + lam
    damped = damped + torch.where(diag.abs() <= 1e-12, 1.0, 0.0)
    S = S.clone()
    S.diagonal().copy_(damped)
    if method == "pcg":
        from legoslam_tpu_torch.solver import pcg

        return pcg.pcg_solve(S, bs)
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(bs[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.nan)
