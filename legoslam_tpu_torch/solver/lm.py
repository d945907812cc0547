"""Levenberg-Marquardt driver and the motion-only pose solve (twin of
legoslam_tpu/solver/lm.py: `LMConfig`, `lm_optimize`, `solve_pose`,
`pose_edge_chi2`, `estimate_pose`; window BA is not ported yet).

`lego::Problem::solve` (problem.cpp:156-230): lambda from the Hessian
diagonal, the Nielsen or "strategy1" schedule, the inner try-lambda loop
with rollback (false-count threshold 10) and the chi-difference stop.  The
reference expresses the loop as a `lax.while_loop`; here it is a Python loop
over tensors, one lambda attempt per pass, with the same accept rule:
rho > 0, predicted decrease > 0 and a finite candidate chi (lm.py:142).

This is the plain PyTorch pose path.  On CUDA tensors the pipeline runs the
whole `estimate_pose` as one kernel (csrc/pose.cu via kernels/pose.py).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import reprojection, robust


class LMConfig(NamedTuple):
    iterations: int = 10
    strategy: str = "default"        # "default" (Nielsen) | "strategy1"
    tau: float = 1e-5                # problem.cpp:495
    diff_chi_threshold: float = 1e-5  # problem.h:165
    false_cnt_threshold: int = 10    # problem.cpp:178
    init_lambda: float = -1.0        # <0: compute from Hessian diagonal
    max_diag_cap: float = 5e10       # problem.cpp:494


class LMFunctions(NamedTuple):
    """Problem callbacks: build(state) -> aux, chi(state) -> scalar
    0.5*robust-chi2, solve(aux, lam) -> dx, retract(state, dx) -> state,
    dot_scale(aux, dx, lam) -> denominator of rho, max_diag(aux) -> max |H_ii|."""

    build: Callable[[Any], Any]
    chi: Callable[[Any], torch.Tensor]
    solve: Callable[[Any, torch.Tensor], Any]
    retract: Callable[[Any, Any], Any]
    dot_scale: Callable[[Any, Any, torch.Tensor], torch.Tensor]
    max_diag: Callable[[Any], torch.Tensor]


class LMResult(NamedTuple):
    state: Any
    chi: torch.Tensor
    lam: torch.Tensor
    iterations: int
    attempts: int


def lm_optimize(fns: LMFunctions, state0: torch.Tensor, cfg: LMConfig) -> LMResult:
    dtype, device = state0.dtype, state0.device

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    aux = fns.build(state0)
    chi = fns.chi(state0)
    if cfg.strategy == "strategy1":
        lam = scalar(1e-5)  # problem.cpp:500-503
    elif cfg.init_lambda >= 0:
        lam = scalar(cfg.init_lambda)
    else:
        lam = cfg.tau * torch.clamp(fns.max_diag(aux), max=cfg.max_diag_cap)
    state = state0
    last_chi = scalar(1e20)
    ni = scalar(2.0)
    it = false_cnt = attempts = 0
    stop = False

    while not stop and it < cfg.iterations:
        dx = fns.solve(aux, lam)
        cand = fns.retract(state, dx)
        temp_chi = fns.chi(cand)
        scale = fns.dot_scale(aux, dx, lam) + 1e-10
        rho_val = (chi - temp_chi) / scale
        # scale > 0 rejects the junk steps an f32 solve of an ill-conditioned
        # system can produce at small lambda (the reference's lm.py:132-142).
        accept = bool((rho_val > 0) & (scale > 0) & torch.isfinite(temp_chi))
        if cfg.strategy == "strategy1":
            lam = torch.clamp(lam / 9.0, min=1e-7) if accept else torch.clamp(lam * 11.0, max=1e7)
        elif accept:
            alpha = torch.clamp(1.0 - (2.0 * rho_val - 1.0) ** 3, max=2.0 / 3.0)
            lam = lam * torch.clamp(alpha, min=1.0 / 3.0)
            ni = scalar(2.0)
        else:
            lam = lam * ni
            ni = ni * 2.0
        if accept:
            # Accepted steps re-linearize; rejected ones keep the blocks.
            state, aux, chi = cand, fns.build(cand), temp_chi
        false_n = 0 if accept else false_cnt + 1
        outer_done = accept or false_n >= cfg.false_cnt_threshold
        attempts += 1
        if outer_done:
            it += 1
            stop = bool(last_chi - chi < cfg.diff_chi_threshold)
            last_chi = chi
            false_cnt = 0
        else:
            false_cnt = false_n
    return LMResult(state=state, chi=chi, lam=lam, iterations=it, attempts=attempts)


def solve_pose(
    intr: reprojection.Intrinsics,
    T_init: torch.Tensor,
    p_world: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    *,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
    cfg: LMConfig = LMConfig(),
) -> Tuple[torch.Tensor, LMResult]:
    """Motion-only BA over `EdgeProjectionPoseOnly` edges: one
    `problem.solve(10)` round of the frontend (frontend_lego.cpp:157-225)."""

    def terms(T):
        r, Jp = reprojection.pose_only_edge(intr, T, p_world, uv)
        return torch.where(valid[:, None], r, 0.0), Jp

    def build(T):
        r, Jp = terms(T)
        drho, W = robust.robust_information(kernel, r, delta)
        W = torch.where(valid[:, None, None], W, 0.0)
        drho = torch.where(valid, drho, 0.0)
        JpW = torch.einsum("eia,eij->eaj", Jp, W)
        H = torch.einsum("eaj,ejb->ab", JpW, Jp)
        b = -torch.einsum("e,eia,ei->a", drho, Jp, r)
        return H, b

    def chi_fn(T):
        r, _ = terms(T)
        chis = robust.robust_chi2(kernel, r, delta)
        return 0.5 * torch.sum(torch.where(valid, chis, 0.0))

    def solve_fn(aux, lam):
        H, b = aux
        diag = torch.diagonal(H)
        damped = diag + lam * diag if cfg.strategy == "strategy1" else diag + lam
        damped = damped + torch.where(diag.abs() <= 1e-12, 1.0, 0.0)
        Hd = H.clone()
        Hd.diagonal().copy_(damped)
        return torch.linalg.solve(Hd, b)

    def dot_scale(aux, dx, lam):
        H, b = aux
        if cfg.strategy == "strategy1":
            return 0.5 * torch.dot(dx, lam * torch.diagonal(H) * dx + b)
        return 0.5 * torch.dot(dx, lam * dx + b)

    def max_diag(aux):
        return torch.diagonal(aux[0]).abs().max()

    fns = LMFunctions(build=build, chi=chi_fn, solve=solve_fn, retract=se3.retract,
                      dot_scale=dot_scale, max_diag=max_diag)
    res = lm_optimize(fns, T_init, cfg)
    return res.state, res


def pose_edge_chi2(intr, T, p_world, uv, kernel: str, delta: float) -> torch.Tensor:
    """Per-edge robust chi2 for outlier classification (frontend_lego.cpp:214-223)."""
    r, _ = reprojection.pose_only_edge(intr, T, p_world, uv)
    return robust.robust_chi2(kernel, r, delta)


def estimate_pose(
    intr: reprojection.Intrinsics,
    T_init: torch.Tensor,
    p_world: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    *,
    chi2_th: float = 5.991,
    outer_iterations: int = 4,
    drop_kernel_after: int = 2,
    exclude_outliers: bool = True,
    cfg: LMConfig = LMConfig(),
    attempts: Optional[torch.Tensor] = None,
):
    """`Frontend::EstimateCurrentPose` (frontend_g2o.cpp:157-245): rounds of
    {reset to the prior, one LM solve, reclassify outliers by robust chi2 >
    chi2_th}; Huber is dropped after round `drop_kernel_after`.  If given,
    `attempts` ((outer_iterations,) int) gets each round's LM attempts.

    Returns (T, inlier_mask (E,), num_inliers () int32)."""
    outlier = torch.zeros_like(valid)
    T = T_init
    for it in range(outer_iterations):
        kernel = robust.HUBER if it <= drop_kernel_after else robust.TRIVIAL
        use = valid & ~outlier if exclude_outliers else valid
        T, res = solve_pose(intr, T_init, p_world, uv, use, kernel=kernel, delta=chi2_th, cfg=cfg)
        if attempts is not None:
            attempts[it] = res.attempts
        outlier = pose_edge_chi2(intr, T, p_world, uv, kernel, chi2_th) > chi2_th
    inlier = valid & ~outlier
    return T, inlier, inlier.sum(dtype=torch.int32)
