"""Levenberg-Marquardt driver, window BA and the motion-only pose solve
(twin of legoslam_tpu/solver/lm.py: `LMConfig`, `lm_optimize`, `BAState`,
`solve_ba`, `solve_pose`, `pose_edge_chi2`, `estimate_pose`).

`lego::Problem::solve` (problem.cpp:156-230): lambda from the Hessian
diagonal, the Nielsen or "strategy1" schedule, the inner try-lambda loop
with rollback (false-count threshold 10) and the chi-difference stop.  The
reference expresses the loop as a `lax.while_loop`; here it is one Python
loop over tensors (`lm_run`), one lambda attempt per pass, with the same
accept rule: rho > 0, predicted decrease > 0 and a finite candidate chi
(lm.py:142).  Every solve takes the accept decision on the device
(`lm_select`: both branches of the rule computed, one kept by
`torch.where`) and reads two flags in one transfer per attempt: whether it
was accepted, and whether it meets the stop rule if it ends an iteration.
Only window BA on a card replays that attempt as a CUDA graph
(solver/ba_graph.py); everywhere else it runs op by op (`lm_optimize`).

The pose path here is the plain PyTorch version; on CUDA tensors the
pipeline runs the whole `estimate_pose` as one kernel (csrc/pose.cu via
kernels/pose.py), which computes the same bits.  So the plain pose is
written in an order a kernel repeats, from single elementwise ops that
round alike on a CPU and a card: per-edge terms as the reference's, the
edge sums in the reference's order (`rounding.pose_sums`), the
damped 6x6 system solved by an explicit LU (`lu_solve`; the reference's
`jnp.linalg.solve`, LAPACK's LU, is reproduced by no explicit elimination
order bit for bit, but the unblocked LU comes closer than a Cholesky and
alone keeps the rank-deficient case of tests/test_torch_pose.py where
the reference ends: `python -m tests.ba_parity_report --probe-rounding`).  Window
BA runs as PyTorch ops on whatever device its tensors are on
(solver/schur.py), on a card captured once and replayed.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.ops import rounding
from legoslam_tpu_torch.ops.rounding import div_const, row_sum
from legoslam_tpu_torch.solver import reprojection, robust, schur
from legoslam_tpu_torch.utils import timer


class LMConfig(NamedTuple):
    iterations: int = 10
    strategy: str = "default"        # "default" (Nielsen) | "strategy1"
    tau: float = 1e-5                # problem.cpp:495
    diff_chi_threshold: float = 1e-5  # problem.h:165
    false_cnt_threshold: int = 10    # problem.cpp:178
    init_lambda: float = -1.0        # <0: compute from Hessian diagonal
    max_diag_cap: float = 5e10       # problem.cpp:494
    linear_solver: str = "cholesky"  # "cholesky" | "pcg" (problem.cpp:377-422)
    trace: bool = False              # record per-iteration (chi, lambda), the
                                     # reference's solve printout (problem.cpp:180-184)
    # "f32" | "bf16": precision of window BA's cross terms
    # (`schur.build_blocks`' `assembly_precision`); any other value is f32.
    # Only the model Hessian changes: chi and the accept/rollback loop stay f32.
    assembly_precision: str = "f32"


class LMFunctions(NamedTuple):
    """Problem callbacks: chi_build(state) -> (chi, aux), a state's
    0.5*robust-chi2 and its assembly in one sweep (the reference's fused
    path, lm.py:64-71), solve(aux, lam) -> dx, retract(state, dx) -> state,
    dot_scale(aux, dx, lam) -> denominator of rho, max_diag(aux) -> max |H_ii|."""

    chi_build: Callable[[Any], Tuple[torch.Tensor, Any]]
    solve: Callable[[Any, torch.Tensor], Any]
    retract: Callable[[Any, Any], Any]
    dot_scale: Callable[[Any, Any, torch.Tensor], torch.Tensor]
    max_diag: Callable[[Any], torch.Tensor]


class LMResult(NamedTuple):
    state: Any
    chi: torch.Tensor
    lam: torch.Tensor
    iterations: int
    attempts: int          # lambda attempts, one device read each
    trace: torch.Tensor    # (iterations, 2) [chi, lambda] per outer iteration if cfg.trace, else (0, 2)


def _first_lambda(fns: LMFunctions, aux, cfg: LMConfig, scalar) -> torch.Tensor:
    if cfg.strategy == "strategy1":
        return scalar(1e-5)  # problem.cpp:500-503
    if cfg.init_lambda >= 0:
        return scalar(cfg.init_lambda)
    return cfg.tau * torch.clamp(fns.max_diag(aux), max=cfg.max_diag_cap)


def _verdict(fns: LMFunctions, cfg: LMConfig, aux, dx, lam, chi, temp_chi, last_chi):
    """(accept, stop, rho) of an attempt, on the device."""
    scale = fns.dot_scale(aux, dx, lam) + 1e-10
    rho_val = (chi - temp_chi) / scale
    # scale > 0 rejects the junk steps an f32 solve of an ill-conditioned
    # system can produce at small lambda (the reference's lm.py:132-142).
    accept_t = (rho_val > 0) & (scale > 0) & torch.isfinite(temp_chi)
    # The stop rule on the chi this attempt leaves (problem.cpp:210-218),
    # read with the accept flag: one device read per attempt.
    stop_t = last_chi - torch.where(accept_t, temp_chi, chi) < cfg.diff_chi_threshold
    return accept_t, stop_t, rho_val


def _lam_accepted(lam, rho_val, cfg: LMConfig) -> torch.Tensor:
    if cfg.strategy == "strategy1":
        return torch.clamp(div_const(lam, 9.0), min=1e-7)
    u = 2.0 * rho_val - 1.0
    alpha = torch.clamp(1.0 - u * u * u, max=2.0 / 3.0)
    return lam * torch.clamp(alpha, min=1.0 / 3.0)


def _lam_rejected(lam, ni, cfg: LMConfig) -> torch.Tensor:
    # Nielsen's nu (`ni`) doubles with each rejection; strategy1 reads none.
    return torch.clamp(lam * 11.0, max=1e7) if cfg.strategy == "strategy1" else lam * ni


class LMCarry(NamedTuple):
    """What an LM attempt hands the next, all on the device: the state with
    its chi and assembly, lambda and Nielsen's nu, the chi the last outer
    iteration ended on, and the lambda the attempt was taken at."""

    state: Any
    chi: torch.Tensor
    aux: Any
    lam: torch.Tensor
    ni: torch.Tensor
    last_chi: torch.Tensor
    lam_used: torch.Tensor


def _where(cond: torch.Tensor, a, b):
    """`torch.where(cond, a, b)` leaf by leaf over two like nests of tensors."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return torch.where(cond, a, b)
    kept = [_where(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*kept) if hasattr(a, "_fields") else tuple(kept)


def lm_begin(fns: LMFunctions, state0: Any, cfg: LMConfig) -> LMCarry:
    """The first carry: the first fused assembly and lambda."""
    chi, aux = fns.chi_build(state0)

    def scalar(x):  # a fill, not a copy from the host, which would wait for the device
        return torch.full((), x, dtype=chi.dtype, device=chi.device)

    lam = _first_lambda(fns, aux, cfg, scalar)
    return LMCarry(state=state0, chi=chi, aux=aux, lam=lam, ni=scalar(2.0), last_chi=scalar(1e20), lam_used=lam)


def lm_select(fns: LMFunctions, c: LMCarry, cfg: LMConfig) -> Tuple[LMCarry, torch.Tensor]:
    """One LM attempt with its accept decision taken on the device: both
    branches of the rule are computed and `torch.where` keeps the chosen
    one, so the attempt reads nothing.  Accepted steps keep the candidate's
    assembly (they re-linearize); rejected ones keep the blocks.  Returns
    the next carry (its `last_chi` the given one: `lm_run` moves it when an
    outer iteration ends) and the flags [accept, stop] for the host."""
    with timer.span("lm_step"):
        dx = fns.solve(c.aux, c.lam)
        cand = fns.retract(c.state, dx)
    with timer.span("lm_assemble"):
        temp_chi, aux_cand = fns.chi_build(cand)
    accept_t, stop_t, rho_val = _verdict(fns, cfg, c.aux, dx, c.lam, c.chi, temp_chi, c.last_chi)
    lam = torch.where(accept_t, _lam_accepted(c.lam, rho_val, cfg), _lam_rejected(c.lam, c.ni, cfg))
    ni = torch.where(accept_t, 2.0, c.ni * 2.0)
    nxt = LMCarry(state=_where(accept_t, cand, c.state), chi=torch.where(accept_t, temp_chi, c.chi),
                  aux=_where(accept_t, aux_cand, c.aux), lam=lam, ni=ni, last_chi=c.last_chi, lam_used=c.lam)
    return nxt, torch.stack([accept_t, stop_t])


def lm_run(begin: Callable[[], LMCarry], attempt: Callable[[LMCarry], Tuple[LMCarry, torch.Tensor]],
           cfg: LMConfig, graph: int) -> LMResult:
    """The LM loop over a carry the device keeps: `begin()` gives the first
    carry and `attempt(c)` the next and its flags (`lm_begin` and
    `lm_select`, or replays of them, solver/ba_graph.py), one read of the
    flags an attempt.  The host counts outer iterations and rejections in a
    row from the flags and stops on the stop rule.  `graph` marks the
    `lm_attempt` spans: 1 where an attempt is a replay, 0 where it runs op
    by op."""
    with timer.span("lm_assemble"):
        c = begin()
    it = false_cnt = attempts = 0
    stop = False
    trace = torch.full((cfg.iterations if cfg.trace else 0, 2), torch.nan, dtype=c.chi.dtype, device=c.chi.device)
    while not stop and it < cfg.iterations:
        with timer.span("lm_attempt", attempt=attempts, graph=graph):
            c, flags = attempt(c)
            accept, stop_if_done = timer.read(flags, "lm_accept")
        attempts += 1
        false_cnt = 0 if accept else false_cnt + 1
        if accept or false_cnt >= cfg.false_cnt_threshold:  # the outer iteration ends
            it, stop, false_cnt = it + 1, stop_if_done, 0
            if cfg.trace:
                trace[it - 1] = torch.stack([c.chi, c.lam_used])
            c.last_chi.copy_(c.chi)
    return LMResult(state=c.state, chi=c.chi, lam=c.lam, iterations=it, attempts=attempts, trace=trace)


def lm_optimize(fns: LMFunctions, state0: Any, cfg: LMConfig) -> LMResult:
    """LM from `state0`, each attempt `lm_select` run op by op."""
    return lm_run(lambda: lm_begin(fns, state0, cfg), lambda c: lm_select(fns, c, cfg), cfg, graph=0)


# ---------------------------------------------------------------------------
# Full bundle adjustment (pose + landmark), the reference's backend problem
# ---------------------------------------------------------------------------

class BAState(NamedTuple):
    poses: torch.Tensor   # (K, 4, 4)
    points: torch.Tensor  # (L, 3)


def ba_prior(pose_prior):
    """A pose prior (sqrt_J, err0, T_lin) as `ba_functions` reads it:
    (sqrt_J, err0, sqrt_J^T sqrt_J, T_lin^-1)."""
    prior_J, prior_err0, prior_T = pose_prior
    return prior_J, prior_err0, prior_J.T @ prior_J, se3.se3_inv(prior_T)


def ba_functions(graph: schur.BAGraph, order: Optional[schur.BAOrder], prior, kernel: str, delta: float,
                 cfg: LMConfig) -> LMFunctions:
    """`solve_ba`'s problem callbacks over `graph`, its sums in `order`'s
    fixed order (or by `index_add_` where None, on a CPU) and the prior as
    `ba_prior` gives it (or None), assembled at `cfg.assembly_precision`."""

    def chi_build(st: BAState):
        blocks, chi = schur.build_blocks(graph, st.poses, st.points, kernel, delta, with_chi=True, order=order,
                                         assembly_precision=cfg.assembly_precision)
        bprior = None
        if prior is not None:
            prior_J, prior_err0, _, T_lin_inv = prior
            # dx is the manifold offset from the linearization poses, in
            # retract's exp(dx) T convention.
            r = prior_err0 + prior_J @ se3.se3_log(st.poses @ T_lin_inv).reshape(-1)
            chi = chi + 0.5 * torch.dot(r, r)
            bprior = -(prior_J.T @ r)
        return chi, (blocks, schur.blocks_diag(blocks), bprior)

    def solve_fn(aux, lam):
        blocks, _, bprior = aux
        S, bs, Hll_inv = schur.schur_reduce(blocks, graph.point_valid, lam, cfg.strategy)
        if bprior is not None:
            S = S + prior[2]
            bs = bs + bprior
        dx_p = schur.damp_and_solve(S, bs, lam, cfg.strategy, method=cfg.linear_solver)
        return dx_p.reshape(-1, 6), schur.back_substitute(blocks, Hll_inv, dx_p)

    def retract_fn(st: BAState, dx):
        dx_p, dx_l = dx
        # VertexXYZ::add's NaN/Inf guard (lego_types.h:105-112)
        finite = torch.isfinite(dx_l).all(-1, keepdim=True)
        points_n = st.points + torch.where(finite & graph.point_valid[:, None], dx_l, 0.0)
        return BAState(poses=se3.retract(st.poses, dx_p), points=points_n)

    def dot_scale(aux, dx, lam):
        # 0.5 dx^T (lam * dx + b) over [pose; landmark] (problem.cpp:535);
        # strategy1 uses lam * diag(H) * dx (:564).
        blocks, diag, bprior = aux
        flat = torch.cat([dx[0].reshape(-1), dx[1].reshape(-1)])
        bp = blocks.bp.reshape(-1)
        if bprior is not None:
            bp = bp + bprior
        b = torch.cat([bp, blocks.bl.reshape(-1)])
        if cfg.strategy == "strategy1":
            return 0.5 * torch.dot(flat, lam * diag * flat + b)
        return 0.5 * torch.dot(flat, lam * flat + b)

    def max_diag(aux):
        return aux[1].abs().max()

    return LMFunctions(chi_build=chi_build, solve=solve_fn, retract=retract_fn, dot_scale=dot_scale,
                       max_diag=max_diag)


def solve_ba(
    graph: schur.BAGraph,
    poses: torch.Tensor,
    points: torch.Tensor,
    *,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
    cfg: LMConfig = LMConfig(),
    engine: str = "soa",
    pose_prior=None,
    order: schur.BAOrder = None,
) -> Tuple[BAState, LMResult]:
    """Sliding-window BA, `Backend::Optimize`'s `problem.solve(10)`
    (backend_lego.cpp:161) over the active window, on the one engine of
    solver/schur.py ("soa" and "blocks" both select it).  Each attempt is
    one fused edge sweep: the candidate's chi and its assembly together,
    summed in the graph's fixed order: `order`, or on a card
    `schur.build_order`'s tables made once for the solve with one host read.

    On a card each attempt is a replay of a CUDA graph captured once per
    shape (solver/ba_graph.py), with the same bits; on a CPU, with
    `linear_solver: pcg` (which reads the host every CG iteration), and
    for a signature whose capture raised, the same loop runs its attempts
    op by op (`lm_optimize`).

    pose_prior: optional (sqrt_J (6K, 6K), err0 (6K,), T_lin (K, 4, 4)), a
    linearized marginalization prior on the poses (problem.cpp:338-355) with
    residual r_p(x) = err0 + sqrt_J log(T T_lin^-1).  0.5 r_p.r_p joins chi,
    J^T J the reduced pose system and -J^T r_p its right-hand side,
    recomputed at every linearization (the running update of
    problem.cpp:447-453, exactly).  It adds no host read.

    `cfg.assembly_precision` reaches the assembly only under engine "soa",
    as in the reference, whose "blocks" engine never reads it (lm.py:242-252)."""
    schur.check_engine(engine)
    if engine != "soa":
        cfg = cfg._replace(assembly_precision="f32")
    if order is None:
        order = schur.order_for(graph, poses.shape[0], points.shape[0])
    if poses.is_cuda and cfg.linear_solver != "pcg":
        from legoslam_tpu_torch.solver import ba_graph

        solved = ba_graph.solve(graph, poses, points, order, pose_prior, kernel, delta, cfg)
        if solved is not None:
            return solved
    prior = ba_prior(pose_prior) if pose_prior is not None else None
    res = lm_optimize(ba_functions(graph, order, prior, kernel, delta, cfg), BAState(poses=poses, points=points), cfg)
    return res.state, res


# ---------------------------------------------------------------------------
# Motion-only pose solve (single pose, landmarks fixed), the frontend problem
# ---------------------------------------------------------------------------

def _edge_rho(intr, T, p_world, uv, kernel: str, delta: float):
    """Per edge: residual (ru, rv), 2x6 Jacobian rows (Ju, Jv), e2 and
    (rho0, rho1, rho2), each from single elementwise ops."""
    r, Jp = reprojection.pose_only_edge(intr, T, p_world, uv)
    ru, rv = r[:, 0], r[:, 1]
    e2 = ru * ru + rv * rv
    return ru, rv, Jp[:, 0], Jp[:, 1], robust.rho(kernel, e2, delta), e2


def pose_pass(intr, T, p_world, uv, use, kernel: str, delta: float):
    """One pass over the edges in use at pose T: (H (6, 6), b (6,), chi ()),
    H = sum J^T W J, b = -sum rho' J^T r, chi = 0.5 sum rho, as the
    reference's `solve_pose` build / chi_fn compute them: per edge W = rho'
    I + 2 rho'' r r^T (the rank-1 term dropped unless rho' + 2 rho'' e2 >
    1e-5 rho', base_edge.cpp:55's guard), the rows of J^T W as (J_0 W_0j +
    J_1 W_1j), then the sums in `rounding.pose_sums`' order (H is not
    symmetric bit for bit, as the reference's is not).  The sums run on the
    host: on a card this pass copies its per-edge terms there and the sums
    back, one read a pass (the card's pipeline runs csrc/pose.cu instead)."""
    ru, rv, Ju, Jv, (rho0, rho1, rho2), e2 = _edge_rho(intr, T, p_world, uv, kernel, delta)
    keep = rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1
    two_r2 = torch.where(keep, 2.0 * rho2, 0.0)
    W00 = (rho1 + two_r2 * ru * ru)[:, None]
    W01 = (two_r2 * ru * rv)[:, None]
    W10 = (two_r2 * rv * ru)[:, None]
    W11 = (rho1 + two_r2 * rv * rv)[:, None]
    jw = torch.stack([Ju * W00 + Jv * W10, Ju * W01 + Jv * W11], dim=1)
    J = torch.stack([Ju, Jv], dim=1)
    t = torch.stack([rho1 * ru, rho1 * rv], dim=1)
    use2 = use[:, None]
    terms = (torch.where(use2[..., None], jw, 0.0), torch.where(use2[..., None], J, 0.0), torch.where(use2, t, 0.0),
             torch.where(use, rho0, 0.0))
    H, b, chi = (x.to(T.device) for x in rounding.pose_sums(*(x.cpu() for x in terms)))
    return H, -b, 0.5 * chi


def lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (n x n, small) by LU with partial pivoting in LAPACK's
    unblocked order (sgetf2, then sgetrs' two triangular solves), unfused,
    as csrc/pose.cu does: per column the first row of largest magnitude
    pivots, the column below is scaled by the pivot's reciprocal, and each
    element below and right subtracts its product; the unit lower solve
    subtracts in increasing column order, the upper one in decreasing
    order, dividing by the pivot.  Row swaps are selected on the device (no
    read)."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        p = j + torch.argmax(A[j:, j].abs())
        swap = torch.where(idx == j, p, torch.where(idx == p, j, idx))
        A, b = A[swap], b[swap]
        col = A[j + 1:, j] * (1.0 / A[j, j])
        A = torch.cat([A[:j + 1], torch.cat([A[j + 1:, :j], col[:, None],
                                             A[j + 1:, j + 1:] - col[:, None] * A[j, None, j + 1:]], dim=1)])
    for q in range(n - 1):
        b = torch.cat([b[:q + 1], b[q + 1:] - A[q + 1:, q] * b[q]])
    for q in range(n - 1, -1, -1):
        xq = b[q] / A[q, q]
        b = torch.cat([b[:q] - A[:q, q] * xq, xq[None], b[q + 1:]])
    return b


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
    `problem.solve(10)` round of the frontend (frontend_lego.cpp:157-225).
    Each attempt is one pass (`pose_pass`): the candidate's chi and its
    normal equations, kept if the step is accepted."""

    def chi_build(T):
        H, b, chi = pose_pass(intr, T, p_world, uv, valid, kernel, delta)
        return chi, (H, b)

    def solve_fn(aux, lam):
        H, b = aux
        diag = torch.diagonal(H)
        damped = diag + lam * diag if cfg.strategy == "strategy1" else diag + lam
        damped = damped + torch.where(diag.abs() <= 1e-12, 1.0, 0.0)
        Hd = H.clone()
        Hd.diagonal().copy_(damped)
        return lu_solve(Hd, b)

    def dot_scale(aux, dx, lam):
        H, b = aux
        if cfg.strategy == "strategy1":
            return 0.5 * row_sum(dx * (lam * torch.diagonal(H) * dx + b))
        return 0.5 * row_sum(dx * (lam * dx + b))

    def max_diag(aux):
        return torch.diagonal(aux[0]).abs().max()

    fns = LMFunctions(chi_build=chi_build, solve=solve_fn, retract=se3.retract, dot_scale=dot_scale,
                      max_diag=max_diag)
    res = lm_optimize(fns, T_init, cfg)
    return res.state, res


def pose_edge_chi2(intr, T, p_world, uv, kernel: str, delta: float) -> torch.Tensor:
    """Per-edge robust chi2 for outlier classification (frontend_lego.cpp:214-223)."""
    return _edge_rho(intr, T, p_world, uv, kernel, delta)[4][0]
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
    verification: bool = False,
):
    """`Frontend::EstimateCurrentPose` (frontend_g2o.cpp:157-245): rounds of
    {reset to the prior, one LM solve, reclassify outliers by robust chi2 >
    chi2_th}; Huber is dropped after round `drop_kernel_after`.  With
    `verification`, the loop closer's rounds (pipeline/loop_closure.py
    `_verify_device`): each starts from the last round's pose, and an edge
    stays where its raw chi2 is <= chi2_th.  If given, `attempts`
    ((outer_iterations,) int) gets each round's LM attempts.

    Returns (T, inlier_mask (E,), num_inliers () int32)."""
    outlier = torch.zeros_like(valid)
    T = T_init
    for it in range(outer_iterations):
        kernel = robust.HUBER if it <= drop_kernel_after else robust.TRIVIAL
        use = valid & ~outlier if exclude_outliers else valid
        T, res = solve_pose(intr, T if verification else T_init, p_world, uv, use, kernel=kernel, delta=chi2_th,
                            cfg=cfg)
        if attempts is not None:
            attempts[it] = res.attempts
        if verification:
            outlier = ~(_edge_rho(intr, T, p_world, uv, kernel, chi2_th)[5] <= chi2_th)
        else:
            outlier = pose_edge_chi2(intr, T, p_world, uv, kernel, chi2_th) > chi2_th
    inlier = valid & ~outlier
    return T, inlier, inlier.sum(dtype=torch.int32)
