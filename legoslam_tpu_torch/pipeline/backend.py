"""Backend: sliding-window bundle adjustment over the active map (twin of
legoslam_tpu/pipeline/backend.py).

Re-designs `Backend` (src/backend_lego.cpp): one cycle is the function
`ba_step(map) -> (map', stats)` over the fixed-shape world state.  The graph
is built by one stable sort and gathers, the solve is solver/lm.py's
`solve_ba` (or an injected `solve_fn`, parallel/dist_ba.py), and the
write-back is masked scatters; pipeline/visual_odometry.py decides when
to run it (inline after each keyframe, or on a worker thread through
pipeline/async_backend.py).

Scatters follow the reference's: a write the reference drops (`mode="drop"`)
or routes to a dump row goes to a dump row here too, which is sliced off,
so unordered duplicate writes land only there; `.at[].add` is `index_add_`.
Apart from the LM loop's one read per attempt (solver/lm.py), nothing here
reads from the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.geometry.camera import StereoRig
from legoslam_tpu_torch.pipeline.frontend import FrontendConfig, _intr
from legoslam_tpu_torch.pipeline.state import WorldMap
from legoslam_tpu_torch.solver import lm as lm_ops
from legoslam_tpu_torch.solver import robust, schur
from legoslam_tpu_torch.utils import timer

_HASH = 2654435761          # odd multiplier of the landmark-id hash (mod 2^32)
_INVALID = 0xFFFFFFFF       # sort key of an invalid edge
# Preimage of _INVALID under the hash: 0xFFFFFFFF * 244002641 mod 2^32.
_INVALID_PREIMAGE = 4050964655


class BAConfig(NamedTuple):
    iterations: int = 10          # problem.solve(10), backend_lego.cpp:161
    chi2_threshold: float = 5.991
    max_chi2_doublings: int = 5   # backend_lego.cpp:166
    inlier_ratio: float = 0.5
    strategy: str = "default"
    linear_solver: str = "cholesky"
    engine: str = "soa"           # "soa" | "blocks": the one engine of solver/schur.py
    trace: bool = False           # record the per-iteration chi/lambda solve trace
    # "bf16" rounds window BA's cross terms to bfloat16 before the float32
    # sums (solver/schur.py); chi and the rollback stay f32.  f32 here, bf16
    # in the config's defaults, as the reference has them (ROADMAP C3).
    assembly_precision: str = "f32"


class BAStats(NamedTuple):
    chi: torch.Tensor
    iterations: int
    n_outlier: torch.Tensor
    n_inlier: torch.Tensor
    n_active_landmarks: torch.Tensor
    n_dropped_landmarks: torch.Tensor  # active landmarks and edges beyond capacity (not optimized)
    lam: torch.Tensor                  # final LM damping
    trace: torch.Tensor                # (iterations, 2) [chi, lambda] if traced, else (0, 2)
    attempts: int = 0                  # LM attempts, one device read each


class BAProblem(NamedTuple):
    """A BA problem extracted from the world state."""

    graph: schur.BAGraph
    poses: torch.Tensor       # (KW, 4, 4)
    points: torch.Tensor      # (LA, 3)
    active_ids: torch.Tensor  # (LA,) int32 global landmark ids (-1 = empty slot)
    e_src: torch.Tensor       # (EB,) int64 source index into the (2, KW, NF) observation grid


class BAResult(NamedTuple):
    """One window solve, detached from the world state: the optimized values
    and outlier verdicts, tagged with the snapshot's keyframe and landmark
    ids so that `merge_ba_result` can write them into a map that has moved
    on since (backend_lego.cpp:56-218)."""

    kf_id: torch.Tensor        # (KW,) keyframe id per slot at snapshot (-1 empty)
    kf_frame_id: torch.Tensor  # (KW,) source frame id (guards kf-id reuse after Reset)
    active_ids: torch.Tensor   # (LA,) global landmark ids optimized (-1 empty)
    point_valid: torch.Tensor  # (LA,) landmark slot took part in the solve
    poses: torch.Tensor        # (KW, 4, 4)
    points: torch.Tensor       # (LA, 3)
    out_l: torch.Tensor        # (KW, NF) bool outlier verdicts on the left grid
    out_r: torch.Tensor        # (KW, NF) bool ... and the right grid
    stats: BAStats
    # With use_marg_prior: (S (6KW, 6KW), b (6KW,), poses (KW, 4, 4), kf_id
    # (KW,)), the window's pose information at the optimum, for the next
    # eviction to marginalize.
    info: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None


def build_problem(cfg: FrontendConfig, rig: StereoRig, wmap: WorldMap) -> Tuple[BAProblem, torch.Tensor]:
    """Snapshot the active window into a `schur.BAGraph` (Backend::Optimize,
    backend_lego.cpp:63-158): one pose per window slot, one landmark per
    active landmark, one projection edge per registered observation with
    the left or right extrinsic.  Returns (problem, [n_active, n_dropped]).

    One stable sort of the (2*KW*NF) observation grid by a hashed landmark
    key compacts the valid edges to the front, groups them by landmark (the
    first edge of a group opens an active slot) and gives each edge its slot
    as a running count.  The hash (id * 2654435761 mod 2^32, bijective) makes
    an over-budget window drop landmarks of every age rather than the newest
    ids.  Keys are computed in int64 and masked to 32 bits."""
    caps = cfg.caps
    KW, NF, LA, EB = caps.window, caps.max_features, caps.active_landmarks, caps.ba_edges
    if caps.landmarks >= _INVALID_PREIMAGE:
        raise ValueError(f"landmark capacity {caps.landmarks} collides with the invalid sort key")
    dev = wmap.kf_pose.device
    lm_flat = wmap.kf_lm.reshape(-1)
    base_ok = wmap.kf_valid.repeat_interleave(NF) & (lm_flat >= 0)
    valid_g = torch.cat([base_ok & wmap.kf_obs_left.reshape(-1), base_ok & wmap.kf_obs_right.reshape(-1)])
    lm2 = lm_flat.repeat(2)
    key = torch.where(valid_g, (lm2.long() * _HASH) & 0xFFFFFFFF, _INVALID)
    order = torch.sort(key, stable=True).indices[:EB]
    s = key[order]
    lm_s = lm2[order]
    e_valid = s < _INVALID
    n_edge_drop = torch.clamp(valid_g.sum(dtype=torch.int32) - EB, min=0)

    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), s[1:] != s[:-1]]) & e_valid
    slot = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    overflow = slot >= LA
    e_valid = e_valid & ~overflow
    opens = is_first & ~overflow
    n_active = opens.sum(dtype=torch.int32)
    n_dropped = (is_first & overflow).sum(dtype=torch.int32) + n_edge_drop

    # Row LA is a dump row for every edge that opens no slot.
    tgt = torch.where(opens, slot, LA).long()
    active_ids = torch.full((LA + 1,), -1, dtype=torch.int32, device=dev).index_put_((tgt,), lm_s)[:LA]
    points = wmap.lm_pos[torch.clamp(active_ids, min=0).long()]

    e_pose_g = torch.arange(KW, dtype=torch.int32, device=dev).repeat_interleave(NF).repeat(2)
    e_cam_g = torch.arange(2, dtype=torch.int32, device=dev).repeat_interleave(KW * NF)
    e_uv_g = torch.cat([wmap.kf_uv.reshape(-1, 2), wmap.kf_uv_r.reshape(-1, 2)])
    graph = schur.BAGraph(
        e_pose=e_pose_g[order],
        e_point=torch.clamp(slot, 0, LA - 1),
        e_cam=e_cam_g[order],
        e_uv=e_uv_g[order],
        e_valid=e_valid,
        exts=torch.stack([rig.left.pose, rig.right.pose]),
        intr=_intr(rig),
        pose_fixed=~wmap.kf_valid,
        point_valid=active_ids >= 0,
    )
    problem = BAProblem(graph=graph, poses=wmap.kf_pose, points=points, active_ids=active_ids, e_src=order)
    return problem, torch.stack([n_active, n_dropped])


def adaptive_chi2_threshold(chis: torch.Tensor, e_valid: torch.Tensor, ba_cfg: BAConfig) -> torch.Tensor:
    """Double the chi2 outlier threshold until the inlier ratio exceeds
    `inlier_ratio`, at most `max_chi2_doublings` times (backend_lego.cpp:
    164-184).  All candidate thresholds are tested at once and the first that
    passes is taken (the last if none does), without a device read."""
    n = ba_cfg.max_chi2_doublings + 1
    # [th, 2 th, 4 th, ...]: exact doublings, as the reference's loop makes them.
    pow2 = torch.full((n,), 2.0, dtype=chis.dtype, device=chis.device).cumprod(0) / 2.0
    ths = pow2 * ba_cfg.chi2_threshold
    n_in = (e_valid[None, :] & (chis[None, :] <= ths[:, None])).sum(-1, dtype=torch.int32)
    n_valid = torch.clamp(e_valid.sum(dtype=torch.int32), min=1)
    passes = n_in.to(chis.dtype) / n_valid.to(chis.dtype) > ba_cfg.inlier_ratio
    # The thresholds increase: the least that passes is the first, else the last.
    return torch.where(passes, ths, ths[-1]).amin()


def solve_window(cfg: FrontendConfig, rig: StereoRig, wmap: WorldMap, ba_cfg: BAConfig = BAConfig(),
                 solve_fn=None) -> BAResult:
    """Snapshot -> LM solve -> adaptive outlier classification, without the
    write-back (Backend::Optimize up to backend_lego.cpp:194).

    `solve_fn(graph, poses, points, lm_cfg) -> (BAState, LMResult)`, where
    given, replaces `lm.solve_ba` (parallel/dist_ba.py's sharded solve).
    The result is applied by `merge_ba_result`, at once (`ba_step`) or after
    tracking has moved on (pipeline/async_backend.py)."""
    if cfg.use_marg_prior and solve_fn is not None:
        raise ValueError("use_marg_prior is not supported with an injected solve_fn")
    with timer.span("ba_problem"):
        problem, counts = build_problem(cfg, rig, wmap)
    lm_cfg = lm_ops.LMConfig(iterations=ba_cfg.iterations, strategy=ba_cfg.strategy,
                             linear_solver=ba_cfg.linear_solver, trace=ba_cfg.trace,
                             assembly_precision=ba_cfg.assembly_precision)

    # Marginalization prior on the window poses (problem.cpp:338-355): the
    # stored sqrt-form prior, masked onto the slots that still hold the
    # keyframes it was built for, and weighted.
    pose_prior = None
    if cfg.use_marg_prior:
        mg = wmap.marg
        slot_ok = wmap.kf_valid & (mg.prior_kf_id >= 0) & (wmap.kf_id == mg.prior_kf_id)
        m6 = slot_ok.repeat_interleave(6).to(wmap.kf_pose.dtype)
        w = cfg.marg_prior_weight ** 0.5
        # Zero columns: no pull on recycled slots, which also linearize at
        # their own current pose (dx = 0 there).
        T_lin = torch.where(slot_ok[:, None, None], mg.prior_T, wmap.kf_pose)
        pose_prior = (mg.prior_J * m6[None, :] * w, mg.prior_err * w, T_lin)

    # The sums' fixed order on a card, without a host read: a keyframe's
    # feature table holds each landmark at most once, so a window slot has at
    # most 2 NF edges, a landmark 2 KW, and a (slot, landmark) pair one per
    # camera.
    KW, NF = cfg.caps.window, cfg.caps.max_features
    if solve_fn is None:
        with timer.span("ba_order"):
            order = schur.order_for(problem.graph, KW, problem.points.shape[0], widths=(2 * NF, 2 * KW, 2))
        with timer.span("lm_solve"):
            state, res = lm_ops.solve_ba(problem.graph, problem.poses, problem.points, kernel=robust.HUBER,
                                         delta=ba_cfg.chi2_threshold, cfg=lm_cfg, engine=ba_cfg.engine,
                                         pose_prior=pose_prior, order=order)
    else:
        with timer.span("lm_solve"):
            state, res = solve_fn(problem.graph, problem.poses, problem.points, lm_cfg)
        if ba_cfg.trace and res.trace.shape[0] != ba_cfg.iterations:
            # An injected solver may record no trace; the stats keep their shape.
            res = res._replace(trace=torch.full((ba_cfg.iterations, 2), torch.nan, dtype=problem.poses.dtype,
                                                device=problem.poses.device))

    with timer.span("ba_classify"):
        # Outlier classification at the optimum (robust chi2 per edge, raw points).
        chis = schur.edge_chi2(problem.graph, state.poses, state.points, robust.HUBER, ba_cfg.chi2_threshold)
        e_valid = schur.edge_mask(problem.graph)
        th = adaptive_chi2_threshold(chis, e_valid, ba_cfg)
        outlier_edge = e_valid & (chis > th)
        n_out = outlier_edge.sum(dtype=torch.int32)

        # Verdicts back onto the (2, KW, NF) grid through e_src (unique indices).
        out_grid = torch.zeros((2 * KW * NF,), dtype=torch.bool, device=chis.device)
        out_grid[problem.e_src] = outlier_edge
    stats = BAStats(
        chi=res.chi, iterations=res.iterations, n_outlier=n_out,
        n_inlier=e_valid.sum(dtype=torch.int32) - n_out,
        n_active_landmarks=counts[0], n_dropped_landmarks=counts[1],
        lam=res.lam, trace=res.trace, attempts=res.attempts,
    )

    # Window pose information at the optimum for the next eviction to
    # marginalize: the undamped Schur-reduced system plus the prior itself,
    # so information accumulates across evictions.  Assembled in float32 at
    # either precision, as the reference's (backend.py:300) is.
    info = None
    if pose_prior is not None:
        blocks_f = schur.build_blocks(problem.graph, state.poses, state.points, robust.HUBER, ba_cfg.chi2_threshold,
                                      order=order)
        S_f, b_f, _ = schur.schur_reduce(blocks_f, problem.graph.point_valid, 0.0, "default")
        prior_J, prior_err, T_lin = pose_prior
        r_p = prior_err + prior_J @ se3.se3_log(state.poses @ se3.se3_inv(T_lin)).reshape(-1)
        info = (S_f + prior_J.T @ prior_J, b_f - prior_J.T @ r_p, state.poses, wmap.kf_id)

    return BAResult(
        kf_id=wmap.kf_id, kf_frame_id=wmap.kf_frame_id, active_ids=problem.active_ids,
        point_valid=problem.graph.point_valid, poses=state.poses, points=state.points,
        out_l=out_grid[: KW * NF].reshape(KW, NF), out_r=out_grid[KW * NF:].reshape(KW, NF), stats=stats,
        info=info,
    )


def merge_ba_result(wmap: WorldMap, result: BAResult) -> WorldMap:
    """Write a `BAResult` back into a (possibly newer) world map
    (backend_lego.cpp:186-217):

    - poses only where the slot still holds the same keyframe (kf_id and
      kf_frame_id match);
    - landmark positions only for optimized landmarks still alive;
    - outlier observations removed only on matching slots and only where
      still registered, so the lm_obs decrement never double-fires.
    """
    slot_match = (wmap.kf_valid & (result.kf_id >= 0) & (wmap.kf_id == result.kf_id)
                  & (wmap.kf_frame_id == result.kf_frame_id))
    kf_pose = torch.where(slot_match[:, None, None], result.poses, wmap.kf_pose)

    ids = torch.clamp(result.active_ids, min=0).long()
    ok = result.point_valid & (result.active_ids >= 0) & wmap.lm_alive[ids]
    # Slots that write nothing go to a dump row ML, sliced off after.
    ML = wmap.lm_pos.shape[0]
    lm_pos = torch.cat([wmap.lm_pos, wmap.lm_pos.new_zeros((1, 3))])
    lm_pos.index_put_((torch.where(ok, ids, ML),), result.points)

    out_l = result.out_l & slot_match[:, None] & wmap.kf_obs_left
    out_r = result.out_r & slot_match[:, None] & wmap.kf_obs_right
    dec = out_l.to(torch.int32) + out_r.to(torch.int32)
    lm_idx = torch.clamp(wmap.kf_lm, min=0).long().reshape(-1)
    marg = wmap.marg
    if result.info is not None:
        S_f, b_f, T_f, kf_id_f = result.info
        marg = marg.replace(info_S=S_f, info_b=b_f, info_T=T_f, info_kf_id=kf_id_f)
    return wmap.replace(
        marg=marg,
        kf_pose=kf_pose,
        lm_pos=lm_pos[:ML],
        lm_obs=wmap.lm_obs.clone().index_add_(0, lm_idx, -dec.reshape(-1)),
        kf_obs_left=wmap.kf_obs_left & ~out_l,
        kf_obs_right=wmap.kf_obs_right & ~out_r,
    )


def ba_step(cfg: FrontendConfig, rig: StereoRig, wmap: WorldMap,
            ba_cfg: BAConfig = BAConfig(), solve_fn=None) -> Tuple[WorldMap, BAStats]:
    """One synchronous backend cycle: snapshot -> LM solve -> adaptive outlier
    rejection -> observation removal -> write-back (backend_lego.cpp:56-218);
    `solve_fn` as in `solve_window`."""
    with timer.span("ba"):
        result = solve_window(cfg, rig, wmap, ba_cfg, solve_fn=solve_fn)
        with timer.span("ba_merge"):
            return merge_ba_result(wmap, result), result.stats


def no_stats(ba_cfg: BAConfig, dtype, device) -> BAStats:
    """The stats of a frame on which BA did not run: NaN and 0."""
    nan = torch.full((), torch.nan, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return BAStats(chi=nan, iterations=0, n_outlier=zero, n_inlier=zero, n_active_landmarks=zero,
                   n_dropped_landmarks=zero, lam=nan,
                   trace=torch.full((ba_cfg.iterations if ba_cfg.trace else 0, 2), torch.nan,
                                    dtype=dtype, device=device))
