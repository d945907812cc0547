"""Minimal loop closure: keyframe place recognition -> KLT + pose-solve
verification -> pose-graph correction (twin of
legoslam_tpu/pipeline/loop_closure.py).

- **place recognition**: every keyframe keeps a tiny normalized thumbnail;
  candidates are past keyframes (outside the sliding window) whose thumbnail
  ZNCC against the new keyframe clears a threshold.  One matvec per keyframe.
- **geometric verification**: the candidate keyframe's stored features are
  KLT-tracked into the new keyframe's image and back (frame-mode pyramid
  KLT, ops/klt.py: the CUDA kernel on the card) with forward-backward
  gating, then a motion-only pose solve (solver/lm.py solve_pose) against
  the candidate's stored landmark positions measures the loop transform;
  accept on inlier count.
- **correction**: a pose graph over the keyframe trajectory, odometry edges
  from consecutive stored poses and loop edges from verified closures, is
  optimized on the host in float64 (solver/pose_graph_host.py), and the live
  world (current pose, window keyframes, landmarks) is re-anchored rigidly
  by the newest keyframe's correction.

Precisions stay where the reference has them: records and the pose graph
are float64 NumPy on the host, verification is float32 on `device`, and the
SE(3) average of the forward and reverse measurement goes through float32
`se3_log` / `se3_exp`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.ops import klt as klt_ops
from legoslam_tpu_torch.ops import pyramid as pyr_ops
from legoslam_tpu_torch.solver import lm as lm_ops
from legoslam_tpu_torch.solver import pose_graph_host, reprojection, robust
from legoslam_tpu_torch.utils.logging import get_logger

log = get_logger("legoslam.loop")

THUMB = (12, 20)  # thumbnail grid (rows, cols)


@dataclass
class KeyframeRecord:
    """Host-side snapshot of one keyframe at insertion time.

    `T_cw` is the record's *current best* pose: it starts as the insertion-time
    odometry and is overwritten by every accepted pose-graph correction.
    `T_cw_obs` is the immutable insertion-time pose - the epoch the stored
    landmarks (`p_world`) live in; loop measurements must be built against it,
    not against the corrected `T_cw` (a later correction would otherwise
    silently shift the measurement's reference frame).
    `img` is stored quantized (uint8) so the record set stays bounded at
    KITTI scale (~29 KB/keyframe at half resolution instead of 116 KB)."""

    frame_id: int
    T_cw: np.ndarray        # (4, 4) current best pose (pose-graph corrected)
    T_cw_obs: np.ndarray    # (4, 4) insertion-time pose (immutable epoch)
    rel_prev: np.ndarray    # (4, 4) odometry measurement T_this T_prev^-1 at
                            # insertion (immutable; identity for the first)
    thumb: np.ndarray       # THUMB, zero-mean unit-norm
    img: np.ndarray         # (H/2, W/2) half-resolution left image, uint8
    uv: np.ndarray          # (M, 2) feature positions in the half-res image
    p_world: np.ndarray     # (M, 3) landmark positions at insertion
    n_feats: int


def make_thumbnail(img: np.ndarray) -> np.ndarray:
    """Block-mean downsample to THUMB + low-pass, normalized for ZNCC.

    The [1,2,1]/4 grid smoothing matters: block means of high-frequency
    texture decorrelate within a fraction of a meter of viewpoint offset
    (measured on the synthetic corridor: 0.25 m forward drops raw-block ZNCC
    from 1.0 to 0.2), and revisits never land on the exact stored pose.  Two
    smoothing passes keep a ~1 m revisit at >=0.6 while unrelated views stay
    <=0.25."""
    H, W = img.shape
    th, tw = THUMB
    ys = (H // th) * th
    xs = (W // tw) * tw
    t = img[:ys, :xs].reshape(th, ys // th, tw, xs // tw).mean(axis=(1, 3))
    for _ in range(2):
        p = np.pad(t, ((1, 1), (0, 0)), mode="edge")
        t = p[:-2] * 0.25 + p[1:-1] * 0.5 + p[2:] * 0.25
        p = np.pad(t, ((0, 0), (1, 1)), mode="edge")
        t = p[:, :-2] * 0.25 + p[:, 1:-1] * 0.5 + p[:, 2:] * 0.25
    t = t - t.mean()
    n = np.linalg.norm(t)
    return (t / n if n > 1e-6 else t).astype(np.float32)


@dataclass
class LoopConfig:
    # Thumbnail proposer gate.  With the low-passed thumbnails a ~1 m-offset
    # revisit scores >=0.6 and unrelated views <=0.25 (measured, corridor
    # world); a false candidate only costs one (rejected) geometric
    # verification, so the gate sits near the distractor ceiling.
    zncc_min: float = 0.5
    # Verification is tried on the top-K proposals above the gate: on
    # self-similar scenes the single best thumbnail can be a perceptual alias
    # of a *different* place while the true revisit scores just behind it.
    max_candidates: int = 3
    min_gap: int = 10            # candidate must be this many keyframes older
    min_inliers: int = 25        # verified 3D-2D inliers to accept
    # Odometry-consistency gate: the measured loop transform may differ from
    # the stored (drifted) odometry by at most floor + frac * path-length
    # between the two keyframes.  Perceptual aliases produce confidently
    # *wrong* transforms whose implied "drift" is far beyond anything the
    # odometry could have accumulated; genuine corrections sit well inside
    # (measured: 0.4 m true vs 2.0 m alias over a 28 m loop).
    consistency_floor: float = 0.5
    consistency_frac: float = 0.05
    # Post-optimization acceptance gate: the pose graph exists to *absorb* the
    # loop residual, so a healthy solve ends with chi well below the
    # pre-correction chi (measured: 7.2 -> 0.098 on the corridor lap).  A
    # solve that fails to converge - or converges to a mangled chain - ends
    # at or above chi0 and must be rejected rather than applied (a bad
    # correction is strictly worse than no correction).
    pg_accept_chi_ratio: float = 0.5
    # After an accepted closure, skip detection for this many keyframes (let
    # the tracker settle on the re-anchored map).  Kept SHORT deliberately:
    # re-closing against further keyframes of the same revisit adds loop
    # edges that pin the whole revisited segment, not just its first frame -
    # a single loop edge leaves the solver free to bow the chain between the
    # anchor and the (noisy) measurement, while two or three edges a few
    # keyframes apart rigidify it (measured on the corridor lap: 1 closure
    # -> kf ATE 0.41, 2 closures -> 0.25 vs 0.31 open).  The chi acceptance
    # gate and the odometry-consistency gate make re-closure safe.
    cooldown_keyframes: int = 2
    chi2_threshold: float = 5.991
    odom_weight: float = 1.0
    loop_weight: float = 20.0
    klt: klt_ops.KLTConfig = field(default_factory=lambda: klt_ops.KLTConfig(levels=3))
    fb_threshold: float = 0.8    # forward-backward gate (half-res px)
    max_feats: int = 256         # fixed verify lane count
    # f64 Gauss-Newton iterations (pose_graph_host): converges quadratically
    # from the odometry init - 3-4 reach machine-level chi on the test lap.
    pg_iterations: int = 4


class LoopCloser:
    """Host-side loop-closure driver (used by VisualOdometry or standalone).
    Verification runs on `device`; everything else is NumPy on the host."""

    def __init__(self, rig, cfg: Optional[LoopConfig] = None, device="cuda"):
        self.cfg = cfg if cfg is not None else LoopConfig()
        self.device = torch.device(device)
        # Half-resolution camera for verification (uv and intrinsics / 2).
        self.intr = reprojection.Intrinsics(
            fx=rig.left.fx * 0.5, fy=rig.left.fy * 0.5,
            cx=rig.left.cx * 0.5, cy=rig.left.cy * 0.5,
        )
        self.records: List[KeyframeRecord] = []
        self.loop_edges: List[Tuple[int, int, np.ndarray]] = []  # (i_new, j_old, M_ij)
        self.stats = {"candidates": 0, "verified": 0, "closures": 0, "pg_rejected": 0}
        self._cooldown = 0

    # ------------------------------------------------------------------
    def add_keyframe(
        self, frame_id: int, img_full: np.ndarray, T_cw: np.ndarray,
        uv: np.ndarray, p_world: np.ndarray,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Register a new keyframe.  If a loop closes, returns
        (corrected (N, 4, 4) keyframe trajectory,
         G (4, 4) world-to-world correction: p' = G p for map points,
         Q' = Q G^-1 for live camera-from-world poses); else None."""
        img = img_full[::2, ::2].astype(np.float32)
        M = self.cfg.max_feats
        uv_p = np.zeros((M, 2), np.float32)
        pw_p = np.zeros((M, 3), np.float32)
        n = min(len(uv), M)
        uv_p[:n] = uv[:n] * 0.5
        pw_p[:n] = p_world[:n]
        T64 = np.asarray(T_cw, np.float64)
        # Immutable odometry measurement vs the previous keyframe: both poses
        # live in the same (current) world epoch, so the relative transform is
        # epoch-free even across past corrections.
        rel_prev = (
            T64 @ np.linalg.inv(self.records[-1].T_cw)
            if self.records else np.eye(4)
        )
        rec = KeyframeRecord(
            frame_id=frame_id, T_cw=T64.copy(), T_cw_obs=T64.copy(),
            rel_prev=rel_prev,
            thumb=make_thumbnail(img),
            img=np.clip(img, 0.0, 255.0).astype(np.uint8),
            uv=uv_p, p_world=pw_p, n_feats=n,
        )
        self.records.append(rec)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        candidates = self._detect()
        if not candidates:
            return None
        ok = False
        for j in candidates:
            self.stats["candidates"] += 1
            ok, M_ij, n_in = self._verify(j)
            if ok:
                break
            log.info("loop: candidate kf%d->kf%d rejected (%d inliers)",
                     len(self.records) - 1, j, n_in)
        if not ok:
            return None
        self.stats["verified"] += 1
        i = len(self.records) - 1
        self.loop_edges.append((i, j, M_ij))
        T_old_last = self.records[-1].T_cw.copy()
        corrected, chi0, chi1, new_edge_rejected = self._optimize()
        # Acceptance gates: the newest edge must have survived the solve's
        # outlier pass, and the solve must actually have absorbed the loop
        # residual (LoopConfig.pg_accept_chi_ratio).
        if new_edge_rejected or not (
            np.isfinite(chi1) and chi1 <= self.cfg.pg_accept_chi_ratio * chi0 + 1e-2
        ):
            self.stats["pg_rejected"] += 1
            log.warning(
                "loop: pose-graph solve rejected closure kf%d -> kf%d "
                "(chi %.4f -> %.4f, new_edge_rejected=%s)",
                i, j, chi0, chi1, new_edge_rejected,
            )
            return None
        log.info("loop: closing kf%d -> kf%d (%d inliers, chi %.3f -> %.3f)",
                 i, j, n_in, chi0, chi1)
        # Persist the corrected poses as the new odometry anchor for future
        # edges (observation epochs T_cw_obs stay untouched).
        for k, r in enumerate(self.records):
            r.T_cw = corrected[k].copy()
        # World-to-world correction from the newest keyframe: x_c = T p_old =
        # T' p_new  =>  p_new = T'^-1 T p_old.
        G = np.linalg.inv(corrected[-1]) @ T_old_last
        self.stats["closures"] += 1
        self._cooldown = self.cfg.cooldown_keyframes
        return corrected, G

    def reset(self) -> None:
        """Tracking was LOST and the map wiped; stored poses are no longer in
        one frame, so drop the place-recognition history."""
        self.records.clear()
        self.loop_edges.clear()
        self._cooldown = 0

    # ------------------------------------------------------------------
    def _detect(self) -> List[int]:
        """Top-K past keyframes by thumbnail ZNCC, outside the recent window."""
        n = len(self.records)
        if n - 1 - self.cfg.min_gap < 0:
            return []
        cur = self.records[-1].thumb.reshape(-1)
        past = np.stack([r.thumb.reshape(-1) for r in self.records[: n - self.cfg.min_gap]])
        scores = past @ cur
        order = np.argsort(-scores)[: self.cfg.max_candidates]
        return [int(j) for j in order if scores[j] >= self.cfg.zncc_min]

    # ------------------------------------------------------------------
    def _verify_device(self, pyr_j, pyr_i, uv_j, valid, p_world, T_init):
        """KLT j->i and back with forward-backward gating, then a robust pose
        solve on the surviving 3D-2D pairs: 4 reweighting rounds
        (frontend_g2o.cpp:199-227), each warm-started from the last, inliers
        by the raw chi2.  Returns (T, number of inliers) on the device."""
        cfg = self.cfg
        uv_i, conv = klt_ops.klt_pyramid(pyr_j, pyr_i, uv_j, uv_j, valid, cfg.klt)
        uv_b, conv_b = klt_ops.klt_pyramid(pyr_i, pyr_j, uv_i, uv_i, valid, cfg.klt)
        fb_ok = torch.linalg.vector_norm(uv_b - uv_j, dim=-1) < cfg.fb_threshold
        ok = valid & conv & conv_b & fb_ok

        T = T_init
        inlier = ok
        for _ in range(4):
            T, _ = lm_ops.solve_pose(
                self.intr, T, p_world, uv_i, inlier,
                kernel=robust.HUBER, delta=cfg.chi2_threshold,
                cfg=lm_ops.LMConfig(iterations=10),
            )
            r, _ = reprojection.pose_only_edge(self.intr, T, p_world, uv_i)
            chi = torch.sum(r * r, dim=-1)
            inlier = ok & (chi <= cfg.chi2_threshold)
        return T, inlier.sum(dtype=torch.int32)

    def _verify_fn(self, pyr_from, pyr_to, rec: KeyframeRecord) -> Tuple[np.ndarray, int]:
        """`_verify_device` for one record's features; one host read (the
        pose and the inlier count in one transfer) beyond the LM's own."""
        dev = self.device
        valid = torch.arange(self.cfg.max_feats, device=dev) < rec.n_feats
        T, n_in = self._verify_device(
            pyr_from, pyr_to, torch.from_numpy(rec.uv).to(dev), valid, torch.from_numpy(rec.p_world).to(dev),
            torch.from_numpy(rec.T_cw_obs.astype(np.float32)).to(dev),
        )
        out = torch.cat([T.reshape(-1), n_in.to(T.dtype).reshape(1)]).cpu().numpy()
        return out[:16].reshape(4, 4).astype(np.float64), int(out[16])

    def _verify(self, j: int) -> Tuple[bool, np.ndarray, int]:
        rec_i = self.records[-1]
        rec_j = self.records[j]
        cfg = self.cfg

        def pyramid_of(rec):
            img = torch.from_numpy(rec.img).to(self.device).to(torch.float32)
            return tuple(pyr_ops.build_pyramid(img, cfg.klt.levels))

        pyr_j, pyr_i = pyramid_of(rec_j), pyramid_of(rec_i)
        # The solve runs in the candidate's *observation* epoch (T_cw_obs,
        # the frame rec_j.p_world lives in), not the corrected T_cw, whose
        # epoch moves with every accepted closure.
        T_loop, n_in = self._verify_fn(pyr_j, pyr_i, rec_j)
        if n_in < cfg.min_inliers:
            return False, np.eye(4), n_in
        # Loop measurement M_ij = T_i T_j^-1 with T_i measured as T_loop (the
        # new keyframe's pose expressed in the candidate's observation epoch).
        M = T_loop @ np.linalg.inv(rec_j.T_cw_obs)
        # Symmetric verification: KLT template-anchor bias is systematic and
        # roughly antisymmetric in the track direction, so also measure the
        # reverse loop (track i -> j against the new keyframe's stored
        # landmarks) and average the two on SE(3).  Falls back to the forward
        # measurement when the new keyframe has too few stored features.
        T_rev, n_rev = self._verify_fn(pyr_i, pyr_j, rec_i)
        if n_rev >= cfg.min_inliers:
            M_rev = np.linalg.inv(T_rev @ np.linalg.inv(rec_i.T_cw_obs))
            D = se3.se3_log(torch.from_numpy((np.linalg.inv(M) @ M_rev).astype(np.float32)))
            M = M @ se3.se3_exp(0.5 * D).numpy().astype(np.float64)
            n_in = min(n_in + n_rev, 2 * n_in)
        # Odometry-consistency gate (LoopConfig.consistency_*): the implied
        # correction = how far the measurement moves keyframe i from where
        # odometry put it; bound it by the drift the path could plausibly
        # have accumulated.
        M_odom = rec_i.T_cw @ np.linalg.inv(rec_j.T_cw)
        correction = np.linalg.norm(M[:3, 3] - M_odom[:3, 3])
        j_idx = j
        path = sum(
            float(np.linalg.norm(
                (self.records[k + 1].T_cw @ np.linalg.inv(self.records[k].T_cw))[:3, 3]
            ))
            for k in range(j_idx, len(self.records) - 1)
        )
        budget = cfg.consistency_floor + cfg.consistency_frac * path
        if correction > budget:
            log.info(
                "loop: candidate rejected by odometry consistency "
                "(correction %.2f m > budget %.2f m over %.1f m path)",
                correction, budget, path,
            )
            return False, np.eye(4), n_in
        return True, M, n_in

    # ------------------------------------------------------------------
    def _optimize(self) -> Tuple[np.ndarray, float, float, bool]:
        """Pose graph over all stored keyframes: odometry + loop edges.

        The measurements are IMMUTABLE: odometry edges use each record's
        insertion-time `rel_prev`, never the corrected chain (rebuilding
        edges from corrected poses would bake an earlier solve's error into
        zero-residual "measurements" that no later closure could undo).  The
        solve is the host f64 Gauss-Newton of solver/pose_graph_host.py,
        initialized at the raw odometry integration: deterministic and
        basin-free.  Loop edges whose post-solve residual exceeds the outlier
        threshold are dropped permanently; if the NEWEST edge is dropped,
        the closure is rejected.

        Returns (corrected (n, 4, 4) f64, chi_before, chi_after,
        new_edge_rejected); does NOT persist - the caller gates first."""
        n = len(self.records)
        rel = [self.records[k].rel_prev for k in range(1, n)]
        poses, chi0, chi1, dropped = pose_graph_host.solve_chain_graph(
            rel, self.loop_edges,
            anchor=self.records[0].T_cw,
            odom_weight=self.cfg.odom_weight,
            loop_weight=self.cfg.loop_weight,
            iterations=self.cfg.pg_iterations,
        )
        new_idx = len(self.loop_edges) - 1
        new_edge_rejected = new_idx in dropped
        if dropped:
            log.warning(
                "loop: %d loop edge(s) dropped as post-solve outliers: %s",
                len(dropped), [
                    (self.loop_edges[d][0], self.loop_edges[d][1]) for d in dropped
                ],
            )
            self.loop_edges = [
                e for idx, e in enumerate(self.loop_edges) if idx not in dropped
            ]
        return poses, float(chi0), float(chi1), new_edge_rejected
