# Frozen copy of legoslam_tpu_torch/pipeline/frontend.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Frontend functions: tracking, pose, detection, stereo matching,
triangulation, keyframe insertion, stereo bootstrap (twin of
legoslam_tpu/pipeline/frontend.py).

Pure functions over the fixed-shape state (pipeline/state.py): each returns
new state and never writes into its inputs.  Scatters mirror the
reference's: writes that the reference drops (`mode="drop"`) are masked out
before `index_put_`, which neither drops out-of-range writes nor orders
duplicate ones, and `.at[].add` becomes `index_add_`, which sums duplicate
indices.

Conventions: poses are T_cw; images are float32 (H, W) grayscale 0..255;
pyramids are tuples of per-level tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from portbench.reference import se3, triangulation
from portbench.reference.camera import StereoRig
from portbench.reference import detect as detect_ops
from portbench.reference import klt as klt_ops
from portbench.reference import stereo as stereo_ops
from portbench.reference.rounding import div_const, small_matvec
from portbench.reference.state import Capacities, Features, WorldMap
from portbench.reference import lm as lm_ops
from portbench.reference import marginalization, reprojection


class FrontendConfig(NamedTuple):
    """Static configuration (reference values cited in utils/config.py)."""

    caps: Capacities = Capacities()
    num_features: int = 150
    num_features_init: int = 50
    num_features_tracking: int = 30
    num_features_tracking_bad: int = 5
    num_features_needed_for_keyframe: int = 80
    stereo_depth_superior_limit: float = 200.0
    stereo_depth_inferior_limit: float = 8.0
    ground_y_limit: float = 2.0
    detect_mask_half: int = 10
    gftt: detect_ops.GFTTConfig = detect_ops.GFTTConfig()
    klt: klt_ops.KLTConfig = klt_ops.KLTConfig()
    chi2_threshold: float = 5.991
    pose_outer_iterations: int = 4
    pose_solver_iterations: int = 10
    pose_exclude_outliers: bool = True
    num_active_keyframes: int = 15
    min_dis_th: float = 0.2
    sing_ratio_threshold: float = 1e-3
    # Forward-backward verification thresholds in px (0 disables) of the
    # "klt" stereo matcher and the "frame" track mode.
    stereo_fb_threshold: float = 0.6
    track_fb_threshold: float = 0.8
    # "scanline" (epipolar coarse scan + 1-D GN; rectified rigs) or "klt"
    # (general 2-D pyramid KLT, frontend_g2o.cpp:495-535).
    stereo_matcher: str = "scanline"
    # "anchored": track keyframe templates; "frame": last-frame-to-current
    # tracking (frontend_g2o.cpp:453-492).
    track_mode: str = "anchored"
    track_min_zncc: float = 0.5
    # Pyramid levels of the anchored tracker (0 = all of klt.levels).
    track_levels: int = 0
    scanline: stereo_ops.ScanlineConfig = stereo_ops.ScanlineConfig()
    max_keyframe_gap: int = 1_000_000
    # Fold evicted keyframes' information into a prior on the surviving
    # window poses (solver/marginalization.py); the weight tempers the
    # information that re-observed landmarks would count twice.
    use_marg_prior: bool = False
    marg_prior_weight: float = 0.5

    @staticmethod
    def from_config(cfg) -> "FrontendConfig":
        """Build from a utils.config.Config instance."""
        caps = Capacities(
            max_features=cfg["max_features"],
            window=cfg["keyframe_window_capacity"],
            active_landmarks=cfg["max_active_landmarks"],
            landmarks=cfg["max_landmarks"],
            ba_edges=cfg["max_ba_edges"],
        )
        return FrontendConfig(
            caps=caps,
            num_features=cfg["num_features"],
            num_features_init=cfg["num_features_init"],
            num_features_tracking=cfg["num_features_tracking"],
            num_features_tracking_bad=cfg["num_features_tracking_bad"],
            num_features_needed_for_keyframe=cfg["num_features_needed_for_keyframe"],
            stereo_depth_superior_limit=float(cfg["stereo_depth_superior_limit"]),
            stereo_depth_inferior_limit=float(cfg["stereo_depth_inferior_limit"]),
            ground_y_limit=float(cfg["ground_y_limit"]),
            detect_mask_half=cfg["detect_mask_half"],
            gftt=detect_ops.GFTTConfig(
                max_corners=cfg["num_features"],
                quality_level=cfg["gftt_quality_level"],
                min_distance=cfg["gftt_min_distance"],
            ),
            klt=klt_ops.KLTConfig(
                half_patch=cfg["klt_half_patch"],
                iterations=cfg["klt_iterations"],
                eps=cfg["klt_eps"],
                levels=cfg["klt_pyramid_levels"],
                scale=cfg["klt_pyramid_scale"],
                inverse=cfg["klt_inverse"],
                backend=cfg["klt_backend"],
            ),
            chi2_threshold=float(cfg["chi2_threshold"]),
            pose_outer_iterations=cfg["pose_outer_iterations"],
            pose_solver_iterations=cfg["pose_solver_iterations"],
            num_active_keyframes=cfg["num_active_keyframes"],
            min_dis_th=float(cfg["min_dis_th"]),
            sing_ratio_threshold=float(cfg["sing_ratio_threshold"]),
            stereo_fb_threshold=float(cfg["stereo_fb_threshold"]),
            track_fb_threshold=float(cfg["track_fb_threshold"]),
            stereo_matcher=cfg["stereo_matcher"],
            max_keyframe_gap=int(cfg["max_keyframe_gap"]),
            track_mode=cfg["track_mode"],
            track_min_zncc=float(cfg["track_min_zncc"]),
            track_levels=int(cfg["track_levels"]),
            use_marg_prior=bool(cfg["use_marg_prior"]),
            marg_prior_weight=float(cfg["marg_prior_weight"]),
        )


def _intr(rig: StereoRig) -> reprojection.Intrinsics:
    c = rig.left
    return reprojection.Intrinsics(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)


def _safe_gather_lm(lm_pos: torch.Tensor, lm_idx: torch.Tensor) -> torch.Tensor:
    return lm_pos[torch.clamp(lm_idx, min=0).long()]


def track_last_frame(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_last,
    pyr_cur,
    feats: Features,
    lm_pos: torch.Tensor,
    T_prior: torch.Tensor,
    rel_motion: torch.Tensor = None,
) -> Features:
    """TrackLastFrame (frontend_g2o.cpp:453-492): track features into the
    current frame, seeding landmark-linked lanes with their projection under
    the constant-velocity prior and unlinked lanes with the infinite-depth
    (rotation-only) flow of that prior.

    track_mode "anchored" matches keyframe templates; "frame" is the
    last-frame-to-current KLT over all pyramid levels with an optional
    forward-backward gate."""
    if cfg.track_mode not in ("anchored", "frame"):
        raise ValueError(f"unknown track_mode {cfg.track_mode!r} (anchored | frame)")
    has_lm = feats.lm >= 0
    proj = rig.left.world2pixel(_safe_gather_lm(lm_pos, feats.lm), T_prior)
    if rel_motion is not None:
        c = rig.left
        R = rel_motion[:3, :3]
        dx = div_const(feats.uv[:, 0] - c.cx, c.fx)
        dy = div_const(feats.uv[:, 1] - c.cy, c.fy)
        ray = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        d = small_matvec(R, ray)  # ray @ R.T
        z = torch.where(d[:, 2].abs() > 1e-6, d[:, 2], 1.0)
        rot_guess = torch.stack([c.fx * d[:, 0] / z + c.cx, c.fy * d[:, 1] / z + c.cy], dim=-1)
    else:
        rot_guess = feats.uv
    guess = torch.where(has_lm[:, None], proj, rot_guess).contiguous()
    if cfg.track_mode == "anchored":
        klt_cfg = cfg.klt
        if 0 < cfg.track_levels < klt_cfg.levels:
            # anchors are stored finest-first: track on the finest track_levels
            klt_cfg = klt_cfg._replace(levels=cfg.track_levels)
        kp2, ok = klt_ops.klt_pyramid_anchored(
            feats.anchor, feats.anchor_uv, pyr_cur, guess, feats.valid, klt_cfg,
            min_zncc=cfg.track_min_zncc,
        )
    else:
        uv = feats.uv.contiguous()
        kp2, ok = klt_ops.klt_pyramid(pyr_last, pyr_cur, uv, guess, feats.valid, cfg.klt)
        ok = _forward_backward(cfg.klt, pyr_cur, pyr_last, kp2, uv, ok, cfg.track_fb_threshold)
    return feats.replace(uv=kp2, uv_r=torch.zeros_like(kp2), has_right=torch.zeros_like(ok), valid=ok)


def _forward_backward(klt_cfg, pyr_to, pyr_from, kp_to, kp_from, ok, threshold: float) -> torch.Tensor:
    """Forward-backward gate of a frame-mode KLT pass: track the results
    back (lanes `ok`, starting from `kp_from`) and keep the lanes that
    return within `threshold` px of where they came from (0 disables)."""
    if threshold <= 0:
        return ok
    kp_back, ok_b = klt_ops.klt_pyramid(pyr_to, pyr_from, kp_to, kp_from, ok, klt_cfg)
    rt = torch.sum((kp_back - kp_from) ** 2, dim=-1)
    return ok & ok_b & (rt < threshold**2)


def estimate_current_pose(
    cfg: FrontendConfig,
    rig: StereoRig,
    feats: Features,
    lm_pos: torch.Tensor,
    T_prior: torch.Tensor,
) -> Tuple[torch.Tensor, Features, torch.Tensor]:
    """EstimateCurrentPose (frontend_g2o.cpp:157-245): motion-only BA over
    landmark-linked features; outliers lose their landmark link (:236-242).
    The CUDA kernel runs for CUDA tensors, the plain version for CPU ones.
    Returns (T, feats', num_inliers)."""
    edge_valid = feats.valid & (feats.lm >= 0)
    p_world = _safe_gather_lm(lm_pos, feats.lm)
    T, inlier, n_in = lm_ops.estimate_pose(
        _intr(rig), T_prior.contiguous(), p_world, feats.uv.contiguous(), edge_valid,
        chi2_th=cfg.chi2_threshold,
        outer_iterations=cfg.pose_outer_iterations,
        exclude_outliers=cfg.pose_exclude_outliers,
        cfg=lm_ops.LMConfig(iterations=cfg.pose_solver_iterations),
    )
    new_lm = torch.where(edge_valid & ~inlier, -1, feats.lm).to(torch.int32)
    return T, feats.replace(lm=new_lm), n_in


def detect_features(cfg: FrontendConfig, img: torch.Tensor, feats: Features) -> Features:
    """DetectFeatures (frontend_g2o.cpp:279-297): GFTT masked around existing
    features; live lanes are compacted to the front (linked, then unlinked,
    then free; stable) and detections appended, always reserving room for
    `num_features` fresh ones by dropping unlinked lanes first."""
    mask = detect_ops.occupancy_mask(tuple(img.shape), feats.uv, feats.valid, cfg.detect_mask_half)
    pos, dvalid = detect_ops.detect(img, cfg.gftt, exclude_mask=mask)

    nf = cfg.caps.max_features
    quota = max(nf - cfg.gftt.max_corners, 0)
    linked = feats.valid & (feats.lm >= 0)
    key = torch.where(linked, 0, torch.where(feats.valid, 1, 2))
    order = torch.sort(key, stable=True).indices
    compact = feats.map(lambda a: a[order])
    n_linked = linked.sum(dtype=torch.int32)
    rank = torch.arange(nf, dtype=torch.int32, device=img.device)
    keep = compact.valid & (rank < torch.clamp(n_linked, min=quota))
    n_live = keep.sum(dtype=torch.int32)
    tgt = n_live + torch.arange(pos.shape[0], dtype=torch.int32, device=img.device)
    # The reference drops out-of-range and invalid writes: mask them out.
    put = dvalid & (tgt < nf)
    idx = tgt[put].long()
    uv = compact.uv.clone()
    uv[idx] = pos[put]
    valid = keep.clone()
    valid[idx] = True
    lmv = compact.lm.clone()
    lmv[idx] = -1
    return compact.replace(uv=uv, uv_r=torch.zeros_like(uv), has_right=torch.zeros_like(valid), lm=lmv, valid=valid)


def find_features_in_right(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    feats: Features,
    lm_pos: torch.Tensor,
    T_cur: torch.Tensor,
) -> Features:
    """FindFeaturesInRight (frontend_g2o.cpp:495-535).

    stereo_matcher "scanline": epipolar coarse scan + 1-D GN, the disparity
    range from the depth gates (computed on the host from the rig's float
    intrinsics).  "klt": general 2-D pyramid KLT left to right, seeded by
    the landmark projections into the right camera, with an optional
    forward-backward gate."""
    if cfg.stereo_matcher == "scanline":
        fxb = float(rig.left.fx) * float(rig.right.baseline)
        z_inf = max(cfg.stereo_depth_inferior_limit, 0.5)
        d_max = fxb / z_inf
        d_lo = fxb / cfg.stereo_depth_superior_limit
        kp_r, ok = stereo_ops.match(pyr_left, pyr_right, feats.uv, feats.valid, d_lo, d_max, cfg.scanline)
        return feats.replace(uv_r=kp_r, has_right=ok)
    if cfg.stereo_matcher != "klt":
        raise ValueError(f"unknown stereo_matcher {cfg.stereo_matcher!r} (scanline | klt)")
    has_lm = feats.lm >= 0
    proj = rig.right.world2pixel(_safe_gather_lm(lm_pos, feats.lm), T_cur)
    guess = torch.where(has_lm[:, None], proj, feats.uv).contiguous()
    uv = feats.uv.contiguous()
    kp_r, ok = klt_ops.klt_pyramid(pyr_left, pyr_right, uv, guess, feats.valid, cfg.klt)
    ok = _forward_backward(cfg.klt, pyr_right, pyr_left, kp_r, uv, ok, cfg.stereo_fb_threshold)
    return feats.replace(uv_r=kp_r, has_right=ok)


def triangulate_new_points(
    cfg: FrontendConfig,
    rig: StereoRig,
    feats: Features,
    wmap: WorldMap,
    T_cur: torch.Tensor,
) -> Tuple[Features, WorldMap, torch.Tensor]:
    """TriangulateNewPoints / BuildInitMap core (frontend_g2o.cpp:111-155,
    310-349): triangulate features with a right match and no landmark, gate
    on the singular-value ratio, y <= ground limit and the depth limits, then
    allocate landmark slots from the cursor.

    Returns (feats', map', born_mask)."""
    cand = feats.valid & feats.has_right & (feats.lm < 0)
    pn_l = rig.left.pixel2camera(feats.uv)[..., :2]
    pn_r = rig.right.pixel2camera(feats.uv_r)[..., :2]
    pt_rig, ok = triangulation.triangulate_stereo(
        rig.left.pose, rig.right.pose, pn_l, pn_r, cfg.sing_ratio_threshold
    )
    accept = (
        cand
        & ok
        & (pt_rig[:, 1] <= cfg.ground_y_limit)
        & (pt_rig[:, 2] > cfg.stereo_depth_inferior_limit)
        & (pt_rig[:, 2] <= cfg.stereo_depth_superior_limit)
    )
    p_world = se3.transform(se3.se3_inv(T_cur), pt_rig)

    rank = torch.cumsum(accept.to(torch.int32), dim=0, dtype=torch.int32) - 1
    new_id = wmap.lm_next + rank
    put = accept & (new_id < cfg.caps.landmarks)
    idx = new_id[put].long()
    lm_pos = wmap.lm_pos.clone()
    lm_pos[idx] = p_world[put]
    lm_alive = wmap.lm_alive.clone()
    lm_alive[idx] = True
    wmap = wmap.replace(lm_pos=lm_pos, lm_alive=lm_alive, lm_next=wmap.lm_next + put.sum(dtype=torch.int32))
    feats = feats.replace(lm=torch.where(put, new_id, feats.lm).to(torch.int32))
    return feats, wmap, put


def _evict_if_full(cfg: FrontendConfig, wmap: WorldMap, T_cur: torch.Tensor) -> WorldMap:
    """Map::RemoveOldKeyframe + CleanMap (src/map.cpp:34-100): when the window
    holds num_active keyframes, drop the one nearest the current pose if it
    is nearer than min_dis_th, else the farthest; un-register its
    observations.  "Active" landmarks are derived (WorldMap.lm_active_mask),
    so CleanMap needs no step of its own.

    With `use_marg_prior` the evicted keyframe's 6 coordinates are
    marginalized out of the window's pose information at the last BA
    linearization (wmap.marg.info_*), and the Schur complement is kept as a
    sqrt-form prior on the survivors (problem.cpp:617-781)."""
    full = wmap.num_keyframes() >= cfg.num_active_keyframes

    rel = wmap.kf_pose @ se3.se3_inv(T_cur)
    dis = torch.linalg.vector_norm(se3.se3_log(rel), dim=-1)
    big = torch.tensor(1e30, dtype=dis.dtype, device=dis.device)
    dis_valid = torch.where(wmap.kf_valid, dis, big)
    min_slot = torch.argmin(dis_valid)
    max_slot = torch.argmax(torch.where(wmap.kf_valid, dis, -big))
    evict = torch.where(dis_valid[min_slot] < cfg.min_dis_th, min_slot, max_slot)

    obs_l = wmap.kf_obs_left[evict] & full
    obs_r = wmap.kf_obs_right[evict] & full
    lm_idx = torch.clamp(wmap.kf_lm[evict], min=0).long()
    dec = obs_l.to(torch.int32) + obs_r.to(torch.int32)
    lm_obs = wmap.lm_obs.clone().index_add_(0, lm_idx, -dec)

    if cfg.use_marg_prior:
        mg = wmap.marg
        slots = torch.arange(wmap.kf_valid.shape[0], device=evict.device)
        # Only slots that still hold the keyframe the information was
        # linearized for take part; stale slots zero out.
        slot_ok = (mg.info_kf_id >= 0) & (mg.info_kf_id == wmap.kf_id) & wmap.kf_valid
        m6 = slot_ok.repeat_interleave(6).to(wmap.kf_pose.dtype)
        factor = marginalization.marginalize(
            mg.info_S * m6[:, None] * m6[None, :], mg.info_b * m6, (slots == evict).repeat_interleave(6), 6)
        prior_kf_id = torch.where(slot_ok & (slots != evict), mg.info_kf_id, -1).to(torch.int32)
        wmap = wmap.replace(marg=mg.replace(
            prior_J=torch.where(full, factor.sqrt_J, mg.prior_J),
            prior_err=torch.where(full, factor.err, mg.prior_err),
            prior_T=torch.where(full, mg.info_T, mg.prior_T),
            prior_kf_id=torch.where(full, prior_kf_id, mg.prior_kf_id),
        ))

    def clear(slot_arr, fill):
        out = slot_arr.clone()
        out[evict] = torch.where(full, torch.as_tensor(fill, dtype=out.dtype, device=out.device), slot_arr[evict])
        return out

    return wmap.replace(
        lm_obs=lm_obs,
        kf_valid=clear(wmap.kf_valid, False),
        kf_id=clear(wmap.kf_id, -1),
        kf_frame_id=clear(wmap.kf_frame_id, -1),
        kf_obs_left=clear(wmap.kf_obs_left, False),
        kf_obs_right=clear(wmap.kf_obs_right, False),
        kf_lm=clear(wmap.kf_lm, -1),
    )


def _register_keyframe(wmap: WorldMap, feats: Features, born: torch.Tensor, T: torch.Tensor,
                       frame_id: int) -> WorldMap:
    """Write the keyframe record into the first free window slot and count
    its observations (frontend.py:488-505 / :538-554 of the reference)."""
    slot = torch.argmin(wmap.kf_valid.to(torch.int32))  # first free slot
    obs_left = feats.valid & (feats.lm >= 0)
    lm_idx = torch.clamp(feats.lm, min=0).long()
    inc = obs_left.to(torch.int32) + born.to(torch.int32)

    def put(arr, value):
        out = arr.clone()
        out[slot] = value
        return out

    return wmap.replace(
        lm_obs=wmap.lm_obs.clone().index_add_(0, lm_idx, inc),
        kf_pose=put(wmap.kf_pose, T),
        kf_id=put(wmap.kf_id, wmap.next_kf_id),
        kf_frame_id=put(wmap.kf_frame_id, frame_id),
        kf_valid=put(wmap.kf_valid, True),
        next_kf_id=wmap.next_kf_id + 1,
        kf_uv=put(wmap.kf_uv, feats.uv),
        kf_uv_r=put(wmap.kf_uv_r, feats.uv_r),
        kf_lm=put(wmap.kf_lm, feats.lm),
        kf_obs_left=put(wmap.kf_obs_left, obs_left),
        kf_obs_right=put(wmap.kf_obs_right, born),
    )


def insert_keyframe(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    img_left: torch.Tensor,
    feats: Features,
    wmap: WorldMap,
    T_cur: torch.Tensor,
    frame_id: int,
) -> Tuple[Features, WorldMap]:
    """InsertKeyframe (frontend_g2o.cpp:77-102): evict-if-full, detect new
    features, re-anchor every live template at this keyframe, match in the
    right image, triangulate, and write the keyframe record."""
    wmap = _evict_if_full(cfg, wmap, T_cur)
    feats = detect_features(cfg, img_left, feats)
    feats = feats.replace(anchor=klt_ops.extract_anchors(pyr_left, feats.uv, cfg.klt), anchor_uv=feats.uv)
    feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats, wmap.lm_pos, T_cur)
    feats, wmap, born = triangulate_new_points(cfg, rig, feats, wmap, T_cur)
    return feats, _register_keyframe(wmap, feats, born, T_cur, frame_id)


def stereo_init(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    img_left: torch.Tensor,
    wmap: WorldMap,
    frame_id: int,
) -> Tuple[bool, Features, WorldMap]:
    """StereoInit + BuildInitMap (frontend_g2o.cpp:258-349): detect, stereo
    match and, with enough matches, triangulate the initial map and insert
    the first keyframe at the identity pose.  Returns (success, feats, map');
    on failure the map passes through unchanged."""
    dev = img_left.device
    empty = Features.empty(cfg.caps, img_left.dtype, cfg.klt.levels, 2 * cfg.klt.half_patch + 3, dev)
    feats = detect_features(cfg, img_left, empty)
    feats = feats.replace(anchor=klt_ops.extract_anchors(pyr_left, feats.uv, cfg.klt), anchor_uv=feats.uv)
    T0 = torch.eye(4, dtype=img_left.dtype, device=dev)
    feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats, wmap.lm_pos, T0)
    n_match = int((feats.valid & feats.has_right).sum())
    if n_match < cfg.num_features_init:
        return False, feats, wmap
    feats, wmap, born = triangulate_new_points(cfg, rig, feats, wmap, T0)
    return True, feats, _register_keyframe(wmap, feats, born, T0, frame_id)
