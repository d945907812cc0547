"""Frontend functions: tracking, pose, detection, stereo matching,
triangulation, keyframe insertion, stereo bootstrap (twin of
legoslam_tpu/pipeline/frontend.py; anchored tracking and scanline stereo).

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

from legoslam_tpu_torch.geometry import se3, triangulation
from legoslam_tpu_torch.geometry.camera import StereoRig
from legoslam_tpu_torch.kernels import pose as pose_kernels
from legoslam_tpu_torch.ops import detect as detect_ops
from legoslam_tpu_torch.ops import klt as klt_ops
from legoslam_tpu_torch.ops import stereo as stereo_ops
from legoslam_tpu_torch.pipeline.state import Capacities, Features, WorldMap
from legoslam_tpu_torch.solver import lm as lm_ops
from legoslam_tpu_torch.solver import reprojection


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
    # Only the anchored tracker and the scanline matcher are ported; the
    # reference's "frame" tracking and "klt" stereo raise.
    stereo_matcher: str = "scanline"
    track_mode: str = "anchored"
    track_min_zncc: float = 0.5
    # Pyramid levels of the anchored tracker (0 = all of klt.levels).
    track_levels: int = 0
    scanline: stereo_ops.ScanlineConfig = stereo_ops.ScanlineConfig()
    max_keyframe_gap: int = 1_000_000
    use_marg_prior: bool = False

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
            stereo_matcher=cfg["stereo_matcher"],
            max_keyframe_gap=int(cfg["max_keyframe_gap"]),
            track_mode=cfg["track_mode"],
            track_min_zncc=float(cfg["track_min_zncc"]),
            track_levels=int(cfg["track_levels"]),
            use_marg_prior=bool(cfg["use_marg_prior"]),
        )


def _intr(rig: StereoRig) -> reprojection.Intrinsics:
    c = rig.left
    return reprojection.Intrinsics(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)


def _safe_gather_lm(lm_pos: torch.Tensor, lm_idx: torch.Tensor) -> torch.Tensor:
    return lm_pos[torch.clamp(lm_idx, min=0).long()]


def track_last_frame(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_cur,
    feats: Features,
    lm_pos: torch.Tensor,
    T_prior: torch.Tensor,
    rel_motion: torch.Tensor = None,
) -> Features:
    """TrackLastFrame (frontend_g2o.cpp:453-492), anchored: track keyframe
    templates into the current frame, seeding landmark-linked lanes with
    their projection under the constant-velocity prior and unlinked lanes
    with the infinite-depth (rotation-only) flow of that prior."""
    if cfg.track_mode != "anchored":
        raise NotImplementedError(f"track_mode {cfg.track_mode!r} is not ported (anchored only)")
    has_lm = feats.lm >= 0
    proj = rig.left.world2pixel(_safe_gather_lm(lm_pos, feats.lm), T_prior)
    if rel_motion is not None:
        c = rig.left
        R = rel_motion[:3, :3]
        dx = (feats.uv[:, 0] - c.cx) / c.fx
        dy = (feats.uv[:, 1] - c.cy) / c.fy
        ray = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        d = (ray[:, None, :] * R[None, :, :]).sum(-1)  # ray @ R.T
        z = torch.where(d[:, 2].abs() > 1e-6, d[:, 2], 1.0)
        rot_guess = torch.stack([c.fx * d[:, 0] / z + c.cx, c.fy * d[:, 1] / z + c.cy], dim=-1)
    else:
        rot_guess = feats.uv
    guess = torch.where(has_lm[:, None], proj, rot_guess)
    klt_cfg = cfg.klt
    if 0 < cfg.track_levels < klt_cfg.levels:
        # anchors are stored finest-first: track on the finest track_levels
        klt_cfg = klt_cfg._replace(levels=cfg.track_levels)
    kp2, ok = klt_ops.klt_pyramid_anchored(
        feats.anchor, feats.anchor_uv, pyr_cur, guess.contiguous(), feats.valid, klt_cfg,
        min_zncc=cfg.track_min_zncc,
    )
    return feats.replace(uv=kp2, uv_r=torch.zeros_like(kp2), has_right=torch.zeros_like(ok), valid=ok)


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
    T, inlier, n_in = pose_kernels.estimate_pose(
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
) -> Features:
    """FindFeaturesInRight (frontend_g2o.cpp:495-535), scanline matcher:
    epipolar coarse scan + 1-D GN, the disparity range from the depth gates
    (computed on the host from the rig's float intrinsics)."""
    if cfg.stereo_matcher != "scanline":
        raise NotImplementedError(f"stereo_matcher {cfg.stereo_matcher!r} is not ported (scanline only)")
    fxb = float(rig.left.fx) * float(rig.right.baseline)
    z_inf = max(cfg.stereo_depth_inferior_limit, 0.5)
    d_max = fxb / z_inf
    d_lo = fxb / cfg.stereo_depth_superior_limit
    kp_r, ok = stereo_ops.match(pyr_left, pyr_right, feats.uv, feats.valid, d_lo, d_max, cfg.scanline)
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
    so CleanMap needs no step of its own."""
    if cfg.use_marg_prior:
        raise NotImplementedError("use_marg_prior is not ported yet")
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
    feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats)
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
    feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats)
    n_match = int((feats.valid & feats.has_right).sum())
    if n_match < cfg.num_features_init:
        return False, feats, wmap
    T0 = torch.eye(4, dtype=img_left.dtype, device=dev)
    feats, wmap, born = triangulate_new_points(cfg, rig, feats, wmap, T0)
    return True, feats, _register_keyframe(wmap, feats, born, T0, frame_id)
