"""What decides `correct`: each sampled frame's covered stages worked out
again by the plain reference (portbench/reference) from the state the port
handed each stage, and the widest gap of each kind set beside its limit.

The numbers compared (each the largest over the run's samples):
- track_px: tracked positions (px) on lanes both sides keep; track_lanes:
  lanes kept by one side only (K1 and its gate);
- pose_T: the pose's largest entry gap (rotation and metres, K2);
  pose_lanes: lanes whose landmark link (inlier verdict) differs;
- kf_px: new detections and stereo matches (px) where both have them;
  kf_lanes: lanes whose slot, match or link differs, plus any difference in
  landmarks born; kf_lm_m: landmark positions (m) after the keyframe branch
  (the start's stereo bootstrap counts as one);
- ba_pose: the window's poses after `ba_step`, relative to its first
  slot's; ba_lm_m: active landmarks' positions (m) in that slot's frame;
  ba_chi: the reference's robust cost (float64) of the port's window on
  the problem it was handed, relative to the cost of the reference's own
  answer, so a window that BA did not move, or moved the wrong way, reads
  high whatever the port reports of itself.
The limits are the configuration file's ("limits"), set in PERF.md from
the program's readings over many seeds and the control's; a number with
no limit there (ba_pose and ba_lm_m: the control does not separate from
the card's own distance to the CPU) is read, printed by control.py, and
not compared.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np

NAMES = ("track_px", "track_lanes", "pose_T", "pose_lanes", "kf_px", "kf_lanes", "kf_lm_m",
         "ba_pose", "ba_lm_m", "ba_chi")


def _max_gap(a, b, mask) -> float:
    a, b, mask = np.asarray(a, np.float64), np.asarray(b, np.float64), np.asarray(mask, bool)
    if not mask.any():
        return 0.0
    d = np.abs(a[mask] - b[mask])
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max())


def track_gaps(port: Mapping, ref: Mapping) -> Dict[str, float]:
    both = port["valid"] & ref["valid"]
    return {"track_px": _max_gap(port["uv"], ref["uv"], both),
            "track_lanes": float((port["valid"] != ref["valid"]).sum())}


def pose_gaps(T_port, feats_port: Mapping, T_ref, feats_ref: Mapping) -> Dict[str, float]:
    return {"pose_T": _max_gap(T_port, T_ref, np.ones(np.shape(T_ref), bool)),
            "pose_lanes": float((feats_port["lm"] != feats_ref["lm"]).sum())}


def keyframe_gaps(feats_p: Mapping, wmap_p: Mapping, feats_r: Mapping, wmap_r: Mapping) -> Dict[str, float]:
    px = max(_max_gap(feats_p["uv"], feats_r["uv"], feats_p["valid"] & feats_r["valid"]),
             _max_gap(feats_p["uv_r"], feats_r["uv_r"], feats_p["has_right"] & feats_r["has_right"]))
    lanes = sum(float((feats_p[k] != feats_r[k]).sum()) for k in ("valid", "has_right", "lm"))
    lanes += abs(float(wmap_p["lm_next"]) - float(wmap_r["lm_next"]))
    alive = wmap_p["lm_alive"] | wmap_r["lm_alive"]
    return {"kf_px": px, "kf_lanes": lanes, "kf_lm_m": _max_gap(wmap_p["lm_pos"], wmap_r["lm_pos"], alive)}


def _in_anchor(wmap: Mapping, a: int):
    """The window's poses and points seen from window slot `a`: T_i T_a^-1
    and T_a p, which the window's free gauge does not move."""
    T = np.asarray(wmap["kf_pose"], np.float64)
    Ta_inv = np.linalg.inv(T[a])
    p = np.asarray(wmap["lm_pos"], np.float64)
    return T @ Ta_inv, p @ T[a][:3, :3].T + T[a][:3, 3]


def ba_gaps(wmap_p: Mapping, chi_p: float, wmap_r: Mapping, chi_r: float) -> Dict[str, float]:
    """Window BA leaves its gauge free (every window pose moves), so poses
    and points are compared as seen from the window's first valid slot, and
    points only where the reference's map holds them active."""
    kf_valid = np.asarray(wmap_r["kf_valid"], bool)
    chi = abs(chi_p - chi_r) / max(abs(chi_r), 1e-12)
    out = {"ba_chi": float(chi) if np.isfinite(chi) else float("inf")}
    if not kf_valid.any():
        return dict(out, ba_pose=0.0, ba_lm_m=0.0)
    a = int(np.argmax(kf_valid))
    T_p, p_p = _in_anchor(wmap_p, a)
    T_r, p_r = _in_anchor(wmap_r, a)
    active = np.asarray(wmap_r["lm_alive"], bool) & (np.asarray(wmap_r["lm_obs"]) > 0)
    out["ba_pose"] = _max_gap(T_p, T_r, np.broadcast_to(kf_valid[:, None, None], T_r.shape))
    out["ba_lm_m"] = _max_gap(p_p, p_r, np.broadcast_to(active[:, None], p_r.shape))
    return out


def replay(ref, rec: Mapping, frames_l, frames_r, control=None) -> Dict[str, float]:
    """The gaps of one sampled frame (`rec`: `Hooks.record` as NumPy), every
    stage it ran worked out again by `ref` (a
    `portbench.reference.stages.Reference`) from the state the port handed
    that stage; `frames_l`, `frames_r` are the frames as handed over.  With
    `control` (the reference in a lower precision, `reference.lowp`) its
    outputs on the same inputs stand in the port's place."""
    fid = rec["frame_id"]
    st = rec["stages"]
    carry = rec["carry_in"]
    img_l, img_r = frames_l[fid], frames_r[fid]
    gaps: Dict[str, float] = {}

    def theirs(stage, compute):
        return st[stage][2] if control is None else control(compute)

    if "init" in st:
        ok_r, feats_r, wmap_r = ref.init(carry["wmap"], img_l, img_r, fid)
        ok_p, feats_p, wmap_p = theirs("init", lambda r: r.init(carry["wmap"], img_l, img_r, fid))
        gaps.update(keyframe_gaps(feats_p, wmap_p, feats_r, wmap_r))
        if ok_p != ok_r:
            gaps["kf_lanes"] = float("inf")
    if "track" in st:
        args = (carry["feats"], carry["wmap"], carry["T_cur"], carry["rel_motion"], frames_l[fid - 1], img_l)
        ref_t, T_prior = ref.track(*args)
        feats_t = theirs("track", lambda r: r.track(*args)[0])
        gaps.update(track_gaps(feats_t, ref_t))
        # The pose from the tracked features the port handed it.
        feats_in = st["track"][2]
        T_r, feats_pr, _ = ref.pose(feats_in, carry["wmap"], T_prior)
        T_p, feats_pp, _ = theirs("pose", lambda r: r.pose(feats_in, carry["wmap"], T_prior))
        gaps.update(pose_gaps(T_p, feats_pp, T_r, feats_pr))
    if "insert" in st:
        args = st["insert"][0]
        inputs = (args[5], args[6], args[7], img_l, img_r, fid)
        feats_r, wmap_r = ref.insert(*inputs)
        feats_i, wmap_i = theirs("insert", lambda r: r.insert(*inputs))
        gaps.update(keyframe_gaps(feats_i, wmap_i, feats_r, wmap_r))
    if "ba" in st:
        wmap_in = st["ba"][0][2]
        wmap_r, chi_r = ref.ba(wmap_in)
        wmap_b = st["ba"][2][0] if control is None else control(lambda r: r.ba(wmap_in))[0]
        # Each answer judged by the reference's cost on the problem it was given.
        gaps.update(ba_gaps(wmap_b, ref.cost(wmap_in, wmap_b), wmap_r, chi_r))
    return gaps


def worst(per_sample: Iterable[Mapping[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for g in per_sample:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(gaps: Mapping[str, float], limits: Mapping[str, float]) -> (bool, List[dict]):
    """(correct, [{name, value, limit}]) over the numbers that have a limit:
    each at or under it; a number the run did not read is not correct."""
    rows = [{"name": k, "value": gaps.get(k, float("nan")), "limit": v} for k, v in limits.items()]
    ok = bool(rows) and all(r["value"] <= r["limit"] for r in rows)
    return ok, rows
