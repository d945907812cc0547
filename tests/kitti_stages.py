"""One KITTI frame stage by stage, from a carry the JAX reference handed
over: the stage chain both packages run, what is compared at each stage, and
the bars.

    python tests/kitti_stages.py HANDOVER OUT [--device cuda]

`stage_outputs` runs the frontend's functions one by one, as
`process_frame` chains them on a tracking frame: the left and right
pyramids, the constant-velocity prior, tracking (anchored KLT and the ZNCC
gate), the motion-only pose, the keyframe decision and, on a keyframe frame,
eviction, GFTT detection, the anchor templates, scanline stereo,
triangulation, the whole `insert_keyframe`, the BA problem `ba_step` is
handed (`backend.build_problem`) and `ba_step` itself.  With `feed`, every
stage takes its inputs from `feed` (the reference's own chain of the same
frame) instead of from the stage before it, so a gap at a stage is that
stage's own.  `step_outputs` runs whole frames (`process_frame`) from the
carry: one, then five.

The package is an adaptor (`PortOps`, and `RefOps` with each reference
function jitted alone) with the same methods, so both packages run this
one chain.  The adaptors import their package when built, so on a machine
without JAX this module runs the port alone: run as a script it reads a
handover written by `python -m tests.ba_parity_report --kitti-stages
SEQ START END --handover FILE` (the reference's carries, frames and chains)
and writes the port's outputs for each carry on `--device` (the card's
column of that report).
"""

from __future__ import annotations

import argparse
import itertools
from typing import Any, Dict

import numpy as np

LEVELS = 4  # klt_pyramid_levels of the default config (the pyramid both packages build)
EVICTED = ("lm_obs", "kf_valid", "kf_id", "kf_frame_id", "kf_obs_left", "kf_obs_right", "kf_lm")

# Each compared quantity and the bar of the unit parity test that holds its
# stage, used where the reference's settings agree exactly (zero spread):
# tests/test_torch_klt.py (5e-2 px, 95% of the masks), test_torch_pose.py
# (1e-3 in T, 98% of the inliers, max(3, 2%) in the count),
# test_torch_ops.py (GFTT: the same corners; stereo: 2e-2 px, 97%;
# anchors 1e-3), test_torch_geometry.py (the triangulation mask exactly),
# test_torch_backend.py (the BA problem exactly; chi 1e-3 relative, the
# window 1e-3).  Mask bars count lanes of 512.
UNIT_BARS = {
    "pyramid (grey level)": 1e-3,
    "prior T (entry)": 1e-5,
    "tracking uv (px)": 5e-2,
    "tracking mask (lanes)": 0.05 * 512,
    "pose T (entry)": 1e-3,
    "pose inliers (lanes)": 0.02 * 512,
    "pose n_in": 3,
    "keyframe decision": 0,
    "evict (entries)": 0,
    "detect corners (lanes)": 0,
    "detect uv (px)": 0,
    "anchors (grey level)": 1e-3,
    "stereo uv_r (px)": 2e-2,
    "stereo matches (lanes)": 0.03 * 512,
    "triangulate born (lanes)": 0,
    "triangulate points (m)": 1e-3,
    "insert landmarks (count)": 0,
    "ba problem edges": 0,
    "ba problem uv (px)": 0,
    "ba problem slots": 0,
    "ba chi (relative)": 1e-3,
    "ba window (relative poses)": 1e-3,
    "ba points (m)": 1e-3,
    "one step position (m)": 1e-3,
    "one step status/kf": 0,
    "five steps position (m)": 1e-3,
    "five steps status/kf": 0,
}
ONE_STEP = ("one step position (m)", "one step status/kf")
FIVE_STEPS = ("five steps position (m)", "five steps status/kf")
# `ba_step` on the map the keyframe hands it: printed, but no stage of the
# frontend, and held on the KITTI soak's own map by
# tests/test_torch_backend.py::test_kitti_window_ba_matches_reference.
BA_SOLVE = ("ba chi (relative)", "ba window (relative poses)", "ba points (m)")


def flat(d, prefix=""):
    """A nested dict of arrays as one level, keys joined by "/" (for npz)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, (list, tuple)):
            out.update({f"{prefix}{k}/{i}": np.asarray(x) for i, x in enumerate(v)})
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(d, prefix=""):
    """`flat`'s inverse for the keys under `prefix`; a level whose keys are
    0..n-1 becomes a list (the carry's pyramid)."""
    out: Dict[str, Any] = {}
    for key, v in d.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(out)


def sub(d: dict, prefix: str) -> dict:
    """The entries of `d` under `prefix`, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def insert_rule(cfg, n_in: int, frames_since_kf: int) -> bool:
    """process_frame's keyframe decision (both packages)."""
    return bool((n_in < cfg.num_features_needed_for_keyframe or frames_since_kf + 1 >= cfg.max_keyframe_gap)
                and n_in >= cfg.num_features_tracking_bad)


def stage_outputs(ops, carry: dict, img_l, img_r, frame_id: int, feed: dict = None, solve: bool = True) -> dict:
    """The frame's stage chain from `carry` (NumPy, the reference's field
    layout) through `ops`; each stage's outputs as NumPy under "stage/name".
    With `feed`, each stage reads its inputs from `feed` (a chain of the same
    frame) instead of from this one.  `solve=False` leaves out the whole
    `insert_keyframe` and `ba_step` (the feed must then hold the map the
    keyframe hands BA, "wmapk/...")."""
    out: Dict[str, np.ndarray] = {}
    src = out if feed is None else feed
    dev, npy = ops.dev, ops.np

    def pyr(name):
        return tuple(dev(src[f"{name}/{i}"]) for i in range(LEVELS))

    for name, img in (("pyr_l", img_l), ("pyr_r", img_r)):
        out.update({f"{name}/{i}": npy(p) for i, p in enumerate(ops.pyramid(dev(img)))})
    wmap = ops.wmap(carry["wmap"])
    initing = int(carry["status"]) == 0
    if initing:  # the init branch: stereo_init on the empty table, at the identity
        out["kf/insert"] = np.asarray(True)
        f_pose, T_np = carry["feats"], np.eye(4, dtype=np.float32)
    else:
        out["prior/T"] = npy(ops.prior(dev(carry["rel_motion"]), dev(carry["T_cur"])))
        tracked = ops.track(tuple(dev(p) for p in carry["pyr_last"]), pyr("pyr_l"), ops.feats(carry["feats"]),
                            wmap.lm_pos, dev(src["prior/T"]), dev(carry["rel_motion"]))
        out["track/uv"], out["track/valid"] = npy(tracked.uv), npy(tracked.valid)
        f_track = {**carry["feats"], "uv": src["track/uv"], "valid": src["track/valid"],
                   "uv_r": np.zeros_like(carry["feats"]["uv"]), "has_right": np.zeros_like(carry["feats"]["has_right"])}
        T, f_pose, n_in = ops.pose(ops.feats(f_track), wmap.lm_pos, dev(src["prior/T"]))
        out["pose/T"], out["pose/lm"], out["pose/n_in"] = npy(T), npy(f_pose.lm), npy(n_in)
        out["kf/insert"] = np.asarray(insert_rule(ops.cfg, int(out["pose/n_in"]), int(carry["frames_since_kf"])))
        if not bool(src["kf/insert"]):
            return out
        f_pose, T_np = {**f_track, "lm": src["pose/lm"]}, src["pose/T"]
    zeros = np.zeros_like(carry["feats"]["uv"])
    T = dev(T_np)
    w_e = ops.evict(wmap, T)
    out.update({f"evict/{k}": npy(getattr(w_e, k)) for k in EVICTED})
    f_det = ops.detect(dev(img_l), ops.feats(f_pose))
    out.update({f"detect/{k}": npy(getattr(f_det, k)) for k in ("uv", "valid", "lm")})
    out["anchors/anchor"] = npy(ops.anchors(pyr("pyr_l"), dev(src["detect/uv"])))
    f_det = {**f_pose, **{k: src[f"detect/{k}"] for k in ("uv", "valid", "lm")}, "uv_r": zeros,
             "has_right": np.zeros_like(f_pose["has_right"]), "anchor": src["anchors/anchor"],
             "anchor_uv": src["detect/uv"]}
    f_st = ops.stereo(pyr("pyr_l"), pyr("pyr_r"), ops.feats(f_det), wmap.lm_pos, T)
    out["stereo/uv_r"], out["stereo/has_right"] = npy(f_st.uv_r), npy(f_st.has_right)
    f_st = {**f_det, "uv_r": src["stereo/uv_r"], "has_right": src["stereo/has_right"]}
    w_e = ops.wmap({**carry["wmap"], **{k: src[f"evict/{k}"] for k in EVICTED}})
    f_tri, w_tri, born = ops.triangulate(ops.feats(f_st), w_e, T)
    lo, hi = int(carry["wmap"]["lm_next"]), int(npy(w_tri.lm_next))
    out["tri/born"], out["tri/lm"], out["tri/lm_next"] = npy(born), npy(f_tri.lm), np.asarray(hi)
    out["tri/lm_pos"] = npy(w_tri.lm_pos)[lo:hi]
    if solve:
        if initing:
            _, f_ins, w_ins = ops.init(pyr("pyr_l"), pyr("pyr_r"), dev(img_l), wmap, frame_id)
        else:
            f_ins, w_ins = ops.insert(pyr("pyr_l"), pyr("pyr_r"), dev(img_l), ops.feats(f_pose), wmap, T, frame_id)
        # the whole map but the prior's state (off on this path, so unchanged)
        out.update({f"wmapk/{k}": npy(getattr(w_ins, k)) for k in ops.WMAP_FIELDS if k != "marg"})
        out["insert/lm"], out["insert/valid"] = npy(f_ins.lm), npy(f_ins.valid)
    w_k = ops.wmap({**carry["wmap"], **sub(src, "wmapk/")})
    prob = ops.problem(w_k)
    g = prob.graph
    out.update({f"problem/{k}": npy(getattr(g, k)) for k in ("e_pose", "e_point", "e_cam", "e_uv", "e_valid")})
    out["problem/active_ids"] = npy(prob.active_ids)
    if not solve:
        return out
    w_ba, stats = ops.ba(w_k)
    out["ba/chi"], out["ba/iterations"] = npy(stats.chi), npy(stats.iterations)
    out.update({f"ba/{k}": npy(getattr(w_ba, k)) for k in ("kf_pose", "kf_valid", "kf_id")})
    ids = out["problem/active_ids"]
    out["ba/points"] = npy(w_ba.lm_pos)[ids[ids >= 0]]  # the window's landmarks after the solve
    return out


def step_outputs(ops, carry: dict, frames, frame_id: int, n: int) -> dict:
    """`process_frame` over `n` frames from `carry` (frames[i] = (left,
    right) of frame frame_id + i): poses, statuses, keyframe flags, BA chi."""
    c = ops.carry(carry)
    T, st, kf, chi = [], [], [], []
    for i in range(n):
        left, right = frames[i]
        c, o = ops.step(c, ops.dev(left), ops.dev(right), frame_id + i)
        T.append(ops.np(o.T_cw))
        st.append(int(ops.np(o.status)))
        kf.append(bool(ops.np(o.kf_inserted)))
        chi.append(float(ops.np(o.ba_chi)))
    return {"T_cw": np.stack(T), "status": np.asarray(st), "kf": np.asarray(kf), "chi": np.asarray(chi)}


def centres(T_cw):
    T = np.asarray(T_cw, np.float64)
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def _lanes(a, b) -> float:
    return float((np.asarray(a) != np.asarray(b)).sum())


def _on(a, b, mask) -> float:
    mask = np.asarray(mask, bool)
    if not mask.any():
        return 0.0
    return float(np.abs(np.asarray(a, np.float64)[mask] - np.asarray(b, np.float64)[mask]).max())


def _relative_window(d):
    valid = np.asarray(d["ba/kf_valid"], bool)
    oldest = int(np.argmin(np.where(valid, d["ba/kf_id"], np.iinfo(np.int32).max)))
    T = np.asarray(d["ba/kf_pose"], np.float64)
    return (T @ np.linalg.inv(T[oldest]))[valid]


def stage_gaps(a: dict, b: dict) -> Dict[str, float]:
    """What differs between two chains of one frame (`stage_outputs`), one
    number per quantity of UNIT_BARS; a keyframe frame's quantities only
    where both chains hold them."""
    g = {"pyramid (grey level)": max(_on(a[f"{s}/{i}"], b[f"{s}/{i}"], np.ones_like(a[f"{s}/{i}"], bool))
                                     for s in ("pyr_l", "pyr_r") for i in range(LEVELS))}
    if "track/uv" in a:  # not on the init frame
        g["prior T (entry)"] = _on(a["prior/T"], b["prior/T"], np.ones((4, 4), bool))
        both = a["track/valid"] & b["track/valid"]
        g["tracking uv (px)"] = _on(a["track/uv"], b["track/uv"], both)
        g["tracking mask (lanes)"] = _lanes(a["track/valid"], b["track/valid"])
        g["pose T (entry)"] = _on(a["pose/T"], b["pose/T"], np.ones((4, 4), bool))
        g["pose inliers (lanes)"] = _lanes(a["pose/lm"] >= 0, b["pose/lm"] >= 0)
        g["pose n_in"] = abs(float(a["pose/n_in"]) - float(b["pose/n_in"]))
    g["keyframe decision"] = float(bool(a["kf/insert"]) != bool(b["kf/insert"]))
    if "detect/uv" not in a or "detect/uv" not in b:
        return g
    g["evict (entries)"] = sum(_lanes(a[f"evict/{k}"], b[f"evict/{k}"]) for k in EVICTED)
    g["detect corners (lanes)"] = _lanes(a["detect/valid"], b["detect/valid"])
    both = a["detect/valid"] & b["detect/valid"]
    g["detect uv (px)"] = _on(a["detect/uv"], b["detect/uv"], both)
    g["anchors (grey level)"] = _on(a["anchors/anchor"], b["anchors/anchor"], both)
    both = a["stereo/has_right"] & b["stereo/has_right"]
    g["stereo uv_r (px)"] = _on(a["stereo/uv_r"], b["stereo/uv_r"], both)
    g["stereo matches (lanes)"] = _lanes(a["stereo/has_right"], b["stereo/has_right"])
    g["triangulate born (lanes)"] = _lanes(a["tri/born"], b["tri/born"])
    both = a["tri/born"] & b["tri/born"]
    lo = [int(d["tri/lm_next"]) - len(d["tri/lm_pos"]) for d in (a, b)]
    pa, pb = (d["tri/lm_pos"][np.maximum(d["tri/lm"] - o, 0)] if len(d["tri/lm_pos"])
              else np.zeros((len(d["tri/lm"]), 3))
              for d, o in ((a, lo[0]), (b, lo[1])))
    g["triangulate points (m)"] = _on(pa, pb, both[:, None] & np.ones((1, 3), bool))
    if "insert/lm" in a and "insert/lm" in b:
        g["insert landmarks (count)"] = abs(float(a["wmapk/lm_next"]) - float(b["wmapk/lm_next"]))
    keys = ("e_pose", "e_point", "e_cam", "e_valid")
    same = np.all([np.asarray(a[f"problem/{k}"]) == np.asarray(b[f"problem/{k}"]) for k in keys], axis=0)
    g["ba problem edges"] = float((~same).sum())
    g["ba problem uv (px)"] = _on(a["problem/e_uv"], b["problem/e_uv"], (same & a["problem/e_valid"])[:, None]
                                  & np.ones((1, 2), bool))
    g["ba problem slots"] = _lanes(a["problem/active_ids"], b["problem/active_ids"])
    if "ba/chi" not in a or "ba/chi" not in b:
        return g
    g["ba chi (relative)"] = abs(float(a["ba/chi"]) - float(b["ba/chi"])) / abs(float(b["ba/chi"]))
    g["ba window (relative poses)"] = float(np.abs(_relative_window(a) - _relative_window(b)).max())
    if np.array_equal(a["problem/active_ids"], b["problem/active_ids"]):
        g["ba points (m)"] = _on(a["ba/points"], b["ba/points"], np.ones_like(a["ba/points"], bool))
    return g


def step_gaps(a: dict, b: dict) -> Dict[str, float]:
    """Whole-frame steps (`step_outputs`) apart: camera positions, and
    frames whose status or keyframe flag differ; the first frame alone
    under ONE_STEP, all under FIVE_STEPS."""
    d = np.linalg.norm(centres(a["T_cw"]) - centres(b["T_cw"]), axis=-1)
    flags = (a["status"] != b["status"]) | (a["kf"] != b["kf"])
    return {ONE_STEP[0]: float(d[0]), ONE_STEP[1]: float(flags[0]),
            FIVE_STEPS[0]: float(d.max()), FIVE_STEPS[1]: float(flags.sum())}


def spread(gaps_fn, chains) -> Dict[str, float]:
    """The largest gap of each quantity between two of the reference's
    settings (`chains`: by setting)."""
    out: Dict[str, float] = {}
    for x, y in itertools.combinations(sorted(chains), 2):
        for k, v in gaps_fn(chains[x], chains[y]).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def bar(quantity: str, ref_spread: float) -> float:
    """Twice the settings' spread, or the unit bar where they agree exactly."""
    return 2.0 * ref_spread if ref_spread > 0 else UNIT_BARS[quantity]


class PortOps:
    """The port's side of the chain, on `device`."""

    def __init__(self, cfg, rig, ba_cfg, device="cpu"):
        import torch

        from legoslam_tpu_torch.ops import klt as klt_ops
        from legoslam_tpu_torch.ops import pyramid as pyr_ops
        from legoslam_tpu_torch.pipeline import backend, frontend, state
        from legoslam_tpu_torch.pipeline import visual_odometry as vo
        from legoslam_tpu_torch.pipeline.state import WorldMap

        self.torch, self.state = torch, state
        self.cfg, self.device = cfg, torch.device(device)
        rig = rig.to(self.device)
        self.WMAP_FIELDS = [f for f in WorldMap.__dataclass_fields__]
        self.pyramid = lambda img: tuple(pyr_ops.build_pyramid(img, cfg.klt.levels))
        self.prior = vo.constant_velocity_prior
        self.track = lambda pl, p, f, lm_pos, T, rel: frontend.track_last_frame(cfg, rig, pl, p, f, lm_pos, T,
                                                                                 rel_motion=rel)
        self.pose = lambda f, lm_pos, T: frontend.estimate_current_pose(cfg, rig, f, lm_pos, T)
        self.evict = lambda w, T: frontend._evict_if_full(cfg, w, T)
        self.detect = lambda img, f: frontend.detect_features(cfg, img, f)
        self.anchors = lambda p, uv: klt_ops.extract_anchors(p, uv.contiguous(), cfg.klt)
        self.stereo = lambda pl, pr, f, lm_pos, T: frontend.find_features_in_right(cfg, rig, pl, pr, f, lm_pos, T)
        self.triangulate = lambda f, w, T: frontend.triangulate_new_points(cfg, rig, f, w, T)
        self.insert = lambda pl, pr, img, f, w, T, fid: frontend.insert_keyframe(cfg, rig, pl, pr, img, f, w, T,
                                                                                 int(fid))
        self.init = lambda pl, pr, img, w, fid: frontend.stereo_init(cfg, rig, pl, pr, img, w, int(fid))
        self.problem = lambda w: backend.build_problem(cfg, rig, w)[0]
        self.ba = lambda w: backend.ba_step(cfg, rig, w, ba_cfg)
        self.step = lambda c, left, right, fid: vo.process_frame(cfg, rig, c, left, right, int(fid), ba_cfg)

    def dev(self, a):
        a = np.asarray(a)
        a = a.astype(np.float32) if a.dtype in (np.float64, np.uint8) else a
        return self.torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(self.device)

    def np(self, x):
        return x.detach().cpu().numpy() if isinstance(x, self.torch.Tensor) else np.asarray(x)

    def feats(self, d):
        return self.state.features_from_numpy(d, self.device)

    def wmap(self, d):
        return self.state.worldmap_from_numpy(d, self.device)

    def carry(self, d):
        return self.state.carry_from_numpy(d, self.device)


class RefOps:
    """tests/kitti_stages.py's adaptor for the reference: each frontend
    function jitted alone on the KITTI command's config (`config`: keys over
    the defaults) for a sequence with projections P0, P1, and the
    whole-frame step its VisualOdometry runs."""

    def __init__(self, config: dict, P0, P1):
        import jax
        import jax.numpy as jnp

        from legoslam_tpu.geometry import se3 as j_se3
        from legoslam_tpu.pipeline import backend as j_backend
        from legoslam_tpu.geometry.camera import StereoRig as JStereoRig
        from legoslam_tpu.ops import klt as j_klt
        from legoslam_tpu.ops import pyramid as j_pyr
        from legoslam_tpu.pipeline import frontend as j_frontend
        from legoslam_tpu.pipeline import state as j_state
        from legoslam_tpu.pipeline import visual_odometry as j_vo
        from legoslam_tpu.utils.config import Config as JConfig

        self.jnp, self.j_state, self.j_vo = jnp, j_state, j_vo
        conf = JConfig(config)
        rig = JStereoRig.from_kitti_projections(P0, P1, scale=conf["image_scale"])

        class _Rig:  # what VisualOdometry.init reads of a dataset
            def init(self):
                return True

        source = _Rig()
        source.rig = rig
        vo = j_vo.VisualOdometry(config=conf, dataset=source)
        assert vo.init()
        self.vo = vo
        cfg = self.cfg = vo.frontend_cfg
        ba_cfg = j_backend.BAConfig(  # as VisualOdometry.init builds it
            iterations=conf["ba_solver_iterations"], chi2_threshold=conf["chi2_threshold"],
            max_chi2_doublings=conf["ba_max_chi2_doublings"], inlier_ratio=conf["ba_inlier_ratio"],
            strategy=conf["lm_strategy"], linear_solver=conf["linear_solver"], engine=conf["lm_engine"],
            trace=bool(conf["ba_trace"]), assembly_precision=str(conf["ba_assembly_precision"]))
        self.WMAP_FIELDS = j_state.WorldMap._fields
        J = jax.jit
        self.pyramid = J(lambda img: tuple(j_pyr.build_pyramid(img, cfg.klt.levels)))
        self.prior = J(lambda rel, T: j_se3.se3_orthonormalize(rel @ T))
        self.track = J(lambda pl, p, f, lm_pos, T, rel: j_frontend.track_last_frame(cfg, rig, pl, p, f, lm_pos, T,
                                                                                     rel_motion=rel))
        self.pose = J(lambda f, lm_pos, T: j_frontend.estimate_current_pose(cfg, rig, f, lm_pos, T))
        self.evict = J(lambda w, T: j_frontend._evict_if_full(cfg, w, T))
        self.detect = J(lambda img, f: j_frontend.detect_features(cfg, img, f))
        self.anchors = J(lambda p, uv: j_klt.extract_anchors(p, uv, cfg.klt))
        self.stereo = J(lambda pl, pr, f, lm_pos, T: j_frontend.find_features_in_right(cfg, rig, pl, pr, f, lm_pos, T))
        self.triangulate = J(lambda f, w, T: j_frontend.triangulate_new_points(cfg, rig, f, w, T))
        insert = J(lambda pl, pr, img, f, w, T, fid: j_frontend.insert_keyframe(cfg, rig, pl, pr, img, f, w, T, fid))
        self.insert = lambda pl, pr, img, f, w, T, fid: insert(pl, pr, img, f, w, T, jnp.asarray(fid, jnp.int32))
        init = J(lambda pl, pr, img, w, fid: j_frontend.stereo_init(cfg, rig, pl, pr, img, w, fid))
        self.init = lambda pl, pr, img, w, fid: init(pl, pr, img, w, jnp.asarray(fid, jnp.int32))
        self.problem = J(lambda w: j_backend.build_problem(cfg, rig, w)[0])
        self.ba = J(lambda w: j_backend.ba_step(cfg, rig, w, ba_cfg))
        self.step = lambda c, left, right, fid: vo._step_fn(c, left, right, jnp.asarray(fid, jnp.int32))

    def dev(self, a):
        a = np.asarray(a)
        return self.jnp.asarray(a.astype(np.float32) if a.dtype in (np.float64, np.uint8) else a)

    def np(self, x):
        return np.asarray(x)

    def feats(self, d):
        return self.j_state.Features(**{k: self.jnp.asarray(v) for k, v in d.items()})

    def wmap(self, d):
        st = self.j_state
        return st.WorldMap(**{k: st.MargState(**{m: self.jnp.asarray(x) for m, x in v.items()}) if k == "marg"
                              else self.jnp.asarray(v) for k, v in d.items()})

    def carry(self, d):
        return self.j_vo.VOCarry(
            status=self.jnp.asarray(d["status"]), feats=self.feats(d["feats"]), wmap=self.wmap(d["wmap"]),
            T_cur=self.jnp.asarray(d["T_cur"]), rel_motion=self.jnp.asarray(d["rel_motion"]),
            pyr_last=tuple(self.jnp.asarray(p) for p in d["pyr_last"]),
            frames_since_kf=self.jnp.asarray(d["frames_since_kf"]))


def port_ops(config: dict, P0, P1, device="cpu") -> PortOps:
    """`PortOps` for the KITTI command's config (`config`: keys over the
    defaults) on a sequence with projections P0, P1 (read at half
    resolution, as the command reads it)."""
    from legoslam_tpu_torch.geometry.camera import StereoRig
    from legoslam_tpu_torch.pipeline import backend, frontend
    from legoslam_tpu_torch.utils.config import Config

    conf = Config(config)
    ba_cfg = backend.BAConfig(
        iterations=conf["ba_solver_iterations"], chi2_threshold=conf["chi2_threshold"],
        max_chi2_doublings=conf["ba_max_chi2_doublings"], inlier_ratio=conf["ba_inlier_ratio"],
        strategy=conf["lm_strategy"], linear_solver=conf["linear_solver"], engine=conf["lm_engine"],
        trace=bool(conf["ba_trace"]), assembly_precision=str(conf["ba_assembly_precision"]))
    rig = StereoRig.from_kitti_projections(P0, P1, scale=conf["image_scale"])
    return PortOps(frontend.FrontendConfig.from_config(conf), rig, ba_cfg, device)


# tests/data/kitti_soak_stages_f5.npz's stages and what each compares
# (tests/test_torch_kitti_stages.py and chip_smoke.py step 16).
FIXTURE_SETTINGS = ("unset", "AVX2", "SSE4_2")
FIXTURE_STAGES = {
    "pyramid": ("pyramid (grey level)",),
    "tracking": ("prior T (entry)", "tracking uv (px)", "tracking mask (lanes)"),
    "pose": ("pose T (entry)", "pose inliers (lanes)", "pose n_in"),
    "keyframe": ("keyframe decision", "evict (entries)"),
    "detect": ("detect corners (lanes)", "detect uv (px)", "anchors (grey level)"),
    "stereo": ("stereo uv_r (px)", "stereo matches (lanes)"),
    "triangulate": ("triangulate born (lanes)", "triangulate points (m)"),
    "ba problem": ("ba problem edges", "ba problem uv (px)", "ba problem slots"),
}


def _digest(pyr) -> str:
    import hashlib

    return hashlib.sha1(np.concatenate([np.ravel(p) for p in pyr]).tobytes()).hexdigest()


def load_stage_fixture(path, device="cpu") -> dict:
    """A fixture written by `write_stage_fixture`, with what it leaves out
    rebuilt by the port on `device`: the carry's anchors (from the last
    keyframe's left image), the frame's pyramids and anchors (bit for bit
    the reference's, as `write_stage_fixture` checked; `pyr_digest` holds
    the rebuilt pyramids' digests).  Returns the file (`d`), the port's
    adaptor (`ops`), the carry, the stages' inputs (`feed`) and each
    setting's stage and step outputs (`settings`)."""
    from legoslam_tpu_torch.ops import klt, pyramid

    d = dict(np.load(path))
    ops = port_ops({}, d["P0"], d["P1"], device)
    carry = unflat(d, "carry/")
    kf_pyr = tuple(pyramid.build_pyramid(ops.dev(d["kf_left"]), LEVELS))
    carry["feats"]["anchor"] = ops.np(klt.extract_anchors(kf_pyr, ops.dev(carry["feats"]["anchor_uv"]), ops.cfg.klt))
    feed = sub(d, "feed/")
    pyrs = {}
    for name in ("pyr_l", "pyr_r"):
        pyrs[name] = [ops.np(p) for p in pyramid.build_pyramid(ops.dev(d["left" if name == "pyr_l" else "right"]),
                                                               LEVELS)]
        feed.update({f"{name}/{i}": p for i, p in enumerate(pyrs[name])})
    pyr_l = tuple(ops.dev(p) for p in pyrs["pyr_l"])
    feed["anchors/anchor"] = ops.np(klt.extract_anchors(pyr_l, ops.dev(feed["detect/uv"]), ops.cfg.klt))
    settings = {}
    for name in FIXTURE_SETTINGS:
        out = {**sub(d, "all/"), **sub(d, f"{name}/")}
        # the rebuilt pyramids and anchors stand in for the stored ones
        settings[name] = {"stages": {**sub(out, "stages/"), **{k: v for k, v in feed.items()
                                                                if k.startswith(("pyr_", "anchors/"))}},
                          "steps": sub(out, "steps/")}
    return {"d": d, "ops": ops, "carry": carry, "feed": feed, "settings": settings, "h": int(d["h"]),
            "pyr_digest": {name: _digest(p) for name, p in pyrs.items()}}


def run_stage_fixture(fx: dict) -> dict:
    """The port on a loaded fixture: the stages fed the reference's inputs
    (no `insert_keyframe`, no `ba_step`), and one whole frame from the carry."""
    ops, d = fx["ops"], fx["d"]
    stages = stage_outputs(ops, fx["carry"], d["left"], d["right"], fx["h"], feed=fx["feed"], solve=False)
    steps = step_outputs(ops, fx["carry"], [(d["left"], d["right"])], fx["h"], 1)
    return {"stages": stages, "steps": steps}


def fixture_gaps(a: dict, b: dict) -> Dict[str, float]:
    """Stage and one-step gaps between two `run_stage_fixture` results (or
    a setting's outputs)."""
    return {**stage_gaps(a["stages"], b["stages"]), **step_gaps(a["steps"], b["steps"])}


def fixture_spread(settings: dict) -> Dict[str, float]:
    """The settings' spread of every quantity `fixture_gaps` compares."""
    return {**spread(stage_gaps, {n: settings[n]["stages"] for n in FIXTURE_SETTINGS}),
            **spread(step_gaps, {n: settings[n]["steps"] for n in FIXTURE_SETTINGS})}


def run_handover(d: dict, ops, steps: int) -> dict:
    """The port's outputs on every carry of a handover file `d` (as
    `--kitti-stages --handover` writes it): stages fed by the reference's
    chain, and `steps` whole frames."""
    out = {}
    for h in np.asarray(d["handovers"]).tolist():
        carry = unflat(d, f"carry{h}/")
        frames = [(d[f"frame{k}/left"], d[f"frame{k}/right"]) for k in range(h, h + steps)]
        out.update(flat(stage_outputs(ops, carry, *frames[0], h, feed=sub(d, f"ref{h}/")), f"stages{h}/"))
        out.update(flat(step_outputs(ops, carry, frames, h, steps), f"steps{h}/"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("handover", help="the file --kitti-stages --handover wrote")
    ap.add_argument("out", help="where the port's outputs go (npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    d = dict(np.load(args.handover))
    ops = port_ops({}, d["P0"], d["P1"], args.device)
    np.savez_compressed(args.out, **run_handover(d, ops, int(d["steps"])))
    print(f"kitti stages: the port on {args.device}, handovers {np.asarray(d['handovers']).tolist()}: wrote {args.out}")


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo, for the port
    main()
