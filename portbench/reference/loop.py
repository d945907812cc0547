"""The loop closer's plain reference: place recognition, geometric
verification, the keyframe pose graph and the world correction of the
port's loop closer (legoslam_tpu_torch/pipeline/loop_closure.py and
solver/pose_graph_host.py), written again from the equations their
docstrings give, in plain PyTorch.  It imports nothing of the port.

Precisions are the port's: records and the pose graph are float64 on the
host; verification is float32, through this folder's frozen plain KLT
(klt.py, frame mode) and plain pose (lm.py, the verification rounds), so
on the same inputs it gives the port's kernels' bits.  TF32 is off.

- thumbnail: a (12, 20) block mean, twice a [1, 2, 1]/4 low-pass along
  rows then columns (edges repeated), zero mean, unit norm;
- detect: the newest thumbnail's ZNCC with every record at least
  `min_gap` older, the best `max_candidates` that reach `zncc_min`;
- verify: KLT of the candidate's stored features into the new keyframe's
  half-resolution image and back (forward-backward gate), 4 rounds of the
  pose solve from the candidate's insertion-time pose, accept on inliers;
  the measurement M = T_loop T_j,obs^-1, averaged on SE(3) with the
  reverse measurement where that one has the inliers too; then the
  odometry-consistency gate (floor + frac x the path between the two);
- solve_chain_graph: Gauss-Newton over the chain's odometry edges and the
  loop edges, residual r = Log(M^-1 T_i T_j^-1), J_i = Ad(M^-1), J_j = -I,
  pose 0 held (an identity block), a 1e-9 ridge, from the odometry
  integration; one pass that drops loop edges whose translation residual
  exceeds 0.5 m (unless every one would go) and solves again;
- the chi gates: the newest edge survived and chi1 <= ratio chi0 + 0.01;
- the correction G = T'_last^-1 T_last (map points p' = G p).

Departures from the port (each the same answer up to rounding):
- thumbnails are computed in float64 (the port: float32 NumPy), and
  candidates ranked by float64 scores with a stable sort;
- the pose graph's normal equations are assembled densely over all
  records at once and solved by a dense LU (`torch.linalg.solve`); the
  port adds H's blocks edge by edge into a sparse matrix that SciPy
  factors;
- SE(3) log and exp are batched over edges in float64 torch, their small
  angle branches picked by `torch.where` where the port branches per edge
  in NumPy; the host's 4x4 algebra is torch float64 (the port: NumPy);
- `solve_chain_graph(dtype=torch.float32)` is the same solve one precision
  down, the control of the benchmark's limits.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import klt, lm, pyramid, reprojection, se3
from portbench.reference.camera import StereoRig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

THUMB = (12, 20)
F64 = torch.float64

# LoopConfig's defaults (pipeline/loop_closure.py); the configuration's
# loop_* keys set four of them (`loop_config`).
DEFAULTS = {"zncc_min": 0.5, "max_candidates": 3, "min_gap": 10, "min_inliers": 25, "consistency_floor": 0.5,
            "consistency_frac": 0.05, "pg_accept_chi_ratio": 0.5, "cooldown_keyframes": 2, "chi2_threshold": 5.991,
            "odom_weight": 1.0, "loop_weight": 20.0, "klt_levels": 3, "fb_threshold": 0.8, "max_feats": 256,
            "pg_iterations": 4, "outlier_residual": 0.5}


def loop_config(settings: Mapping) -> Dict:
    """The closer's settings from a configuration's settings table."""
    return dict(DEFAULTS, zncc_min=float(settings["loop_zncc_min"]), min_gap=int(settings["loop_min_gap"]),
                min_inliers=int(settings["loop_min_inliers"]), loop_weight=float(settings["loop_edge_weight"]))


def intrinsics(camera: Mapping) -> reprojection.Intrinsics:
    """The verifier's camera, from the configuration's camera table: the
    left camera at `image_scale`, halved (records hold half-resolution
    images)."""
    rig = StereoRig.from_kitti_projections(np.asarray(camera["P0"]).reshape(3, 4),
                                           np.asarray(camera["P1"]).reshape(3, 4), scale=float(camera["image_scale"]))
    c = rig.left
    return reprojection.Intrinsics(c.fx * 0.5, c.fy * 0.5, c.cx * 0.5, c.cy * 0.5)


def _t(x, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(dtype)


# --- place recognition ---------------------------------------------------------------

def thumbnail(img) -> torch.Tensor:
    """(12, 20) float64, zero mean and unit norm (all zeros for a flat image)."""
    t = _t(img)
    H, W = t.shape
    th, tw = THUMB
    ys, xs = (H // th) * th, (W // tw) * tw
    t = t[:ys, :xs].reshape(th, ys // th, tw, xs // tw).mean(dim=(1, 3))
    for _ in range(2):
        p = torch.cat([t[:1], t, t[-1:]], 0)
        t = p[:-2] * 0.25 + p[1:-1] * 0.5 + p[2:] * 0.25
        p = torch.cat([t[:, :1], t, t[:, -1:]], 1)
        t = p[:, :-2] * 0.25 + p[:, 1:-1] * 0.5 + p[:, 2:] * 0.25
    t = t - t.mean()
    n = torch.linalg.vector_norm(t)
    return t / n if n > 1e-6 else t


def detect(thumbs: Sequence[torch.Tensor], cfg: Mapping) -> List[int]:
    """Candidates for the newest of `thumbs`, best first."""
    n = len(thumbs)
    if n - 1 - cfg["min_gap"] < 0:
        return []
    cur = thumbs[-1].reshape(-1)
    scores = torch.stack([t.reshape(-1) for t in thumbs[: n - cfg["min_gap"]]]) @ cur
    order = torch.argsort(-scores, stable=True)[: cfg["max_candidates"]]
    return [int(j) for j in order if scores[j] >= cfg["zncc_min"]]


# --- verification --------------------------------------------------------------------

def _pyramid(img, levels: int):
    return tuple(pyramid.build_pyramid(torch.as_tensor(np.asarray(img)).to(torch.float32), levels))


def _measure(pyr_from, pyr_to, rec: Mapping, intr, cfg: Mapping) -> Tuple[torch.Tensor, int]:
    """The pose of the image `pyr_to` in the epoch of `rec`'s landmarks,
    from `rec`'s features tracked there and back, and its inliers."""
    M = cfg["max_feats"]
    valid = torch.arange(M) < int(rec["n_feats"])
    uv_j = torch.as_tensor(np.asarray(rec["uv"], np.float32))
    kcfg = klt.KLTConfig(levels=cfg["klt_levels"])
    uv_i, conv = klt.klt_pyramid(pyr_from, pyr_to, uv_j, uv_j, valid, kcfg)
    uv_b, conv_b = klt.klt_pyramid(pyr_to, pyr_from, uv_i, uv_i, valid, kcfg)
    ok = valid & conv & conv_b & (torch.linalg.vector_norm(uv_b - uv_j, dim=-1) < cfg["fb_threshold"])
    T, _, n_in = lm.estimate_pose(intr, _t(rec["T_cw_obs"], torch.float32), torch.as_tensor(
        np.asarray(rec["p_world"], np.float32)), uv_i.contiguous(), ok, chi2_th=cfg["chi2_threshold"],
        outer_iterations=4, drop_kernel_after=3, cfg=lm.LMConfig(iterations=10), verification=True)
    return T.to(F64), int(n_in)


def verify(rec_i: Mapping, rec_j: Mapping, path_T_cw, intr, cfg: Mapping) -> Tuple[bool, torch.Tensor, int]:
    """(accepted, M_ij (4, 4) float64, inliers) for the new keyframe's
    record `rec_i` against the candidate `rec_j`; `path_T_cw` holds the
    current poses of the records from j to i, in order."""
    pyr_j, pyr_i = _pyramid(rec_j["img"], cfg["klt_levels"]), _pyramid(rec_i["img"], cfg["klt_levels"])
    eye = torch.eye(4, dtype=F64)
    T_loop, n_in = _measure(pyr_j, pyr_i, rec_j, intr, cfg)
    if n_in < cfg["min_inliers"]:
        return False, eye, n_in
    inv = torch.linalg.inv
    M = T_loop @ inv(_t(rec_j["T_cw_obs"]))
    T_rev, n_rev = _measure(pyr_i, pyr_j, rec_i, intr, cfg)
    if n_rev >= cfg["min_inliers"]:
        M_rev = inv(T_rev @ inv(_t(rec_i["T_cw_obs"])))
        D = se3.se3_log((inv(M) @ M_rev).to(torch.float32))
        M = M @ se3.se3_exp(0.5 * D).to(F64)
        n_in = min(n_in + n_rev, 2 * n_in)
    P = _t(path_T_cw)
    M_odom = P[-1] @ inv(P[0])
    correction = torch.linalg.vector_norm(M[:3, 3] - M_odom[:3, 3])
    steps = P[1:] @ inv(P[:-1])
    budget = cfg["consistency_floor"] + cfg["consistency_frac"] * float(
        torch.linalg.vector_norm(steps[:, :3, 3], dim=-1).sum()) if len(P) > 1 else cfg["consistency_floor"]
    if correction > budget:
        return False, eye, n_in
    return True, M, n_in


# --- the pose graph ------------------------------------------------------------------

def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    c = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0).clamp(-1.0, 1.0)
    th = torch.arccos(c)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-10
    s = torch.where(small, torch.ones_like(th), torch.sin(th))
    phi = torch.where(small[..., None], vee / 2.0, th[..., None] * vee / (2.0 * s[..., None]))
    th = torch.linalg.vector_norm(phi, dim=-1)
    K = _hat(phi)
    tiny = th < 1e-8
    h = torch.where(tiny, torch.ones_like(th), th) / 2.0
    co = torch.where(tiny, torch.zeros_like(th), (1.0 - h / torch.tan(h)) / (4.0 * h * h))
    eye = torch.eye(3, dtype=T.dtype).expand(K.shape)
    V_inv = eye - 0.5 * K + co[..., None, None] * (K @ K)
    return torch.cat([(V_inv @ T[..., :3, 3, None])[..., 0], phi], -1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.vector_norm(phi, dim=-1)
    K = _hat(phi)
    KK = K @ K
    tiny = th < 1e-8
    s = torch.where(tiny, torch.ones_like(th), th)
    a = torch.where(tiny, torch.ones_like(th), torch.sin(s) / s)
    b = torch.where(tiny, torch.full_like(th, 0.5), (1.0 - torch.cos(s)) / s ** 2)
    c = torch.where(tiny, torch.full_like(th, 1.0 / 6.0), (s - torch.sin(s)) / s ** 3)
    eye = torch.eye(3, dtype=xi.dtype).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def adjoint(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype)
    A[..., :3, :3] = R
    A[..., 3:, 3:] = R
    A[..., :3, 3:] = _hat(t) @ R
    return A


def solve_chain_graph(rel, loop_edges: Sequence[Tuple[int, int, object]], anchor=None, odom_weight: float = 1.0,
                      loop_weight: float = 20.0, iterations: int = 3, outlier_residual: float = 0.5,
                      dtype=F64) -> Tuple[torch.Tensor, float, float, List[int]]:
    """(poses (n, 4, 4), chi before, chi after, indices of the loop edges
    dropped) for the chain whose odometry measurements are `rel` (n - 1
    of T_k+1 T_k^-1) and whose loop edges are (i, j, M_ij ~ T_i T_j^-1)."""
    rel = _t(np.asarray(rel, np.float64).reshape(-1, 4, 4), dtype)
    n = rel.shape[0] + 1
    L = len(loop_edges)
    src = torch.cat([torch.arange(1, n), torch.as_tensor([int(e[0]) for e in loop_edges], dtype=torch.long)])
    dst = torch.cat([torch.arange(0, n - 1), torch.as_tensor([int(e[1]) for e in loop_edges], dtype=torch.long)])
    meas = torch.cat([rel, _t(np.asarray([np.asarray(e[2], np.float64) for e in loop_edges]).reshape(L, 4, 4),
                               dtype)]) if L else rel
    w = torch.cat([torch.full((n - 1,), float(odom_weight), dtype=dtype), torch.full((L,), float(loop_weight),
                                                                                      dtype=dtype)])
    loop_idx = torch.cat([torch.full((n - 1,), -1, dtype=torch.long), torch.arange(L)])
    P0 = torch.eye(4, dtype=dtype) if anchor is None else _t(anchor, dtype)
    meas_inv = torch.linalg.inv(meas)
    J_i = adjoint(meas_inv)

    def integrate() -> torch.Tensor:
        P = [P0]
        for k in range(n - 1):
            P.append(rel[k] @ P[-1])
        return torch.stack(P)

    def residuals(P, act) -> torch.Tensor:
        return log(meas_inv[act] @ P[src[act]] @ torch.linalg.inv(P[dst[act]]))

    def chi_of(P, act) -> float:
        r = residuals(P, act)
        return 0.5 * float((w[act] * (r * r).sum(-1)).sum())

    def gn(act):
        P = integrate()
        chi0 = chi_of(P, act)
        i, j, Ji, we = src[act], dst[act], J_i[act], w[act][:, None, None]
        for _ in range(iterations):
            r = residuals(P, act)
            H = torch.zeros((n, n, 6, 6), dtype=dtype)
            b = torch.zeros((n, 6), dtype=dtype)
            JtJ = we * Ji.transpose(-1, -2) @ Ji
            eye = we * torch.eye(6, dtype=dtype)
            H.index_put_((i, i), JtJ, accumulate=True)
            H.index_put_((j, j), eye.expand_as(JtJ), accumulate=True)
            H.index_put_((i, j), -we * Ji.transpose(-1, -2), accumulate=True)
            H.index_put_((j, i), -we * Ji, accumulate=True)
            b.index_put_((i,), -(we * Ji.transpose(-1, -2) @ r[..., None])[..., 0], accumulate=True)
            b.index_put_((j,), we[..., 0] * r, accumulate=True)
            # Pose 0 holds the gauge: its row and column are the identity.
            H[0, :] = 0.0
            H[:, 0] = 0.0
            H[0, 0] = torch.eye(6, dtype=dtype)
            b[0] = 0.0
            A = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n) + 1e-9 * torch.eye(6 * n, dtype=dtype)
            dx = torch.linalg.solve(A, b.reshape(-1)).reshape(n, 6)
            P = torch.cat([P[:1], exp(dx[1:]) @ P[1:]])
        return P, chi0, chi_of(P, act)

    everything = torch.ones(n - 1 + L, dtype=torch.bool)
    P, chi0, chi1 = gn(everything)
    dropped: List[int] = []
    if L:
        loops = loop_idx >= 0
        r = residuals(P, loops)
        bad = [int(k) for k in loop_idx[loops][torch.linalg.vector_norm(r[:, :3], dim=-1) > outlier_residual]]
        if bad and len(bad) < L:
            dropped = bad
            keep = everything.clone()
            keep[n - 1 + torch.as_tensor(bad)] = False
            P, chi0, chi1 = gn(keep)
    return P, chi0, chi1, dropped


def accepted(chi0: float, chi1: float, new_edge_dropped: bool, cfg: Mapping) -> bool:
    """The closer's gates after the solve."""
    return (not new_edge_dropped) and bool(np.isfinite(chi1)) and chi1 <= cfg["pg_accept_chi_ratio"] * chi0 + 1e-2


def correction(corrected_last, T_old_last) -> torch.Tensor:
    """G, world to world: x_c = T p_old = T' p_new, so p_new = T'^-1 T p_old."""
    return torch.linalg.inv(_t(corrected_last)) @ _t(T_old_last)


# --- the closer ----------------------------------------------------------------------

class LoopReference:
    """The closer's records and loop edges, driven by `add_keyframe` as the
    port's `LoopCloser` is; records are dicts of host arrays."""

    def __init__(self, intr, cfg: Optional[Mapping] = None):
        self.intr = intr
        self.cfg = dict(DEFAULTS) if cfg is None else dict(cfg)
        self.records: List[Dict] = []
        self.thumbs: List[torch.Tensor] = []
        self.loop_edges: List[Tuple[int, int, torch.Tensor]] = []
        self.cooldown = 0

    def add_keyframe(self, frame_id: int, img_full, T_cw, uv, p_world):
        """None, or (corrected (n, 4, 4) float64, G (4, 4) float64)."""
        cfg = self.cfg
        img = np.asarray(img_full)[::2, ::2].astype(np.float32)
        M = cfg["max_feats"]
        n = min(len(uv), M)
        uv_p, pw_p = np.zeros((M, 2), np.float32), np.zeros((M, 3), np.float32)
        uv_p[:n] = np.asarray(uv)[:n] * 0.5
        pw_p[:n] = np.asarray(p_world)[:n]
        T = _t(T_cw)
        rel = T @ torch.linalg.inv(self.records[-1]["T_cw"]) if self.records else torch.eye(4, dtype=F64)
        self.records.append({"frame_id": int(frame_id), "T_cw": T.clone(), "T_cw_obs": T.clone(), "rel_prev": rel,
                             "img": np.clip(img, 0.0, 255.0).astype(np.uint8), "uv": uv_p, "p_world": pw_p,
                             "n_feats": n})
        self.thumbs.append(thumbnail(img))
        if self.cooldown > 0:
            self.cooldown -= 1
            return None
        ok = False
        for j in detect(self.thumbs, cfg):
            ok, M_ij, _ = verify(self.records[-1], self.records[j],
                                 torch.stack([r["T_cw"] for r in self.records[j:]]), self.intr, cfg)
            if ok:
                break
        if not ok:
            return None
        i = len(self.records) - 1
        self.loop_edges.append((i, j, M_ij))
        T_old_last = self.records[-1]["T_cw"].clone()
        poses, chi0, chi1, dropped = solve_chain_graph(
            [r["rel_prev"].numpy() for r in self.records[1:]], [(a, b, m.numpy()) for a, b, m in self.loop_edges],
            anchor=self.records[0]["T_cw"].numpy(), odom_weight=cfg["odom_weight"], loop_weight=cfg["loop_weight"],
            iterations=cfg["pg_iterations"], outlier_residual=cfg["outlier_residual"])
        new_dropped = len(self.loop_edges) - 1 in dropped
        self.loop_edges = [e for k, e in enumerate(self.loop_edges) if k not in dropped]
        if not accepted(chi0, chi1, new_dropped, cfg):
            return None
        for k, r in enumerate(self.records):
            r["T_cw"] = poses[k].clone()
        self.cooldown = cfg["cooldown_keyframes"]
        return poses, correction(poses[-1], T_old_last)
