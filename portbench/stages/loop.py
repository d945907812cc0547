"""The loop closer's stages (configuration key `"stages": ["loop"]`):
verification (`LoopCloser._verify`) and the pose graph
(`pose_graph_host.solve_chain_graph`, the whole of `LoopCloser._optimize`'s
solve: `_optimize` drops the outlier edges from the closer's list before
it returns, so what it was handed is kept from the solve it calls), each
replayed by the plain reference (portbench/reference/loop.py) from what
the port handed it.

Gaps, each the largest over the kept calls:
- loop_T: the loop transform's largest gap, translation (m) or rotation
  (rad, `rotation_gap`), where both accept; inf where the verdicts differ;
- loop_inliers: |inliers - the reference's| / the reference's;
- pg_T: the corrected camera positions' largest gap (m); inf where the
  dropped loop edges or the closer's chi gates differ;
- pg_chi: |chi after the solve - the reference's| / the reference's.
With the control the reference's verification runs in TF32 and its pose
graph in float32 (the precision next below the float64 it is stated in)
in the port's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import loop as ref_loop

WRAP = (("pipeline.loop_closure", "LoopCloser._verify", "verify"),
        ("solver.pose_graph_host", "solve_chain_graph", "pose_graph"))
KEEP = 6
GAPS = ("loop_T", "loop_inliers", "pg_T", "pg_chi")

_RECORD_KEYS = ("img", "uv", "p_world", "n_feats", "T_cw_obs")


def _record(rec) -> dict:
    return {k: np.array(getattr(rec, k)) if k != "n_feats" else int(rec.n_feats) for k in _RECORD_KEYS}


def keep(args, kw, out):
    if len(args) == 2 and hasattr(args[0], "records"):  # LoopCloser._verify(self, j)
        closer, j = args
        ok, M, n_in = out
        records = closer.records
        return {"stage": "verify", "rec_i": _record(records[-1]), "rec_j": _record(records[j]),
                "path_T_cw": np.stack([r.T_cw for r in records[j:]]),
                "out": {"ok": bool(ok), "M": np.array(M, np.float64), "n_in": int(n_in)}}
    rel, loop_edges = args[:2]  # solve_chain_graph(rel, loop_edges, anchor=..., ...)
    P, chi0, chi1, dropped = out
    return {"stage": "pose_graph", "rel": np.stack([np.asarray(r, np.float64) for r in rel]),
            "loop_edges": [(int(i), int(j), np.array(M, np.float64)) for i, j, M in loop_edges],
            "anchor": np.array(np.eye(4) if kw.get("anchor") is None else kw["anchor"], np.float64),
            "odom_weight": float(kw.get("odom_weight", 1.0)), "loop_weight": float(kw.get("loop_weight", 20.0)),
            "iterations": int(kw.get("iterations", 3)),
            "out": {"P": np.array(P, np.float64), "chi0": float(chi0), "chi1": float(chi1),
                    "dropped": [int(d) for d in dropped]}}


def _centres(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def rotation_gap(A, B) -> float:
    """The angle (rad) of the rotation between A's and B's rotation blocks,
    from the sine and cosine of R_A^T R_B (an arccos of its trace alone
    reads ~1e-4 rad for two equal rotations ~1e-8 from orthonormal)."""
    D = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    s = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.arctan2(s, 0.5 * (np.trace(D) - 1.0)))


def verify_gaps(call, intr, cfg, control=None) -> dict:
    """The gaps of one kept `_verify` call; with `control`, the control's
    answer on its inputs stands in the port's place."""
    def ref():
        return ref_loop.verify(call["rec_i"], call["rec_j"], call["path_T_cw"], intr, cfg)

    ok_r, M_r, n_r = ref()
    if control is None:
        port = call["out"]
    else:
        ok, M, n_in = control(lambda _reference: ref())
        port = {"ok": ok, "M": M.numpy(), "n_in": n_in}
    inliers = abs(port["n_in"] - n_r) / max(n_r, 1)
    if port["ok"] != ok_r:
        return {"loop_T": float("inf"), "loop_inliers": inliers}
    if not ok_r:
        return {"loop_T": 0.0, "loop_inliers": inliers}
    M_p, M_r = port["M"], M_r.numpy()
    gap = max(float(np.linalg.norm(M_p[:3, 3] - M_r[:3, 3])), rotation_gap(M_p, M_r))
    return {"loop_T": gap if np.isfinite(gap) else float("inf"), "loop_inliers": inliers}


def _solve(call, cfg, dtype):
    P, chi0, chi1, dropped = ref_loop.solve_chain_graph(
        call["rel"], call["loop_edges"], anchor=call["anchor"], odom_weight=call["odom_weight"],
        loop_weight=call["loop_weight"], iterations=call["iterations"], outlier_residual=cfg["outlier_residual"],
        dtype=dtype)
    return {"P": P.to(torch.float64).numpy(), "chi0": chi0, "chi1": chi1, "dropped": dropped}


def pose_graph_gaps(call, cfg, control: bool = False) -> dict:
    """The gaps of one kept pose-graph solve; with `control`, the
    reference's solve in float32 stands in the port's place."""
    ref = _solve(call, cfg, torch.float64)
    port = _solve(call, cfg, torch.float32) if control else call["out"]
    newest = len(call["loop_edges"]) - 1
    same_gates = (sorted(port["dropped"]) == sorted(ref["dropped"])
                  and ref_loop.accepted(port["chi0"], port["chi1"], newest in port["dropped"], cfg)
                  == ref_loop.accepted(ref["chi0"], ref["chi1"], newest in ref["dropped"], cfg))
    gap = float(np.linalg.norm(_centres(port["P"]) - _centres(ref["P"]), axis=-1).max())
    pg_T = gap if same_gates and np.isfinite(gap) else float("inf")
    chi = abs(port["chi1"] - ref["chi1"]) / max(abs(ref["chi1"]), 1e-300)
    return {"pg_T": pg_T, "pg_chi": chi if np.isfinite(chi) else float("inf")}


def replay(calls, ctx, control=None):
    cfg = ref_loop.loop_config(ctx.settings)
    intr = ref_loop.intrinsics(ctx.camera)
    gaps = {}

    def worst(g):
        for k, v in g.items():
            gaps[k] = max(gaps.get(k, 0.0), v)

    for call in calls.get("verify", []):
        worst(verify_gaps(call, intr, cfg, control))
    for call in calls.get("pose_graph", []):
        worst(pose_graph_gaps(call, cfg, control is not None))
    return gaps
