"""Checkpoint / resume (twin of legoslam_tpu/utils/checkpoint.py, in its
file format).

A checkpoint is one compressed `.npz`: the leaves of `(VOCarry,
[FrameOutput])` keyed `leaf_%04d` in the order of the JAX package's
`tree_flatten` (every state class there is a NamedTuple, so that is field
order, depth first; a `None` has no leaf), plus a `__meta__` JSON blob
(schema version 1, the leaf count, and the run's metadata: `frame_ids`,
`n_outputs`, `image_shape`, `next_index`, `has_ba_stats`, `ba_trace_len`).
The port's state classes carry the reference's field names in its order
(pipeline/state.py), and host ints are written as int32 leaves as the
reference stores them, so a checkpoint written by either package resumes in
the other.  The loader shapes the leaves by a template made from the same
config and fails loudly on a leaf count, shape or dtype mismatch.

The port's `BAStats.attempts` has no leaf in this format and loads as 0.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 1


def _flatten(tree) -> List[np.ndarray]:
    """Leaves of nested dicts / tuples / lists, depth first in order; None has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [np.asarray(tree)]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def save_pytree(path: str, tree, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write the leaves of `tree` to `path` (.npz, compressed; the suffix is
    added where missing) and return the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = _flatten(tree)
    blobs = {f"leaf_{i:04d}": leaf for i, leaf in enumerate(leaves)}
    blobs["__meta__"] = np.frombuffer(
        json.dumps({"schema": SCHEMA_VERSION, "n_leaves": len(leaves), "user": meta or {}}).encode("utf-8"),
        dtype=np.uint8)
    np.savez_compressed(path, **blobs)
    return path


def _normalize_path(path: str) -> str:
    """Accept both `f` and `f.npz` spellings at load time."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def read_meta(path: str) -> Dict[str, Any]:
    with np.load(_normalize_path(path)) as data:
        return json.loads(bytes(data["__meta__"]).decode("utf-8"))


def load_pytree(path: str, template) -> Tuple[Any, Dict[str, Any]]:
    """Read a file written by `save_pytree`, shaped like `template`.  Every
    leaf must match the template's shape and dtype exactly."""
    with np.load(_normalize_path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        if meta["schema"] != SCHEMA_VERSION:
            raise ValueError(f"checkpoint schema {meta['schema']} != {SCHEMA_VERSION}")
        t_leaves = _flatten(template)
        if meta["n_leaves"] != len(t_leaves):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template has {len(t_leaves)} "
                             "(config/capacity mismatch between save and load)")
        leaves = []
        for i, t_arr in enumerate(t_leaves):
            arr = data[f"leaf_{i:04d}"]
            if arr.shape != t_arr.shape or arr.dtype != t_arr.dtype:
                raise ValueError(f"leaf {i}: checkpoint {arr.shape}/{arr.dtype} vs "
                                 f"template {t_arr.shape}/{t_arr.dtype}")
            leaves.append(arr)
    return _unflatten(template, iter(leaves)), meta.get("user", {})


# --- FrameOutput <-> leaves ----------------------------------------------------

_BA_FIELDS = ("chi", "iterations", "n_outlier", "n_inlier", "n_active_landmarks", "n_dropped_landmarks",
              "lam", "trace")
_BA_DTYPES = (np.float32, np.int32, np.int32, np.int32, np.int32, np.int32, np.float32, np.float32)


def _output_to_numpy(out) -> dict:
    d = {
        "T_cw": out.T_cw.cpu().numpy(),
        "status": np.asarray(out.status, np.int32),
        "kf_inserted": np.asarray(bool(out.kf_inserted)),
        "n_inliers": np.asarray(out.n_inliers, np.int32),
        "ba_chi": np.asarray(out.ba_chi.cpu(), np.float32),
        "n_tracked": np.asarray(torch.as_tensor(out.n_tracked).cpu(), np.int32),
        "n_new_landmarks": np.asarray(torch.as_tensor(out.n_new_landmarks).cpu(), np.int32),
        "ba": None,
    }
    if out.ba is not None:
        d["ba"] = {k: np.asarray(torch.as_tensor(getattr(out.ba, k)).cpu(), dt) for k, dt in zip(_BA_FIELDS, _BA_DTYPES)}
    return d


def _output_template(has_ba: bool, trace_len: int) -> dict:
    z = {"T_cw": np.zeros((4, 4), np.float32), "status": np.asarray(0, np.int32),
         "kf_inserted": np.asarray(False), "n_inliers": np.asarray(0, np.int32),
         "ba_chi": np.asarray(0.0, np.float32), "n_tracked": np.asarray(0, np.int32),
         "n_new_landmarks": np.asarray(0, np.int32), "ba": None}
    if has_ba:
        z["ba"] = {k: np.zeros((trace_len, 2) if k == "trace" else (), dt) for k, dt in zip(_BA_FIELDS, _BA_DTYPES)}
    return z


def _output_from_numpy(d: dict, device):
    from legoslam_tpu_torch.pipeline.backend import BAStats
    from legoslam_tpu_torch.pipeline.visual_odometry import FrameOutput

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    ba = None
    if d["ba"] is not None:
        b = d["ba"]
        ba = BAStats(chi=t(b["chi"]), iterations=int(b["iterations"]), n_outlier=t(b["n_outlier"]),
                     n_inlier=t(b["n_inlier"]), n_active_landmarks=t(b["n_active_landmarks"]),
                     n_dropped_landmarks=t(b["n_dropped_landmarks"]), lam=t(b["lam"]), trace=t(b["trace"]))
    return FrameOutput(T_cw=t(d["T_cw"]), status=int(d["status"]), kf_inserted=bool(d["kf_inserted"]),
                       n_inliers=int(d["n_inliers"]), ba_chi=t(d["ba_chi"]), n_tracked=t(d["n_tracked"]),
                       n_new_landmarks=t(d["n_new_landmarks"]), ba=ba)


# --- VisualOdometry -------------------------------------------------------------

def save_vo_checkpoint(path: str, vo) -> str:
    """Snapshot a running `VisualOdometry`: the carry and the per-frame
    outputs.  `load_vo_checkpoint` into a VO made with the same config
    continues the sequence where this one stopped.  Returns the path written."""
    from legoslam_tpu_torch.pipeline.state import carry_to_numpy

    if vo.carry is None:
        raise ValueError("VO has processed no frames; nothing to checkpoint")
    outputs = [_output_to_numpy(o) for o in vo.outputs]
    has_ba = bool(outputs and outputs[0]["ba"] is not None)
    user = {
        "frame_ids": [int(i) for i in vo.frame_ids],
        "n_outputs": len(outputs),
        "image_shape": list(vo.carry.pyr_last[0].shape),
        "next_index": int(getattr(vo.dataset, "current_index", 0)),
        "has_ba_stats": has_ba,
        "ba_trace_len": int(outputs[0]["ba"]["trace"].shape[0]) if has_ba else 0,
    }
    return save_pytree(path, (carry_to_numpy(vo.carry), outputs), meta=user)


def load_vo_checkpoint(path: str, vo) -> None:
    """Restore a checkpoint into an `init()`-ed VO and seek its dataset to
    the first unprocessed frame."""
    from legoslam_tpu_torch.pipeline import visual_odometry as vo_mod
    from legoslam_tpu_torch.pipeline.state import carry_from_numpy, carry_to_numpy

    if vo.frontend_cfg is None:
        raise ValueError("call vo.init() before loading a checkpoint")
    user = read_meta(path)["user"]
    carry_t = carry_to_numpy(vo_mod.initial_carry(vo.frontend_cfg, tuple(user["image_shape"]), torch.float32, "cpu"))
    out_t = _output_template(bool(user.get("has_ba_stats", False)), int(user.get("ba_trace_len", 0)))
    (carry, outputs), user = load_pytree(path, (carry_t, [out_t] * int(user["n_outputs"])))
    vo.carry = carry_from_numpy(carry, vo.device)
    vo.outputs = [_output_from_numpy(o, vo.device) for o in outputs]
    vo.frame_ids = list(user["frame_ids"])
    # Setting `current_index` alone does not move the native prefetching
    # loader, which streams from the index it was opened at: the dataset
    # must seek, or the resumed run would silently start again at frame 0.
    next_index = int(user.get("next_index", 0))
    if hasattr(vo.dataset, "seek"):
        vo.dataset.seek(next_index)
    elif hasattr(vo.dataset, "current_index"):
        vo.dataset.current_index = next_index
    else:
        raise ValueError(f"dataset {type(vo.dataset).__name__} cannot seek to frame {next_index}; "
                         "resume requires a seek() or current_index")
    vo._hook_prev = None
    vo._pending_correction = None
