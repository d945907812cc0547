"""Helpers for the parity tests of the PyTorch port against the JAX reference.

Inputs are made with NumPy from a seed and handed to both packages; results
come back as NumPy arrays.  JAX runs on the CPU, as the reference's own tests
run it (its Pallas kernels in interpret mode).  The test suite runs several
xdist workers, so each worker's torch is capped at 2 threads here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)


def to_numpy(x: Any):
    """A JAX array, torch tensor or tuple of them as NumPy."""
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x, dtype=None) -> torch.Tensor:
    """NumPy -> CPU tensor (a copy, so the source may be read-only); float64
    becomes float32 unless `dtype` says otherwise."""
    a = np.array(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def j(x):
    """NumPy -> JAX array, float64 as float32."""
    a = np.asarray(x)
    return jnp.asarray(a.astype(np.float32) if a.dtype == np.float64 else a)


def both(jax_fn: Callable, torch_fn: Callable, *args):
    """Run the reference and the port on the same NumPy inputs; returns
    (reference outputs, port outputs) as NumPy."""
    ref = jax_fn(*[j(a) for a in args])
    port = torch_fn(*[t(a) for a in args])
    return to_numpy(ref), to_numpy(port)


def tree_to_numpy(tree: Any) -> Dict[str, Any]:
    """A reference NamedTuple pytree (VOCarry, Features, WorldMap, ...) as a
    nested dict of NumPy copies keyed by field name (the input of the port's
    `state.*_from_numpy` converters)."""
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out[k] = tree_to_numpy(v)
        elif isinstance(v, (tuple, list)):
            out[k] = [np.array(x) for x in v]
        else:
            out[k] = np.array(v)
    return out


def agreement(a, b) -> float:
    """Fraction of equal entries of two masks."""
    return float((np.asarray(a) == np.asarray(b)).mean())


def assert_close(actual, expected, atol: float, where=None) -> None:
    """|actual - expected| <= atol everywhere (or on the `where` mask)."""
    a, e = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    if where is not None:
        a, e = a[np.asarray(where)], e[np.asarray(where)]
    np.testing.assert_allclose(a, e, rtol=0.0, atol=atol)


def step_gap(T_wc_a, T_wc_b, kf) -> float:
    """The largest distance (m) between two trajectories' frame-to-frame
    translations, over the steps that leave a frame without a keyframe.  A
    step out of a keyframe frame carries the window BA's move of the gauge
    (every window pose is free), so it is left out."""
    a, b = (np.asarray(T, np.float64) for T in (T_wc_a, T_wc_b))
    step_a = np.linalg.inv(a[:-1]) @ a[1:]
    step_b = np.linalg.inv(b[:-1]) @ b[1:]
    quiet = ~np.asarray(kf, bool)[:-1]
    return float(np.linalg.norm(step_a[quiet, :3, 3] - step_b[quiet, :3, 3], axis=-1).max())


def window_gap(win_a, win_b) -> float:
    """The largest entry of the difference between two windows' keyframe
    poses taken relative to the oldest keyframe (by `kf_id`): what the free
    gauge cannot move.  Both windows must hold the same keyframes."""
    valid = np.asarray(win_a["kf_valid"], bool)
    np.testing.assert_array_equal(valid, win_b["kf_valid"])
    np.testing.assert_array_equal(np.asarray(win_a["kf_id"])[valid], np.asarray(win_b["kf_id"])[valid])
    oldest = int(np.argmin(np.where(valid, win_a["kf_id"], np.iinfo(np.int32).max)))

    def relative(T):
        T = np.asarray(T, np.float64)
        return (T @ np.linalg.inv(T[oldest]))[valid]

    return float(np.abs(relative(win_a["kf_pose"]) - relative(win_b["kf_pose"])).max())


def compact_window(d):
    """The world map `d` (NumPy, by field) cut to the landmarks its window's
    keyframes hold, renumbered in id order: the window and its landmarks,
    not the 131,072-slot table."""
    ids = np.unique(d["kf_lm"][d["kf_valid"][:, None] & (d["kf_lm"] >= 0)])
    remap = np.full(len(d["lm_pos"]), -1, np.int64)
    remap[ids] = np.arange(len(ids))
    out = {k: v[ids] if k.startswith("lm_") and np.ndim(v) >= 1 else v for k, v in d.items()}
    out["kf_lm"] = np.where(d["kf_lm"] >= 0, remap[np.maximum(d["kf_lm"], 0)], -1).astype(d["kf_lm"].dtype)
    out["lm_next"] = np.asarray(len(ids), np.asarray(d["lm_next"]).dtype)
    return out


def load_kitti_window(path):
    """(world map by field, [P0, P1], frame) of a file that `python -m
    tests.ba_parity_report --kitti-window SEQ FRAME --save OUT` wrote."""
    with np.load(path) as z:
        d = {}
        for k in z.files:
            if k.startswith("wmap/"):
                node, *rest = k[len("wmap/"):].split("/")
                if rest:
                    d.setdefault(node, {})[rest[0]] = z[k]
                else:
                    d[node] = z[k]
        return d, [z["P0"], z["P1"]], int(z["frame"])
