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
