"""Window BA's LM loop two ways, for the tests that hold them to the same
bits: `lm.lm_optimize`, and the loop whose accept decision is taken on the
device (`lm.lm_run` over `lm.lm_begin` / `lm.lm_select`), which the card
replays as a CUDA graph (solver/ba_graph.py).  Imports no JAX, so the
card's test file loads it by path."""

from __future__ import annotations

import numpy as np
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import lm


def lm_both_ways(fns, state0, cfg):
    """(`lm.lm_optimize`'s result, the result of the same loop with the
    accept decision taken on the device: `lm.lm_run` over `lm.lm_begin`
    and `lm.lm_select`, the attempt the card captures as a CUDA graph)."""
    eager = lm.lm_optimize(fns, state0, cfg)
    select = lm.lm_run(lambda: lm.lm_begin(fns, state0, cfg), lambda c: lm.lm_select(fns, c, cfg), cfg, graph=0)
    return eager, select


def assert_same_lm_bits(a, b):
    """Two window BA `LMResult`s hold the same bits: poses, points, chi,
    lambda and trace, and the same iterations and attempts."""
    for name, x, y in zip(("poses", "points", "chi", "lam", "trace"), (*a.state, a.chi, a.lam, a.trace),
                          (*b.state, b.chi, b.lam, b.trace)):
        assert x.dtype == y.dtype == torch.float32 and x.shape == y.shape, name
        assert torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)), name
    assert (a.iterations, a.attempts) == (b.iterations, b.attempts)


def pose_prior(poses, seed, scale=0.3):
    """A made-up marginalization prior (sqrt_J, err0, T_lin) on `poses`
    (K, 4, 4): sqrt_J near 2 I, err0 small, T_lin the poses moved a little."""
    rng = np.random.default_rng(seed)
    n = 6 * poses.shape[0]
    J = 2.0 * np.eye(n) + scale * rng.normal(size=(n, n)) / np.sqrt(n)
    err0 = 0.05 * rng.normal(size=n)
    nudge = se3.se3_exp(torch.from_numpy(0.01 * rng.normal(size=(poses.shape[0], 6)).astype(np.float32)))
    return (torch.from_numpy(J.astype(np.float32)).to(poses.device),
            torch.from_numpy(err0.astype(np.float32)).to(poses.device), nudge.to(poses.device) @ poses)
