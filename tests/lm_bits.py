"""The port's LM loop against the tests' plain reference, for the tests
that hold them to the same bits: `host_decided_lm`, the loop with the
accept decision read on the host and only the chosen branch computed, and
`lm.lm_optimize`, the port's one loop (`lm.lm_run` over `lm.lm_begin` /
`lm.lm_select`, the decision taken on the device), which the card replays
as a CUDA graph in window BA (solver/ba_graph.py).  Imports no JAX, so the
card's test file loads it by path."""

from __future__ import annotations

import numpy as np
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.solver import lm


def host_decided_lm(fns, state0, cfg):
    """LM from `state0` as a loop that reads each attempt's accept and stop
    flags on the host and then computes only the chosen branch: lambda's
    update, and the candidate with its assembly kept only on accept."""
    chi, aux = fns.chi_build(state0)
    lam = lm._first_lambda(fns, aux, cfg, lambda x: torch.full((), x, dtype=chi.dtype, device=chi.device))
    state, last_chi, ni = state0, torch.full_like(chi, 1e20), torch.full_like(chi, 2.0)
    trace = torch.full((cfg.iterations if cfg.trace else 0, 2), torch.nan, dtype=chi.dtype, device=chi.device)
    it = false_cnt = attempts = 0
    stop = False
    while not stop and it < cfg.iterations:
        dx = fns.solve(aux, lam)
        cand = fns.retract(state, dx)
        temp_chi, aux_cand = fns.chi_build(cand)
        accept_t, stop_t, rho_val = lm._verdict(fns, cfg, aux, dx, lam, chi, temp_chi, last_chi)
        accept, stop_if_done = torch.stack([accept_t, stop_t]).tolist()
        attempts, lam_used = attempts + 1, lam
        if accept:
            lam, ni = lm._lam_accepted(lam, rho_val, cfg), torch.full_like(ni, 2.0)
            state, chi, aux, false_cnt = cand, temp_chi, aux_cand, 0
        else:
            lam, ni, false_cnt = lm._lam_rejected(lam, ni, cfg), ni * 2.0, false_cnt + 1
        if accept or false_cnt >= cfg.false_cnt_threshold:
            it, stop, false_cnt = it + 1, stop_if_done, 0
            if cfg.trace:
                trace[it - 1] = torch.stack([chi, lam_used])
            last_chi = chi
    return lm.LMResult(state=state, chi=chi, lam=lam, iterations=it, attempts=attempts, trace=trace)


def lm_both_ways(fns, state0, cfg):
    """(`host_decided_lm`'s result, `lm.lm_optimize`'s)."""
    return host_decided_lm(fns, state0, cfg), lm.lm_optimize(fns, state0, cfg)


def assert_same_lm_bits(a, b):
    """Two float32 `LMResult`s hold the same bits: the state (poses, and
    points where it is window BA's), chi, lambda and trace, and the same
    iterations and attempts."""
    def leaves(r):
        state = (r.state,) if torch.is_tensor(r.state) else tuple(r.state)
        return dict(zip(("poses", "points"), state), chi=r.chi, lam=r.lam, trace=r.trace)

    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for name, x in la.items():
        y = lb[name]
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
