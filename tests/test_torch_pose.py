"""Parity of the port's motion-only pose estimate with the JAX reference.

The port's plain version (kernels/pose.py estimate_pose_eager =
solver/lm.py estimate_pose) against the reference's solver/lm.py and its
Pallas pose kernel in interpret mode, on the problem of
tests/test_pose_pallas.py: T within 1e-3, inlier masks agree > 98%,
|dn_in| <= max(3, 2%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoslam_tpu.geometry import se3 as j_se3
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu.solver import pose_pallas
from legoslam_tpu.solver import reprojection as j_rep
from legoslam_tpu.solver import robust as j_robust
from legoslam_tpu_torch.kernels import pose as pose_k
from legoslam_tpu_torch.solver import lm as t_lm
from legoslam_tpu_torch.solver import reprojection as t_rep
from legoslam_tpu_torch.solver import robust as t_robust
from tests.torch_parity import agreement, assert_close, j, t, to_numpy

J_INTR = j_rep.Intrinsics(fx=360.0, fy=360.0, cx=310.0, cy=94.0)
T_INTR = t_rep.Intrinsics(fx=360.0, fy=360.0, cx=310.0, cy=94.0)


def _problem(seed, n=256, outlier_frac=0.1, noise=0.3):
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 60.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    T_true = np.asarray(j_se3.se3_exp(jnp.asarray([0.1, -0.05, 0.3, 0.01, 0.02, -0.01], jnp.float32)))
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(outlier_frac * n)
    uv[:n_out] += rng.normal(0, 30.0, (n_out, 2))
    valid = rng.uniform(size=n) > 0.05
    T_prior = np.asarray(j_se3.se3_exp(jnp.asarray([0.12, -0.03, 0.25, 0.0, 0.025, 0.0], jnp.float32)))
    return T_prior, P.astype(np.float32), uv.astype(np.float32), valid, T_true


@pytest.mark.parametrize("kind", ["trivial", "huber", "cauchy", "tukey"])
def test_robust_kernels(kind):
    r = np.random.default_rng(0).normal(0, 4.0, (300, 2)).astype(np.float32)
    ref = j_robust.robust_information(kind, j(r), 5.991)
    port = t_robust.robust_information(kind, t(r), 5.991)
    for a, b in zip(port, ref):
        assert_close(to_numpy(a), np.asarray(b), 1e-4)
    assert_close(to_numpy(t_robust.robust_chi2(kind, t(r), 5.991)),
                 np.asarray(j_robust.robust_chi2(kind, j(r), 5.991)), 1e-3)


@pytest.mark.parametrize("strategy", ["default", "strategy1"])
def test_matches_reference(strategy):
    T_prior, P, uv, valid, T_true = _problem(0)
    T_t, in_t, n_t = pose_k.estimate_pose_eager(
        T_INTR, t(T_prior), t(P), t(uv), t(valid), cfg=t_lm.LMConfig(strategy=strategy))
    T_t, in_t = to_numpy(T_t), to_numpy(in_t)
    T_x, in_x, n_x = j_lm.estimate_pose(
        J_INTR, j(T_prior), j(P), j(uv), j(valid), cfg=j_lm.LMConfig(strategy=strategy))
    refs = [(np.asarray(T_x), np.asarray(in_x), int(n_x))]
    T_p, in_p, n_p = pose_pallas.estimate_pose_pallas(
        j(T_prior), j(P), j(uv), j(valid), fx=360.0, fy=360.0, cx=310.0, cy=94.0,
        strategy1=strategy == "strategy1", interpret=True)
    refs.append((np.asarray(T_p), np.asarray(in_p), int(n_p)))
    assert_close(T_t, T_true, 5e-3)
    for T_r, in_r, n_r in refs:
        assert_close(T_t, T_r, 1e-3)
        assert agreement(in_t, in_r) > 0.98
        assert abs(int(n_t) - n_r) <= max(3, 0.02 * len(in_r))


def test_all_invalid():
    T_prior, P, uv, _, _ = _problem(1, n=64)
    T_t, in_t, n_t = pose_k.estimate_pose_eager(T_INTR, t(T_prior), t(P), t(uv), torch.zeros(64, dtype=torch.bool))
    assert torch.isfinite(T_t).all()
    assert int(n_t) == 0 and not bool(in_t.any())


def test_accept_rule_follows_lm_not_pallas():
    """C1: every edge sees one of two points and the LM is undamped (tau=0),
    so H is rank-deficient and the f32 solve returns junk steps whose
    predicted decrease is negative.  The Pallas kernel accepts those when
    chi rises (rho > 0 from a negative over a negative) and ends at a worse
    fit; lm.py, and the port with it, requires scale > 0 and never lets chi
    rise.  The pose itself is not unique here (the null space is free), so
    the port is held to lm.py's final cost and inlier count."""
    rng = np.random.default_rng(16)
    base = np.stack([rng.uniform(-3, 3, 2), rng.uniform(-1, 1, 2), rng.uniform(5, 30, 2)], -1)
    P = base[rng.integers(0, 2, 64)].astype(np.float32)
    uv = np.stack([360.0 * P[:, 0] / P[:, 2] + 310.0, 360.0 * P[:, 1] / P[:, 2] + 94.0], -1)
    uv = (uv + rng.normal(0, 1.0, (64, 2))).astype(np.float32)
    T0 = np.asarray(j_se3.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)))
    valid = np.ones(64, bool)

    def cost(T):
        pc = P @ T[:3, :3].T + T[:3, 3]
        proj = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
        return float(((uv - proj) ** 2).sum())

    T_x, _, n_x = j_lm.estimate_pose(J_INTR, j(T0), j(P), j(uv), j(valid), cfg=j_lm.LMConfig(tau=0.0))
    T_p, _, n_p = pose_pallas.estimate_pose_pallas(
        j(T0), j(P), j(uv), j(valid), fx=360.0, fy=360.0, cx=310.0, cy=94.0, tau=0.0, interpret=True)
    T_t, _, n_t = pose_k.estimate_pose_eager(T_INTR, t(T0), t(P), t(uv), t(valid), cfg=t_lm.LMConfig(tau=0.0))
    c_x, c_p, c_t = cost(np.asarray(T_x)), cost(np.asarray(T_p)), cost(to_numpy(T_t))
    assert c_p > 1.5 * c_x  # the two reference paths differ here
    assert abs(c_t - c_x) <= 1e-3 * c_x
    assert int(n_t) == int(n_x) > int(n_p)
