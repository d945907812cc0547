# Frozen copy of legoslam_tpu_torch/solver/pcg.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Jacobi-preconditioned conjugate gradients, the reference's alternative
linear solver (twin of legoslam_tpu/solver/pcg.py; `Problem::PCGSolver`,
src/lego/base/problem.cpp:584-614, config `linear_solver: pcg`).

Solves ``A x = b`` for a dense SPD A, stopping at ``||r|| <= 1e-6 ||b||`` or
after `max_iter` iterations (2n by default).  The loop is a Python loop that
reads the residual norm from the device once per iteration; the default
linear solver, Cholesky, needs no such read."""

from __future__ import annotations

import torch


def pcg_solve(A: torch.Tensor, b: torch.Tensor, max_iter: int = -1) -> torch.Tensor:
    n = b.shape[0]
    iters = 2 * n if max_iter < 0 else max_iter
    d = A.diagonal()
    m_inv = torch.where(d.abs() > 1e-30, 1.0 / d, 0.0)
    threshold = 1e-6 * torch.linalg.vector_norm(b)

    # The reference's unusual first step (problem.cpp:590-597): one step is
    # taken before the loop begins.
    z0 = m_inv * b
    p = z0
    w = A @ p
    r0z0 = torch.dot(b, z0)
    alpha = r0z0 / torch.dot(p, w)
    x = alpha * p
    r1 = b - alpha * w
    i = 0
    while i < iters and bool(torch.linalg.vector_norm(r1) > threshold):
        z1 = m_inv * r1
        r1z1 = torch.dot(r1, z1)
        p = (r1z1 / r0z0) * p + z1
        w = A @ p
        alpha = r1z1 / torch.dot(p, w)
        x = x + alpha * p
        r1 = r1 - alpha * w
        r0z0 = r1z1
        i += 1
    return x
