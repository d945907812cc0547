# Frozen copy of legoslam_tpu_torch/ops/rounding.py, the plain path only: the benchmark's
# reference (portbench/reference/__init__.py).  Imports point into this folder.
"""Float32 rounding the port fixes, the same on a CPU and on a card.

The JAX reference runs as XLA programs; on a CPU, XLA fixes some
associations and rewrites that PyTorch does otherwise.  Measured bit for
bit against the reference's jitted functions under every
`--xla_cpu_max_isa` setting (unset, AVX2, SSE4_2; `python -m
tests.ba_parity_report --probe-rounding` prints the probes):

- a reduction of (..., P, P) over its last two axes adds the elements one
  at a time in row-major order (`patch_sum`), under all three settings;
- a division by a compile-time constant (a rig intrinsic closed over by the
  jitted step, a patch's element count, `jnp.mean`'s count, the small-angle
  coefficients of `geometry/se3.py`) is a multiply by the constant's
  float32 reciprocal (`div_const`), under all three; a division by a
  traced value stays a division.

- a product of two 4x4 matrices (a pose composition) is the sequential
  sum of products with each product after the first fused into a
  multiply-add (`small_matmul(..., fused=True)`), under all three.

The other small products and sums are where the settings part: a 3x3
matrix product, a 3x3 matrix-vector product (a point's transform) and a
sum of three squares are sequential sums of products under all three,
fused into multiply-adds under unset and AVX2 and unfused under SSE4_2
(every element bit for bit).  So the port takes the sequential unfused
order (`small_matmul`, `small_matvec`, `row_sum`): it matches SSE4_2, and
the other two settings within their own spread.  Used for the pose's
products (`geometry/se3.py`), the prior and the tracking guess.

The motion-only pose's edge sums (`pose_sums`, csrc/pose.cu repeats
them): H as XLA sums it under every setting (four lanes of fused
multiply-adds); b, where the settings part (in the probe's pass unset adds
one fused chain, AVX2 four fused lanes, SSE4_2 one unfused chain; XLA's
choice moves with what else the program computes), and chi, whose order
no setting's was found, each in one unfused chain.  b in AVX2's four lanes
(chains a quarter as long) takes the pose past its bar on the KITTI stage
report (`--kitti-stages`, h = 3: 5.3e-6 against 4.3e-6); the unfused chain,
SSE4_2's, does not.

Every helper is built from single-operation elementwise torch ops, which
round the same on a CPU and on CUDA (IEEE add, multiply, divide; `fma`
rounds a fused multiply-add once from float64 ops), so the plain versions
give the same bits on both.  A square root
goes through `sqrt`: `torch.sqrt` of float32 is not correctly rounded on
a CPU with MKL.

`ops/prefix.py` (the 16-wide cumsum) and `ops/interp.py` (the fused row
pass of its one-hot matmul on some image shapes) hold the others.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def patch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes, one element at a time in row-major order.
    Stack several sums on leading axes: the loop is one add per element."""
    flat = x.reshape(*x.shape[:-2], -1)
    acc = flat[..., 0]
    for k in range(1, flat.shape[-1]):
        acc = acc + flat[..., k]
    return acc


def patch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes: `patch_sum` times the reciprocal of the
    count, as `jnp.mean` compiles."""
    return div_const(patch_sum(x), x.shape[-1] * x.shape[-2])


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c, as x times the float32 reciprocal of c."""
    return x * float(np.float32(1.0) / np.float32(c))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded correctly on any device.  On a CPU with MKL,
    `torch.sqrt` of float32 takes VML's, which misses the correctly rounded
    result by one ulp on ~0.64% of inputs (XLA's and CUDA's `sqrt` round
    correctly); the float64 root rounded to float32 is correct on both
    devices (double rounding is innocuous for a square root)."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element at a time: ((x0 + x1) + x2) + ..."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def rows_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of (..., P, C) over its P rows, in the order an x86 CPU's
    `torch.sum(x, dim=-2)` takes for float32 (ATen's `cascade_sum` with
    8-float vectors), written as elementwise ops so a card gives the same
    bits.  Columns in whole blocks of 32 (of 4 when C < 8) add their rows
    one at a time from zero, the first 16 and the rest apart when P >= 16;
    the other columns keep four partial sums, row r in sum r mod 4 (the rows
    past the last whole four in the first), and add them in order.  (ATen
    takes yet another order when C == 1.)"""
    P, C = x.shape[-2:]
    zero = torch.zeros_like(x[..., 0, :])

    def run(rows):
        acc = zero
        for r in rows:
            acc = acc + x[..., r, :]
        return acc

    seq = run(range(P)) if P < 16 else run(range(16, P)) + (zero + run(range(16)))
    n4 = P // 4
    part = [run(range(k, 4 * n4, 4)) for k in range(4)]
    for r in range(4 * n4, P):
        part[0] = part[0] + x[..., r, :]
    fours = ((part[0] + part[1]) + part[2]) + part[3]
    whole = (C // 32) * 32 if C >= 8 else (C // 4) * 4
    col = torch.arange(C, device=x.device)
    return zero + torch.where(col < whole, seq, fours)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as a fused multiply-add
    (XLA's CPU code, CUDA's `__fmaf_rn`), on any device."""
    return round_once(a.double() * b.double(), c.double())


def round_once(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """p + c, float64 tensors whose exact sum is wanted, rounded once to
    float32.  The float64 sum is rounded to odd (moved one float64 step
    toward the exact sum where it is inexact and its last bit even, the
    exact error from TwoSum), and a value rounded to odd with two bits or
    more to spare rounds to float32 as the exact sum does.  Rounding the
    float64 sum alone would round twice, wrongly where it lands on a
    float32 midpoint.  Single-operation elementwise ops, so the same bits
    on a CPU and a card."""
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)  # p + c - s, exactly
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf), e))
    return torch.where((e != 0) & even, step, s).float()


def small_matmul(a: torch.Tensor, b: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """``a @ b`` for small (..., n, k) @ (..., k, m): each element the
    sequential sum of its k products, ((a0 b0 + a1 b1) + a2 b2) + ...,
    nothing fused; with `fused`, each product after the first is added by
    a fused multiply-add, fma(a2, b2, fma(a1, b1, a0 b0)), rounded once
    (`fma`; csrc/pose.cu's `__fmaf_rn`).  Float64 operands are not fused."""
    if fused and torch.promote_types(a.dtype, b.dtype) == torch.float32:
        p = a.double()[..., :, :, None] * b.double()[..., None, :, :]  # (..., n, k, m), exact
        acc = p[..., 0, :].float()
        for q in range(1, p.shape[-2]):
            acc = round_once(p[..., q, :], acc.double())
        return acc
    p = a[..., :, :, None] * b[..., None, :, :]
    acc = p[..., 0, :]
    for q in range(1, p.shape[-2]):
        acc = acc + p[..., q, :]
    return acc


def small_matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(..., n, m) @ (..., m)`` in `small_matmul`'s order."""
    return row_sum(M * v[..., None, :])


# A float64 value rounds to float32 as any exact value it was rounded from
# unless it is a float32 midpoint: its low 29 bits a one and 28 zeros (for
# a normal float32; below 2^-125 every value is suspect).
_MID_MASK, _MID = 0x1FFFFFFF, 0x10000000


def _fma_chain(P: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """acc = fma over exact float64 products P[0], P[1], ... in turn, each
    step rounded once to float32.  The float64 sums round twice; where
    none lands on a float32 midpoint (the rule, by far) that is the single
    rounding, else the chain is redone through `round_once`."""
    S = np.empty(P.shape, np.float64)
    a = acc
    for n in range(P.shape[0]):
        np.add(P[n], a, out=S[n])
        a = S[n].astype(np.float32)
    if not np.any(((S.view(np.int64) & _MID_MASK) == _MID) | ((np.abs(S) < 2.0 ** -125) & (S != 0))):
        return a
    a = torch.from_numpy(acc)
    for n in range(P.shape[0]):
        a = round_once(torch.from_numpy(P[n]), a.double())
    return a.numpy()


def pose_sums(jw: torch.Tensor, J: torch.Tensor, t: torch.Tensor, m: torch.Tensor):
    """The motion-only pose's edge sums (csrc/pose.cu repeats them): H
    (6, 6), sum b (6,) and sum chi () from (E, 2, 6) rows jw = (J^T W)^T
    and J, (E, 2) weighted residuals t = rho' r and (E,) chi terms, edges
    in turn.  Over k = 2e + j:

    - H[a, c] = sum of jw[e, j, a] J[e, j, c] in four lanes by k mod 4, a
      lane a chain of fused multiply-adds in k order (`fma`), the lanes
      added (l0 + l1) + (l2 + l3), as XLA's CPU code does under every
      setting;
    - b[a] = sum of the rounded products J[e, j, a] t[e, j], one unfused
      sequential sum over k;
    - chi: one unfused sequential sum over e.

    The chains are sequential, so they run on the host in NumPy: CPU
    tensors in and out, and the caller moves them."""
    if any(x.device.type != "cpu" for x in (jw, J, t, m)):
        raise ValueError("pose_sums sums on the host: give it CPU tensors")
    jw, J, t, m = (x.detach().numpy() for x in (jw, J, t, m))
    E = jw.shape[0]
    P = (jw.astype(np.float64)[..., :, None] * J.astype(np.float64)[..., None, :]).reshape(2 * E, 36)  # exact
    P = np.concatenate([P, np.zeros((-2 * E % 4, 36))]).reshape(-1, 4, 36)  # (step, lane k mod 4, term)
    lanes = _fma_chain(P, np.zeros((4, 36), np.float32))
    H = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])).reshape(6, 6)
    zero = np.zeros((1, 6), np.float32)
    b = np.cumsum(np.concatenate([zero, (J * t[..., None]).reshape(-1, 6)]), axis=0, dtype=np.float32)[-1]
    chi = np.cumsum(np.concatenate([np.zeros(1, np.float32), m]), dtype=np.float32)[-1]
    return tuple(torch.from_numpy(np.array(x, np.float32)) for x in (H, b, chi))
