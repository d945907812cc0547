"""Closed-form two-view DLT triangulation (twin of
legoslam_tpu/geometry/triangulation.py, `method="fast"`).

Everything the reference's SVD gate needs comes from S = A^T A (4x4
symmetric PSD) in closed form: the null vector is the adjugate column with
the largest diagonal, sigma_4^2 its Rayleigh quotient, and sigma_1..3^2 the
roots of the characteristic quartic deflated by sigma_4^2 (trigonometric
cubic).  Pure elementwise math: the products are written out as sums so no
matmul (and no TF32) can touch the trailing digits the gates live on.
"""

from __future__ import annotations

import math

import torch

from legoslam_tpu_torch.ops import rounding
from legoslam_tpu_torch.utils import timer


def _sym_invariants(S: torch.Tensor):
    """(c1, c2, c3, c4, adjS) for det(xI - S) = x^4 - c1 x^3 + c2 x^2 - c3 x + c4."""
    c1 = S[..., 0, 0] + S[..., 1, 1] + S[..., 2, 2] + S[..., 3, 3]

    def m(i, j):
        return S[..., i, j]

    c2 = (
        m(0, 0) * m(1, 1) - m(0, 1) ** 2
        + m(0, 0) * m(2, 2) - m(0, 2) ** 2
        + m(0, 0) * m(3, 3) - m(0, 3) ** 2
        + m(1, 1) * m(2, 2) - m(1, 2) ** 2
        + m(1, 1) * m(3, 3) - m(1, 3) ** 2
        + m(2, 2) * m(3, 3) - m(2, 3) ** 2
    )

    def det3(r0, r1, r2, q0, q1, q2):
        return (
            m(r0, q0) * (m(r1, q1) * m(r2, q2) - m(r1, q2) * m(r2, q1))
            - m(r0, q1) * (m(r1, q0) * m(r2, q2) - m(r1, q2) * m(r2, q0))
            + m(r0, q2) * (m(r1, q0) * m(r2, q1) - m(r1, q1) * m(r2, q0))
        )

    rows = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    adj = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            cof = sign * det3(*rows[j], *rows[i])
            adj[i][j] = cof
            adj[j][i] = cof
    adjS = torch.stack([torch.stack(r, dim=-1) for r in adj], dim=-2)
    c3 = adj[0][0] + adj[1][1] + adj[2][2] + adj[3][3]
    c4 = m(0, 0) * adj[0][0] + m(0, 1) * adj[1][0] + m(0, 2) * adj[2][0] + m(0, 3) * adj[3][0]
    return c1, c2, c3, c4, adjS


def _cubic_roots_desc(d1: torch.Tensor, d2: torch.Tensor, d3: torch.Tensor):
    """Real roots of x^3 - d1 x^2 + d2 x - d3, returned (largest, middle, smallest)."""
    a = -d1
    b = d2
    c = -d3
    q = (a * a - 3.0 * b) / 9.0
    r = (2.0 * a**3 - 9.0 * a * b + 27.0 * c) / 54.0
    q = torch.clamp(q, min=0.0)
    sq = rounding.sqrt(q)
    denom = torch.where(q > 0, sq**3, 1.0)
    cosT = torch.clamp(r / denom, -1.0, 1.0)
    th = torch.arccos(cosT)
    shift = -a / 3.0
    r0 = -2.0 * sq * torch.cos(th / 3.0) + shift
    r1 = -2.0 * sq * torch.cos((th + 2.0 * math.pi) / 3.0) + shift
    r2 = -2.0 * sq * torch.cos((th - 2.0 * math.pi) / 3.0) + shift
    hi = torch.maximum(torch.maximum(r0, r1), r2)
    lo = torch.minimum(torch.minimum(r0, r1), r2)
    mid = r0 + r1 + r2 - hi - lo
    return hi, mid, lo


def _null_and_sigmas(A: torch.Tensor):
    """Smallest-right-singular direction and (s1, s3, s4) of batched (N, R, 4)."""
    S = (A[..., :, :, None] * A[..., :, None, :]).sum(-3)
    c1, c2, c3, c4, adjS = _sym_invariants(S)
    diag = torch.diagonal(adjS, dim1=-2, dim2=-1)
    col = torch.argmax(diag, dim=-1)
    v = torch.gather(adjS, -1, col[..., None, None].expand(adjS.shape[:-1] + (1,)))[..., 0]
    vn2 = torch.sum(v * v, dim=-1)
    safe = vn2 > 0
    with timer.reading("triangulate_fallback"):  # a constant from the host
        fallback = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    v = torch.where(safe[..., None], v, fallback)
    vn2 = torch.where(safe, vn2, 1.0)
    Av = (A * v[..., None, :]).sum(-1)
    e4 = torch.sum(Av * Av, dim=-1) / vn2
    d1 = c1 - e4
    d2 = c2 - e4 * d1
    d3 = c3 - e4 * d2
    e1, _, e3 = _cubic_roots_desc(d1, d2, torch.clamp(d3, min=0.0))
    e1 = torch.clamp(e1, min=0.0)
    e3 = torch.clamp(e3, min=0.0)
    return v, rounding.sqrt(e1), rounding.sqrt(e3), rounding.sqrt(e4)


def triangulate(poses: torch.Tensor, pts_norm: torch.Tensor, sing_ratio_thr: float = 1e-3):
    """Triangulate N points seen in V views.

    Args:
      poses: (V, 4, 4) camera-from-world transforms.
      pts_norm: (N, V, 2) normalized camera coordinates per view.
      sing_ratio_thr: gate on sigma_4 / sigma_3 (algorithm.h:30).

    Returns (pt_world (N, 3), ok (N,)).
    """
    m = poses[:, :3, :]
    x = pts_norm[..., 0][..., None]
    y = pts_norm[..., 1][..., None]
    row0 = x * m[None, :, 2, :] - m[None, :, 0, :]
    row1 = y * m[None, :, 2, :] - m[None, :, 1, :]
    A = torch.cat([row0, row1], dim=-2)
    v_last, s1, s3, s4 = _null_and_sigmas(A)
    pt = v_last[..., :3] / v_last[..., 3:4]
    finite = torch.all(torch.isfinite(pt), dim=-1)
    tiny = torch.finfo(A.dtype).tiny
    ratio_ok = s4 / torch.clamp(s3, min=tiny) < sing_ratio_thr
    # Rank gate of the fast path (see the reference): s3 resolves only to
    # ~sqrt(f32 eps) * s1, so the gate sits at 1e-2.
    rank_ok = s3 > 1e-2 * s1
    return pt, finite & ratio_ok & rank_ok


def triangulate_stereo(rig_left_pose, rig_right_pose, uv_norm_left, uv_norm_right,
                       sing_ratio_thr: float = 1e-3):
    """Two-view wrapper: (4, 4) camera-from-rig extrinsics and (N, 2)
    normalized coordinates -> (pt_rig (N, 3), ok (N,))."""
    poses = torch.stack([rig_left_pose, rig_right_pose], dim=0)
    pts = torch.stack([uv_norm_left, uv_norm_right], dim=1)
    return triangulate(poses, pts, sing_ratio_thr)
