"""How the JAX reference rounds the pose's small products, on a CPU, under
XLA's three instruction-set settings, against the port's rounding
(legoslam_tpu_torch/ops/rounding.py).

    JAX_PLATFORMS=cpu python -m tests.ba_parity_report --probe-rounding [--save OUT]

Seeded inputs go through the reference's jitted functions (a 4x4 and a 3x3
product, a 3x3 matrix-vector product, a sum of three squares, divisions by
the small-angle constants, `se3._rot_coeffs` below the small angle, the
prior `se3_orthonormalize(rel @ T)`, `se3_exp`, `retract`, `transform`,
`jnp.sqrt`, `jnp.linalg.solve` on damped 6x6 SPD systems, and one pass of
the pose's normal equations over 512 edges: H, b, chi and the per-edge
rows of J^T W and J that H sums), one pose or system at a time as the
pipeline calls them, each setting in a process of its own.
Printed per quantity: whether the settings agree bit for bit, the share of
elements that a sequential unfused order and a sequential fused
(multiply-add) order reproduce under each, the settings' spread and the
port's largest gap to each setting; for the solve, an explicit LU
(`lm.lu_solve`) and a Cholesky beside LAPACK's; and how often
`torch.sqrt` on this CPU misses the correctly rounded root.  --save writes
the inputs and every setting's outputs (tests/data/rounding_probe.npz,
held by tests/test_torch_rounding_frontend.py).  Then the bilinear sampler
(`probe_sampler`): the reference's one-hot matmul rounds its row pass as
a fused multiply-add on some image shapes, which the port lists by shape
(`ops/interp.py` FUSED_ROW_SHAPES); printed per level of the 188x620 and
376x1240 pyramids and half-patch, which row pass (unfused, fused, neither)
gives each setting's bits, and whether the port's does.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

N = 256
POSE_PROBLEMS = 8
SETTINGS = ("unset", "AVX2", "SSE4_2")
ISA = {"unset": "", "AVX2": "AVX2", "SSE4_2": "SSE4_2"}
CONSTANTS = (6.0, 24.0, 120.0, 720.0, 5040.0)
# The sampler's probe: every level with a row of these pyramids, at these
# half-patches (the halo window is 2 h + 3 px), SAMPLER_LANES windows each.
SAMPLER_PYRAMIDS = (((188, 620), 8), ((376, 1240), 9))
SAMPLER_HALF_PATCHES = (0, 1, 3, 5, 9)
SAMPLER_LANES = 256


def inputs(seed: int = 0) -> dict:
    """Seeded float32 inputs: near-rotation poses A, B (as a frame's
    rel_motion and T_cur), vectors v, small theta^2, small tangents xi and
    dx, and damped 6x6 normal equations D x = b."""
    rng = np.random.default_rng(seed)

    def exp(xi):
        phi = xi[:, 3:]
        th = np.linalg.norm(phi, axis=1)[:, None, None]
        K = np.zeros((len(xi), 3, 3))
        K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -phi[:, 2], phi[:, 1], -phi[:, 0]
        K = K - np.swapaxes(K, 1, 2)
        R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)
        T = np.tile(np.eye(4), (len(xi), 1, 1))
        T[:, :3, :3], T[:, :3, 3] = R, xi[:, :3]
        return T

    A = exp(np.concatenate([rng.normal(0, 0.3, (N, 3)), rng.normal(0, 0.05, (N, 3))], 1))
    B = exp(np.concatenate([rng.normal(0, 20, (N, 3)), rng.normal(0, 1.0, (N, 3))], 1))
    A[:, :3, :3] += rng.normal(0, 1e-6, (N, 3, 3))  # float32 products shed orthonormality
    J = rng.normal(0, 300, (N, 40, 6))
    H = np.einsum("nei,nej->nij", J, J)
    lam = 1e-5 * np.abs(np.diagonal(H, axis1=1, axis2=2)).max(1) * rng.uniform(0.1, 100, N)
    D = H + lam[:, None, None] * np.eye(6)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    # POSE_PROBLEMS pose problems of 512 edges: 10% gross outliers, 10% not valid
    z = rng.uniform(4, 60, (POSE_PROBLEMS, 512))
    P = np.stack([rng.uniform(-0.8, 0.8, z.shape) * z, rng.uniform(-0.3, 0.3, z.shape) * z, z], -1)
    uv = np.stack([360 * P[..., 0] / P[..., 2] + 310, 360 * P[..., 1] / P[..., 2] + 94], -1)
    uv += rng.normal(0, 3, uv.shape)
    uv[:, :51] += rng.normal(0, 30, (POSE_PROBLEMS, 51, 2))
    return {"A": f32(A), "B": f32(B), "v": f32(rng.normal(0, 10, (N, 3))),
            "pose_P": f32(P), "pose_uv": f32(uv), "pose_valid": rng.uniform(size=(POSE_PROBLEMS, 512)) > 0.1,
            "t2": f32(rng.uniform(0, 0.0025, N)), "xi": f32(rng.normal(0, [0.1] * 3 + [0.02] * 3, (N, 6))),
            "dx": f32(rng.normal(0, [0.05] * 3 + [0.01] * 3, (N, 6))),
            "D": f32((D + np.swapaxes(D, 1, 2)) / 2), "b": f32(rng.normal(0, 1e4, (N, 6))),
            "sq": f32(rng.uniform(0, 100, 4 * N))}


def pose_outputs(one) -> dict:
    """"pose H", "pose b", "pose chi" stacked over the pose problems
    (`one(i)`: problem i's H, b, chi and, from the reference, its rows jw
    and J and its weighted residuals t = rho' r, kept for the first problem
    alone)."""
    outs = [[np.asarray(y) for y in one(i)] for i in range(POSE_PROBLEMS)]
    if len(outs[0]) > 5:  # the reference's rho' and r: t, their float32 product
        outs = [o[:5] + [o[5][:, None] * o[6]] for o in outs]
    keys = ("pose H", "pose b", "pose chi", "pose jw", "pose J", "pose t")
    res = {k: np.stack([o[q] for o in outs]) for q, k in enumerate(keys[:3])}
    res.update({k: outs[0][q] for q, k in enumerate(keys) if q >= 3 and q < len(outs[0])})
    return res


def reference(x: dict) -> dict:
    """The reference's outputs on `x` under this process's XLA_FLAGS.  The
    products are called one pose at a time, as the pipeline calls them (a
    batch of 4x4 products compiles to another kernel)."""
    import jax
    import jax.numpy as jnp

    from legoslam_tpu.geometry import se3

    from legoslam_tpu.solver import reprojection, robust

    J = jax.jit
    A, B = x["A"], x["B"]
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)

    def pose_build(T, P, uv, valid):  # legoslam_tpu/solver/lm.py solve_pose's build and chi_fn
        r, Jp = reprojection.pose_only_edge(intr, T, P, uv)
        r = jnp.where(valid[:, None], r, 0.0)
        drho, W = robust.robust_information("huber", r, 5.991)
        W = jnp.where(valid[:, None, None], W, 0.0)
        drho = jnp.where(valid, drho, 0.0)
        JpW = jnp.einsum("eia,eij->eaj", Jp, W)
        H = jnp.einsum("eaj,ejb->ab", JpW, Jp)
        b = -jnp.einsum("e,eia,ei->a", drho, Jp, r)
        chi = 0.5 * jnp.sum(jnp.where(valid, robust.robust_chi2("huber", r, 5.991), 0.0))
        return H, b, chi, jnp.swapaxes(JpW, 1, 2), Jp, drho, r

    def each(fn, *args):
        f = J(fn)
        return np.stack([np.asarray(f(*(a[i] for a in args))) for i in range(N)])

    matvec = lambda M, v: jnp.einsum("...ij,...j->...i", M, v)  # noqa: E731
    transform = J(se3.transform)
    return {
        "matmul 4x4": each(lambda a, b: a @ b, A, B),
        "matmul 3x3": each(lambda a, b: a @ b, A[:, :3, :3], B[:, :3, :3]),
        "matvec 3x3": each(matvec, A[:, :3, :3], x["v"]),
        "sum of 3 squares": each(lambda v: jnp.sum(v * v), x["v"]),
        "division by a constant": np.stack([np.asarray(J(lambda t, c=c: t / c)(x["t2"])) for c in CONSTANTS]),
        "small-angle coefficients": np.stack([np.asarray(c) for c in J(se3._rot_coeffs)(x["t2"])]),
        "prior": each(lambda a, b: se3.se3_orthonormalize(a @ b), A, B),
        "se3_exp": each(se3.se3_exp, x["xi"]),
        "retract": each(se3.retract, B, x["dx"]),
        "transform": np.stack([np.asarray(transform(A[i], x["v"])) for i in range(4)]),
        "sqrt": np.asarray(J(jnp.sqrt)(x["sq"])),
        "solve": each(jnp.linalg.solve, x["D"], x["b"]),
        **pose_outputs(lambda i: J(pose_build)(A[i], x["pose_P"][i], x["pose_uv"][i], x["pose_valid"][i])),
    }


def port(x: dict) -> dict:
    """The port's outputs on `x` (CPU)."""
    import torch

    from legoslam_tpu_torch.geometry import se3
    from legoslam_tpu_torch.ops import rounding
    from legoslam_tpu_torch.pipeline import visual_odometry as vo
    from legoslam_tpu_torch.solver import lm, reprojection

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    A, B = t["A"], t["B"]
    n = lambda a: a.numpy()  # noqa: E731
    return {
        "matmul 4x4": n(rounding.small_matmul(A, B, fused=True)),
        "matmul 3x3": n(rounding.small_matmul(A[:, :3, :3], B[:, :3, :3])),
        "matvec 3x3": n(rounding.small_matvec(A[:, :3, :3], t["v"])),
        "sum of 3 squares": n(rounding.row_sum(t["v"] * t["v"])),
        "division by a constant": np.stack([n(rounding.div_const(t["t2"], c)) for c in CONSTANTS]),
        "small-angle coefficients": np.stack([n(c) for c in se3._rot_coeffs(t["t2"])]),
        "prior": n(vo.constant_velocity_prior(A, B)),
        "se3_exp": n(se3.se3_exp(t["xi"])),
        "retract": n(se3.retract(B, t["dx"])),
        "transform": np.stack([n(se3.transform(A[i], t["v"])) for i in range(4)]),
        "sqrt": n(rounding.sqrt(t["sq"])),
        "solve": np.stack([n(lm.lu_solve(t["D"][i], t["b"][i])) for i in range(N)]),
        **pose_outputs(lambda i: lm.pose_pass(reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0), A[i],
                                              t["pose_P"][i], t["pose_uv"][i], t["pose_valid"][i], "huber", 5.991)),
    }


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def fused_order(x: dict) -> dict:
    """The sequential order with each product after the first fused into a
    multiply-add (what XLA emits where the instruction set has FMA)."""
    def mm(a, b):
        acc = a[..., :, 0, None] * b[..., None, 0, :]
        for q in range(1, a.shape[-1]):
            acc = _fma(a[..., :, q, None] * np.ones_like(acc), b[..., None, q, :] * np.ones_like(acc), acc)
        return acc

    A, B, v = x["A"], x["B"], x["v"]
    return {"matmul 4x4": mm(A, B), "matmul 3x3": mm(A[:, :3, :3], B[:, :3, :3]),
            "matvec 3x3": mm(A[:, :3, :3], v[:, :, None])[..., 0], "sum of 3 squares": mm(v[:, None, :], v[:, :, None])[:, 0, 0]}


def cholesky(D, b):
    """A Cholesky solve in float32, each product subtracted in turn."""
    f = np.float32
    n = len(b)
    L = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1):
            s = D[i, j]
            for q in range(j):
                s = f(s - f(L[i, q] * L[j, q]))
            L[i, j] = np.sqrt(max(s, f(1e-30))) if i == j else f(s / L[j, j])
    y = np.zeros(n, np.float32)
    for i in range(n):
        s = b[i]
        for q in range(i):
            s = f(s - f(L[i, q] * y[q]))
        y[i] = f(s / L[i, i])
    x = np.zeros(n, np.float32)
    for i in range(n - 1, -1, -1):
        s = y[i]
        for q in range(i + 1, n):
            s = f(s - f(L[q, i] * x[q]))
        x[i] = f(s / L[i, i])
    return x


def pose_sums_of(ref: dict):
    """The first pose problem's H and -b summed by `rounding.pose_sums` from
    a setting's own per-edge rows."""
    import torch

    from legoslam_tpu_torch.ops import rounding

    jw, J, t = (torch.from_numpy(np.ascontiguousarray(ref[k])) for k in ("pose jw", "pose J", "pose t"))
    H, b, _ = rounding.pose_sums(jw, J, t, torch.zeros(jw.shape[0]))
    return H.numpy(), -b.numpy()


def gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def relative_gap(x, ref) -> float:
    """The solve's largest gap relative to each solution's largest entry."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref).max(-1) / np.abs(ref).max(-1)).max())


def run_settings(x: dict, what: str = "pose") -> dict:
    """The reference's outputs (`reference`, or with what="sampler"
    `sampler_reference`) under each setting, each in a process of its own."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), **x)
        for name in SETTINGS:
            path = os.path.join(tmp, f"{name}.npz")
            flags = os.environ.get("XLA_FLAGS", "") + (f" --xla_cpu_max_isa={ISA[name]}" if ISA[name] else "")
            subprocess.run([sys.executable, "-m", "tests.rounding_probe", os.path.join(tmp, "in.npz"), path, what],
                           check=True, env={**os.environ, "XLA_FLAGS": flags.strip(), "JAX_PLATFORMS": "cpu"})
            out[name] = dict(np.load(path))
    return out


def sampler_inputs(seed: int = 3) -> dict:
    """The levels of SAMPLER_PYRAMIDS (the port's pyramids of random
    images) and SAMPLER_LANES window centres on each, some off the image."""
    import torch

    from legoslam_tpu_torch.ops import pyramid

    rng = np.random.default_rng(seed)
    x = {}
    for shape, levels in SAMPLER_PYRAMIDS:
        img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
        for lvl in pyramid.build_pyramid(img, levels):
            H, W = lvl.shape
            if H == 0 or W == 0:
                continue
            x[f"img {H}x{W}"] = lvl.numpy()
            x[f"centres {H}x{W}"] = np.stack([rng.uniform(-3, W + 3, SAMPLER_LANES),
                                               rng.uniform(-3, H + 3, SAMPLER_LANES)], -1).astype(np.float32)
    return x


def sampler_reference(x: dict) -> dict:
    """The reference's `sample_patches_matmul` on every level and
    half-patch, under this process's XLA_FLAGS."""
    import jax.numpy as jnp

    from legoslam_tpu.ops import interp

    out = {}
    for key in x:
        if key.startswith("img "):
            shape = key[4:]
            for h in SAMPLER_HALF_PATCHES:
                out[f"{shape} h{h}"] = np.asarray(interp.sample_patches_matmul(
                    jnp.asarray(x[key]), jnp.asarray(x[f"centres {shape}"]), 2 * h + 3))
    return out


def probe_sampler() -> None:
    import torch

    from legoslam_tpu_torch.ops import interp

    x = sampler_inputs()
    refs = run_settings(x, "sampler")
    rule = interp.FUSED_ROW_SHAPES
    print(f"sampler probe: halo windows of {SAMPLER_LANES} lanes on each level, the reference under XLA's CPU "
          f"settings against the port's row pass unfused and fused (the port fuses on {sorted(rule)})")
    try:
        for q in refs[SETTINGS[0]]:
            shape, h = q.split(" h")
            H, W = map(int, shape.split("x"))
            img, centres = (torch.from_numpy(x[f"{k} {shape}"]) for k in ("img", "centres"))
            rows = {}
            for fused in (False, True):
                interp.FUSED_ROW_SHAPES = frozenset({(H, W)}) if fused else frozenset()
                rows["fused" if fused else "unfused"] = interp.sample_patches(img, centres, 2 * int(h) + 3).numpy()
            interp.FUSED_ROW_SHAPES = rule
            mine = rows["fused" if (H, W) in rule else "unfused"]
            which = {s: [k for k, v in rows.items() if np.array_equal(v, refs[s][q])] or ["neither"] for s in SETTINGS}
            agree = all(np.array_equal(refs[SETTINGS[0]][q], refs[s][q]) for s in SETTINGS[1:])
            print(f"  {shape:>9} h={h}: settings agree {agree}; " + ", ".join(f"{s} {'/'.join(w)}" for s, w in which.items())
                  + "; the port's bits are " + (", ".join(s for s in SETTINGS if np.array_equal(mine, refs[s][q]))
                                                or "none of them"))
    finally:
        interp.FUSED_ROW_SHAPES = rule


def probe_rounding(save: str = None) -> None:
    import torch

    x = inputs()
    refs = run_settings(x)
    mine = port(x)
    fused = fused_order(x)
    print("rounding probe: the reference under XLA's CPU settings against the port "
          f"({N} inputs each; gaps are largest absolute differences)")
    for q in mine:
        agree = all(np.array_equal(refs["unset"][q], refs[s][q]) for s in SETTINGS[1:])
        spread = max(gap(refs[a][q], refs[b][q]) for a in SETTINGS for b in SETTINGS)
        cols = []
        for s in SETTINGS:
            ref = refs[s][q]
            share = f"port order {np.mean(mine[q] == ref):.4f}"
            if q in fused:
                share += f", fused order {np.mean(fused[q] == ref):.4f}"
            rel = f", relative {relative_gap(mine[q], ref):.3g}" if q == "solve" else ""
            cols.append(f"{s}: {share}, port gap {gap(mine[q], ref):.3g}{rel}")
        print(f"  {q:26s} settings agree {agree}, spread {spread:.3g}; " + "; ".join(cols))
    sums = {s: pose_sums_of(refs[s]) for s in SETTINGS}
    print("  pose H and b from each setting's own per-edge rows by rounding.pose_sums (four lanes of fused "
          "multiply-adds): equal to its H " + ", ".join(f"{s} {np.array_equal(sums[s][0], refs[s]['pose H'][0])}"
                                                       for s in SETTINGS)
          + "; to its b " + ", ".join(f"{s} {np.array_equal(sums[s][1], refs[s]['pose b'][0])}" for s in SETTINGS))
    same = {q: [all(np.array_equal(refs["unset"][q][i], refs[s][q][i]) for s in SETTINGS) for i in range(POSE_PROBLEMS)]
            for q in ("pose H", "pose b", "pose chi")}
    print(f"  pose pass over {POSE_PROBLEMS} problems: the settings give the same H, b, chi on "
          + ", ".join(f"{sum(v)}" for v in same.values()) + "; the port (SSE4_2's rows) gives SSE4_2's on "
          + ", ".join(f"{sum(np.array_equal(mine[q][i], refs['SSE4_2'][q][i]) for i in range(POSE_PROBLEMS))}"
                      for q in same))
    chol = np.stack([cholesky(x["D"][i], x["b"][i]) for i in range(N)])
    print(f"  solve: lm.lu_solve equals LAPACK's on {np.mean(np.all(mine['solve'] == refs['unset']['solve'], -1)):.4f} "
          f"of the systems, {np.mean(mine['solve'] == refs['unset']['solve']):.4f} of the entries, largest gap "
          f"{relative_gap(mine['solve'], refs['unset']['solve']):.3g} relative; a Cholesky "
          f"{np.mean(np.all(chol == refs['unset']['solve'], -1)):.4f}, {np.mean(chol == refs['unset']['solve']):.4f}, "
          f"{relative_gap(chol, refs['unset']['solve']):.3g}")
    rng = np.random.default_rng(1)
    sq = rng.uniform(0, 100, 4_000_000).astype(np.float32)
    correct = np.sqrt(sq)  # numpy's float32 sqrt rounds correctly
    vml = torch.sqrt(torch.from_numpy(sq)).numpy()
    from legoslam_tpu_torch.ops import rounding

    via = rounding.sqrt(torch.from_numpy(sq)).numpy()
    print(f"  sqrt on {len(sq)} floats: torch.sqrt misses the correctly rounded root on {np.mean(vml != correct):.5f} "
          f"of them, rounding.sqrt on {np.mean(via != correct):.5f}; jnp.sqrt agrees with it on "
          + ", ".join(f"{s} {np.mean(refs[s]['sqrt'] == np.sqrt(x['sq'])):.4f}" for s in SETTINGS))
    if save:
        np.savez_compressed(save, **{f"in/{k}": v for k, v in x.items()},
                            **{f"{s}/{q}": v for s in SETTINGS for q, v in refs[s].items()})
        print(f"rounding probe: wrote {save} ({os.path.getsize(save)} bytes)")
    probe_sampler()


if __name__ == "__main__":
    src, dst, what = sys.argv[1:4]
    np.savez(dst, **(sampler_reference if what == "sampler" else reference)(dict(np.load(src))))
