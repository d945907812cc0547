"""The frontend's rounding, the same on a CPU and on a card (ROADMAP C19, C4).

The fixture (tests/data/rounding_probe.npz, written by `python -m
tests.ba_parity_report --probe-rounding --save OUT`) holds seeded inputs
and the JAX reference's outputs under XLA's three CPU settings
(`--xla_cpu_max_isa` unset, AVX2, SSE4_2) for the pose's small products
and one pass of its normal equations (tests/rounding_probe.py).  Where the settings agree, the port
(legoslam_tpu_torch/ops/rounding.py and what is built on it) gives their
bits; where they part (multiply-adds fused under unset and AVX2, not under
SSE4_2), it gives SSE4_2's bits, within the settings' spread of the other
two.  The reference runs live under this host's setting and must give one
setting's stored bits, which guards the fixture.

The pose's edge sums (`rounding.pose_sums`) are held against explicit
loops and float64, and the fused multiply-add they and the pose
composition use (`rounding.fma`) against exact arithmetic and the kernel's
`__fmaf_rn` on float32 midpoints; the damped 6x6 solve (`lm.lu_solve`) against
`jnp.linalg.solve`, which no explicit elimination reproduces bit for bit,
within 1e-6 of the solution's largest entry (the probe's largest gap:
3.1e-7); `small_matmul`'s orders and `rounding.sqrt` against exact
arithmetic.  The pose kernel's own arithmetic (csrc/pose.cu's per-edge
terms, its pass's units, chains and sums, its solve and retraction),
compiled for the host by tests/pose_host.py, gives the plain version's
bits.
"""

from __future__ import annotations

import platform
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from legoslam_tpu_torch.geometry import se3
from legoslam_tpu_torch.ops import rounding
from legoslam_tpu_torch.solver import lm, reprojection
from tests import pose_host
from tests import rounding_probe as rp
from tests import torch_parity  # noqa: F401  (caps torch at 2 threads per xdist worker)

FIXTURE = Path(__file__).parent / "data" / "rounding_probe.npz"
SOLVE_BAR = 1e-6  # relative to the solution's largest entry


@pytest.fixture(scope="module")
def probe():
    d = dict(np.load(FIXTURE))
    x = {k[3:]: v for k, v in d.items() if k.startswith("in/")}
    refs = {s: {k[len(s) + 1:]: v for k, v in d.items() if k.startswith(f"{s}/")} for s in rp.SETTINGS}
    return {"x": x, "refs": refs, "port": rp.port(x)}


def test_fixture_is_the_reference(probe):
    """The reference live under this host's setting gives one stored
    setting's bits on every quantity, and the stored inputs are the seed's."""
    x = rp.inputs()
    assert all(np.array_equal(x[k], probe["x"][k]) for k in x)
    live = rp.reference(probe["x"])
    same = [s for s in rp.SETTINGS if all(np.array_equal(live[q], probe["refs"][s][q]) for q in live)]
    assert same, {q: [np.array_equal(live[q], probe["refs"][s][q]) for s in rp.SETTINGS] for q in live}


@pytest.mark.parametrize("quantity", ["matmul 4x4", "matmul 3x3", "matvec 3x3", "sum of 3 squares",
                                      "division by a constant", "small-angle coefficients", "prior", "se3_exp",
                                      "retract", "transform", "sqrt", "pose H", "pose b"])
def test_port_rounds_as_the_reference(probe, quantity):
    """Bit for bit every setting's where they agree; else SSE4_2's (no
    fused multiply-add), and within twice the settings' spread of each."""
    refs, mine = probe["refs"], probe["port"][quantity]
    agree = all(np.array_equal(refs["unset"][quantity], refs[s][quantity]) for s in rp.SETTINGS)
    if agree:
        assert np.array_equal(mine, refs["unset"][quantity])
        return
    assert np.array_equal(mine, refs["SSE4_2"][quantity])
    spread = max(rp.gap(refs[a][quantity], refs[b][quantity]) for a in rp.SETTINGS for b in rp.SETTINGS)
    for s in rp.SETTINGS:
        assert rp.gap(mine, refs[s][quantity]) <= 2 * spread, (s, rp.gap(mine, refs[s][quantity]), spread)


def test_settings_part_on_unfused_products(probe):
    """What the port's choice rests on: the 4x4 product is the same fused
    order under every setting, the 3x3 products and the sum of squares are
    fused under unset and AVX2 only."""
    refs, fused = probe["refs"], rp.fused_order(probe["x"])
    assert all(np.array_equal(fused["matmul 4x4"], refs[s]["matmul 4x4"]) for s in rp.SETTINGS)
    for q in ("matmul 3x3", "matvec 3x3", "sum of 3 squares"):
        assert np.array_equal(fused[q], refs["unset"][q]) and np.array_equal(fused[q], refs["AVX2"][q]), q
        assert not np.array_equal(fused[q], refs["SSE4_2"][q]), q


def test_pose_sums_are_the_references(probe):
    """The pose pass's H is summed in the same order under every setting:
    `rounding.pose_sums` gives each setting's H from that setting's own
    per-edge rows, and SSE4_2's b from SSE4_2's rows.  Chi, whose order no
    lane-and-tree layout tried reproduces, is held within 1e-6."""
    refs = probe["refs"]
    assert np.array_equal(rp.pose_sums_of(refs["SSE4_2"])[1], refs["SSE4_2"]["pose b"][0])
    for s in rp.SETTINGS:
        assert np.array_equal(rp.pose_sums_of(refs[s])[0], refs[s]["pose H"][0]), s
        chi = refs[s]["pose chi"].astype(np.float64)
        assert np.all(np.abs(probe["port"]["pose chi"] - chi) <= 1e-6 * chi), s


def test_lu_solve_against_jnp_linalg_solve(probe):
    """`lm.lu_solve` on the damped 6x6 systems within SOLVE_BAR of LAPACK's
    LU (the same under every setting)."""
    ref = probe["refs"]["unset"]["solve"]
    assert all(np.array_equal(ref, probe["refs"][s]["solve"]) for s in rp.SETTINGS)
    assert rp.relative_gap(probe["port"]["solve"], ref) <= SOLVE_BAR


def test_small_matmul_and_row_sum_orders():
    """Each element the sequential sum of its products, one rounding per
    op (fused: each product after the first in one rounding)."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 3, (64, 4, 4)).astype(np.float32)
    b = rng.normal(0, 3, (64, 4, 4)).astype(np.float32)
    f = np.float32
    want = np.zeros_like(a)
    want_f = np.zeros_like(a)
    for n in range(64):
        for i in range(4):
            for k in range(4):
                acc = f(a[n, i, 0] * b[n, 0, k])
                acc_f = acc
                for q in range(1, 4):
                    acc = f(acc + f(a[n, i, q] * b[n, q, k]))
                    acc_f = _round_f32(Fraction(float(a[n, i, q])) * Fraction(float(b[n, q, k]))
                                       + Fraction(float(acc_f)))
                want[n, i, k], want_f[n, i, k] = acc, acc_f
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.array_equal(rounding.small_matmul(ta, tb).numpy(), want)
    assert np.array_equal(rounding.small_matmul(ta, tb, fused=True).numpy(), want_f)
    v = a[:, 0, :3]
    assert np.array_equal(rounding.row_sum(torch.from_numpy(v)).numpy(), (v[:, 0] + v[:, 1]) + v[:, 2])


def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x), int(np.asarray(y).view(np.int32)) & 1))


def test_sqrt_rounds_correctly():
    """`rounding.sqrt` is numpy's correctly rounded float32 root on random
    bit patterns (torch.sqrt on a CPU with MKL is not)."""
    bits = np.random.default_rng(5).integers(0, 0x7F800000, 200_000, dtype=np.int64).astype(np.int32)
    x = bits.view(np.float32)
    assert np.array_equal(rounding.sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))


def _sequential(x: np.ndarray) -> np.ndarray:
    """x[0] + x[1] + ... along axis 0, one float32 add at a time."""
    acc = np.zeros_like(x[0])
    for row in x:
        acc = (acc + row).astype(np.float32)
    return acc


def _lanes(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Four lanes by k mod 4 of exact-then-rounded multiply-adds x[k] y[k]
    over the rows k of (K, n) x and y."""
    lanes = np.zeros((4, x.shape[1]), np.float32)
    for k in range(x.shape[0]):
        for q in range(x.shape[1]):
            lanes[k % 4, q] = _round_f32(Fraction(float(x[k, q])) * Fraction(float(y[k, q]))
                                         + Fraction(float(lanes[k % 4, q])))
    return lanes


@pytest.mark.parametrize("E", [1, 37, 512])
def test_pose_sums_orders(E):
    """`rounding.pose_sums`: H in four lanes of fused multiply-adds, added
    (l0 + l1) + (l2 + l3), b's rounded products and chi sequential, against
    explicit loops in exact arithmetic; within 1e-6 of float64; an odd E as
    the same edges with a zero edge appended."""
    rng = np.random.default_rng(E)
    jw, J = (rng.normal(0, 50, (E, 2, 6)).astype(np.float32) for _ in range(2))
    t = rng.normal(0, 5, (E, 2)).astype(np.float32)
    m = rng.uniform(0, 10, E).astype(np.float32)
    H, b, chi = (x.numpy() for x in rounding.pose_sums(*(torch.from_numpy(a) for a in (jw, J, t, m))))
    K = 2 * E
    lh = _lanes(np.repeat(jw.reshape(K, 6), 6, axis=1), np.tile(J.reshape(K, 6), (1, 6))).reshape(4, 6, 6)
    assert np.array_equal(H, (lh[0] + lh[1]) + (lh[2] + lh[3]))
    assert np.array_equal(b, _sequential((J * t[..., None]).reshape(-1, 6))) and chi == _sequential(m[:, None])[0]
    f64 = {k: v.astype(np.float64) for k, v in (("jw", jw), ("J", J), ("t", t))}
    ref = np.einsum("eja,ejc->ac", f64["jw"], f64["J"])
    assert np.all(np.abs(H - ref) <= 1e-6 * np.einsum("eja,ejc->ac", np.abs(f64["jw"]), np.abs(f64["J"])))
    ref_b = np.einsum("eja,ej->a", f64["J"], f64["t"])
    assert np.all(np.abs(b - ref_b) <= 1e-6 * np.einsum("eja,ej->a", np.abs(f64["J"]), np.abs(f64["t"])))
    if E % 2:
        pad = [np.concatenate([a, np.zeros_like(a[:1])]) for a in (jw, J, t, m)]
        Hp, bp, chip = (x.numpy() for x in rounding.pose_sums(*(torch.from_numpy(a) for a in pad)))
        assert np.array_equal(Hp, H) and np.array_equal(bp, b) and chip == chi


def _midpoint_cases(n: int = 64, seed: int = 7):
    """float32 (a, b, c) whose float64 a*b + c is a float32 midpoint that
    the exact value misses by 2^-36 or 2^-33 of the float32 step h:
    for c with an even last bit a*b = h (1 + 2^-36) (a = 1 + 2^-12, b =
    h (1 - 2^-12 + 2^-24)), where the float64 sum's tie rounds to c and
    the exact value away from it; for c odd a*b = h (1 - 2^-33) (a = 1 -
    2^-11, b = h (1 + 2^-11 + 2^-22)), the other way round."""
    rng = np.random.default_rng(seed)
    mag = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    odd = (mag.view(np.int32) & 1) == 1
    h = np.spacing(mag).astype(np.float64) / 2
    a = np.where(odd, 1 - 2.0 ** -11, 1 + 2.0 ** -12)
    b = h * np.where(odd, 1 + 2.0 ** -11 + 2.0 ** -22, 1 - 2.0 ** -12 + 2.0 ** -24)
    sign = rng.choice([-1.0, 1.0], n)
    return a.astype(np.float32), (sign * b).astype(np.float32), (sign * mag).astype(np.float32)


def _exact_fma(a, b, c) -> np.ndarray:
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def test_fma_rounds_once():
    """`rounding.fma`, `small_matmul(fused=True)` and `pose_sums`' H chains
    round a multiply-add once, on midpoints where the float64 sum rounded
    to float32 (twice) misses, and on random operands."""
    a, b, c = _midpoint_cases()
    want = _exact_fma(a, b, c)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.any(twice == want)  # every case is one
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    assert np.array_equal(rounding.fma(ta, tb, tc).numpy(), want)
    A = torch.stack([torch.ones_like(ta), ta], -1)[:, None, :]  # (n, 1, 2) @ (n, 2, 1): fma(a, b, 1 * c)
    B = torch.stack([tc, tb], -1)[:, :, None]
    assert np.array_equal(rounding.small_matmul(A, B, fused=True)[:, 0, 0].numpy(), want)
    for q in range(4):  # H[0, 0]'s lane 0: c, then fma(a, b, c) two edges on
        jw, J = np.zeros((3, 2, 6), np.float32), np.zeros((3, 2, 6), np.float32)
        jw[0, 0, 0], J[0, 0, 0] = 1.0, c[q]
        jw[2, 0, 0], J[2, 0, 0] = a[q], b[q]
        H, _, _ = rounding.pose_sums(*(torch.from_numpy(x) for x in (jw, J)), torch.zeros(3, 2), torch.zeros(3))
        assert H[0, 0].item() == want[q], q
    rng = np.random.default_rng(8)
    a, b, c = (rng.normal(0, 1, 400) * 2.0 ** rng.integers(-30, 30, 400) for _ in range(3))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    assert np.array_equal(rounding.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy(), _exact_fma(a, b, c))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = pose_host.build(str(tmp_path_factory.mktemp("pose_host")))
    if lib is None:
        pytest.skip("no g++ to compile csrc/pose.cu's arithmetic for the host")
    return lib


def _pose_problem(seed, E):
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 60.0, E)
    P = np.stack([rng.uniform(-0.8, 0.8, E) * z, rng.uniform(-0.3, 0.3, E) * z, z], -1).astype(np.float32)
    T = se3.se3_exp(torch.tensor([0.1, -0.05, 0.3, 0.01, 0.02, -0.01]))
    pc = P @ T[:3, :3].numpy().T + T[:3, 3].numpy()
    uv = np.stack([360 * pc[:, 0] / pc[:, 2] + 310, 360 * pc[:, 1] / pc[:, 2] + 94], -1) + rng.normal(0, 3, (E, 2))
    uv[: E // 10] += rng.normal(0, 30, (E // 10, 2))
    T0 = se3.se3_exp(torch.tensor([0.12, -0.03, 0.25, 0.0, 0.025, 0.0]))
    return T0, torch.from_numpy(P), torch.from_numpy(uv.astype(np.float32)), torch.from_numpy(rng.uniform(size=E) > 0.1)


@pytest.mark.parametrize("E", [37, 300, 512, 777])
def test_kernel_arithmetic_is_the_plain_versions(host, E):
    """csrc/pose.cu's pass (Huber and trivial; its units of 128 edges, its
    chains and their sums), its damped solve (both LM strategies) and its
    retraction (below the small angle, where no sinf is read) give
    `lm.pose_pass`'s, `lm.lu_solve`'s and `se3.retract`'s bits."""
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    T0, P, uv, use = _pose_problem(E, E)
    for robust in (True, False):
        H, b, chi = lm.pose_pass(intr, T0, P, uv, use, "huber" if robust else "trivial", 5.991)
        tot = pose_host.host_pass(host, T0.numpy(), P.numpy(), uv.numpy(), use.numpy(), intr, robust, 5.991)
        assert np.array_equal(tot[:36], H.numpy().reshape(36)) and np.array_equal(tot[36:42], b.numpy())
        assert np.float32(0.5) * tot[42] == chi.item()
        for lam in (1e-3, 10.0, 1e4):
            for strategy1 in (False, True):
                lam_t = torch.tensor(lam, dtype=torch.float32)
                diag = torch.diagonal(H)
                damped = (diag + lam_t * diag if strategy1 else diag + lam_t) + torch.where(diag.abs() <= 1e-12, 1.0, 0.0)
                Hd = H.clone()
                Hd.diagonal().copy_(damped)
                assert np.array_equal(pose_host.host_solve(host, H.numpy(), b.numpy(), lam, strategy1),
                                      lm.lu_solve(Hd, b).numpy()), (robust, lam, strategy1)
    rng = np.random.default_rng(E)
    for _ in range(50):
        T = se3.se3_exp(torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)))
        dx = torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32))
        assert np.array_equal(pose_host.host_retract(host, T.numpy(), dx.numpy()), se3.retract(T, dx).numpy())


@pytest.mark.parametrize("E", [300, 8192])
def test_kernel_global_edges_are_the_plain_versions(host, E):
    """Above the shared copy's capacity csrc/pose.cu's producers read each
    edge from the caller's arrays (its kGlobal instantiation): the pass
    gives `lm.pose_pass`'s bits as the shared copy does, since every sum's
    order is set by the edge index."""
    intr = reprojection.Intrinsics(360.0, 360.0, 310.0, 94.0)
    T0, P, uv, use = _pose_problem(E + 1, E)
    for robust in (True, False):
        H, b, chi = lm.pose_pass(intr, T0, P, uv, use, "huber" if robust else "trivial", 5.991)
        args = (host, T0.numpy(), P.numpy(), uv.numpy(), use.numpy(), intr, robust, 5.991)
        tot = pose_host.host_pass(*args, global_edges=True)
        assert np.array_equal(tot, pose_host.host_pass(*args))
        assert np.array_equal(tot[:36], H.numpy().reshape(36)) and np.array_equal(tot[36:42], b.numpy())
        assert np.float32(0.5) * tot[42] == chi.item()


def test_fma_is_the_kernels(host):
    """`rounding.fma` gives the bits of the kernel's `__fmaf_rn` (the host's
    `fmaf` here) on the midpoint cases and on random operands."""
    a, b, c = _midpoint_cases(4096, seed=9)
    rng = np.random.default_rng(10)
    r = [(rng.normal(0, 1, 100_000) * 2.0 ** rng.integers(-40, 40, 100_000)).astype(np.float32) for _ in range(3)]
    for x, y, z in ((a, b, c), r):
        mine = rounding.fma(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
        assert np.array_equal(mine, pose_host.host_fma(host, x, y, z))


@pytest.mark.skipif(platform.machine().lower() not in ("x86_64", "amd64"), reason="ATen's x86 reduction order")
@pytest.mark.parametrize("threads", [1, 2, 8])
def test_rows_sum_is_the_cpus_sum(threads):
    """`rounding.rows_sum` (scanline stereo's sums over a patch's rows, as
    elementwise ops that a card computes alike) gives the bits of this
    CPU's `torch.sum(x, dim=1)`, which the CPU port used before, at every
    row count of half-patches 0..9 and column counts on both sides of
    ATen's blocks of 32, at several thread counts."""
    rng = np.random.default_rng(threads)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for P in range(1, 20, 2):
            for C in (2, 3, 5, 7, 8, 31, 32, 33, 64, 97, 130):
                for N in (1, 150, 512):
                    x = torch.from_numpy((rng.normal(0, 50, (N, P, C))).astype(np.float32))
                    assert torch.equal(rounding.rows_sum(x), torch.sum(x, dim=1)), (P, C, N)
    finally:
        torch.set_num_threads(before)
