"""csrc/pose.cu's per-edge, solve and retraction arithmetic compiled for the
host, so a CPU test can hold it against the plain version bit for bit.

The kernel's device functions (a producer lane's terms into a ring slot,
`produce_chi` / `produce_rest`, the chains' loads and adds, `unit_group` / `load_group` /
`add_group` for b and chi and `load_h` / `add_h` for H's lanes,
`combine_lanes`, and `lu_factor` / `lu_solve` / `damped_solve`, `retract`
and what they call) are cut from the source as they stand and compiled
with g++ at -O2 with -ffp-contract=off (the kernel's -fmad=false;
`__fmaf_rn` is the C library's `fmaf`, which `host_fma` exposes), around a
harness that runs a pass a unit of four chunks at a time: each chunk's 32
producer lanes, then each chain over the unit, in the groups and through
the addresses the kernel's chain warps use.  The ring's synchronisation
is the card's alone.  `sinf` is the host's, not CUDA's,
so the retraction is exact here only on the small-angle branch.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "legoslam_tpu_torch" / "csrc" / "pose.cu"
FUNCTIONS = ("clamp_min", "clamp_max", "edge_residual", "edge_jacobian", "huber_linear", "huber_rho0", "huber_rho12",
             "load_edge", "produce_chi", "produce_rest",
             "load_group",
             "add_group", "unit_group", "load_h", "add_h", "combine_lanes", "lu_factor", "lu_solve", "damped_solve",
             "retract")

HARNESS = r"""
extern "C" void host_pass(const float* T, const float* pw, const float* uv, const unsigned char* use, int E,
                          float fx, float fy, float cx, float cy, int robust, float delta, int global, float* out) {
  const Intr k{fx, fy, cx, cy};
  float Tr[12];
  for (int q = 0; q < 12; ++q) Tr[q] = T[q];
  std::vector<float> px(E), py(E), pz(E), u(E), v(E);
  std::vector<uint8_t> flag(E);
  for (int e = 0; e < E; ++e) {
    px[e] = pw[3 * e], py[e] = pw[3 * e + 1], pz[e] = pw[3 * e + 2], u[e] = uv[2 * e], v[e] = uv[2 * e + 1];
    flag[e] = use[e] ? kValid : 0;
  }
  const Edges ed{px.data(), py.data(), pz.data(), u.data(), v.data(), pw, uv, flag.data()};
  const auto produce = global ? produce_chi<true> : produce_chi<false>;
  alignas(16) static float unit[kUnit * kSlotFloats];
  const int nu = E > 0 ? (E + kUnit * kChunk - 1) / (kUnit * kChunk) : 1;
  float b[6] = {0.0f}, chi = 0.0f, h[24][6] = {{0.0f}};
  for (int u = 0; u < nu; ++u) {  // a unit's producer lanes, then each chain over it, in the chain warps' groups
    for (int c = 0; c < kUnit; ++c)
      for (int i = 0; i < kChunk; ++i)
        produce_rest(produce(Tr, ed, kChunk * (kUnit * u + c) + i, E, kValid, k, robust != 0, delta,
                                 unit + c * kSlotFloats, i),
                     k, robust != 0, delta, unit + c * kSlotFloats, i);
    for (int j = 0; j < 2 * kUnit; ++j)
      for (int a = 0; a < 6; ++a) {
        float4 q[8];
        load_group<8>(unit_group<8, 2>(unit, kSlotB + a * kBRow, j), q);
        b[a] = add_group<8>(b[a], q);
      }
    for (int j = 0; j < kUnit; ++j) {
      float4 q[8];
      load_group<8>(unit_group<8, 1>(unit, kSlotChi, j), q);
      chi = add_group<8>(chi, q);
    }
    for (int j = 0; j < 4 * kUnit; ++j)
      for (int r = 0; r < 24; ++r) {
        HGroup g;
        load_h(unit + (j / 4) * kSlotFloats, r, j % 4, g);
        add_h(h[r], g);
      }
  }
  for (int a = 0; a < 6; ++a)
    for (int c = 0; c < 6; ++c) out[6 * a + c] = combine_lanes(h[a][c], h[6 + a][c], h[12 + a][c], h[18 + a][c]);
  for (int a = 0; a < 6; ++a) out[36 + a] = -b[a];
  out[42] = chi;
}

extern "C" void host_fma(const float* a, const float* b, const float* c, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = __fmaf_rn(a[i], b[i], c[i]);
}

extern "C" void host_solve(const float* H, const float* b, float lam, int strategy1, float* x) {
  float Hr[36], br[6], xr[6];
  for (int q = 0; q < 36; ++q) Hr[q] = H[q];
  for (int q = 0; q < 6; ++q) br[q] = b[q];
  damped_solve(Hr, br, lam, strategy1 != 0, xr);
  for (int q = 0; q < 6; ++q) x[q] = xr[q];
}

extern "C" void host_retract(const float* T, const float* dx, float* out) {
  float Tr[12], d[6], o[12];
  for (int q = 0; q < 12; ++q) Tr[q] = T[q];
  for (int q = 0; q < 6; ++q) d[q] = dx[q];
  retract(Tr, d, o);
  for (int q = 0; q < 12; ++q) out[q] = o[q];
}
"""

PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __fmaf_rn fmaf
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
"""

def _function(src: str, name: str) -> str:
    """The source text of device function `name` (with a template line
    before it, if any), braces balanced."""
    m = re.search(r"(template <[^>]*>\n)?__(?:host__ __)?device__ [^\n]*?\b" + name + r"\(", src)
    if m is None:
        raise ValueError(f"{name} not found in {SOURCE.name}")
    i = src.index("{", m.end())
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[m.start():j + 1]
    raise ValueError(f"unbalanced braces after {name}")


def _constants(src: str) -> str:
    """The source's constants and Intr, and its Edges, EdgeIn, EdgeAt,
    EdgePass and HGroup structs."""
    start = src.index("constexpr int kCtrlWarp")
    structs = [src[i:src.index("};", i) + 2]
               for i in (src.index(f"struct {name} {{") for name in ("Edges", "EdgeIn", "EdgeAt", "EdgePass", "HGroup"))]
    return src[start:src.index("struct LMParams")] + "\n".join(structs) + "\n"


def build(out_dir: str = None) -> ctypes.CDLL:
    """Compile the harness around pose.cu's functions; None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = SOURCE.read_text()
    body = "\n\n".join(_function(src, n) for n in FUNCTIONS)
    text = PRELUDE + _constants(src) + "\n" + body + "\n" + HARNESS
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = Path(out_dir or tempfile.gettempdir()) / f"legoslam_pose_host-{digest}.so"
    if not out.exists():
        cpp = out.with_suffix(".cpp")
        cpp.write_text(text)
        cmd = [gxx, "-O2", "-ffp-contract=off", "-fno-fast-math", "-std=c++17", "-shared", "-fPIC",
               "-o", str(out), str(cpp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on pose.cu's functions:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_pass.argtypes = [p, p, p, p, i, f, f, f, f, i, f, i, p]
    lib.host_fma.argtypes = [p, p, p, i, p]
    lib.host_solve.argtypes = [p, p, f, i, p]
    lib.host_retract.argtypes = [p, p, p]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _t12(T) -> np.ndarray:
    T = np.asarray(T, np.float32)
    return np.ascontiguousarray(np.concatenate([T[:3, :3].ravel(), T[:3, 3]]), np.float32)


def host_pass(lib, T, p_world, uv, use, intr, robust: bool, delta: float, global_edges: bool = False) -> np.ndarray:
    """The kernel's 43 sums of one pass: H (36, row-major), b (6), chi before
    the 0.5; `global_edges`: its producers read the edges as the kGlobal
    instantiation does, from the caller's arrays."""
    out = np.zeros(44, np.float32)
    pw = np.ascontiguousarray(p_world, np.float32)
    uvc = np.ascontiguousarray(uv, np.float32)
    use8 = np.ascontiguousarray(use, np.uint8)
    lib.host_pass(_ptr(_t12(T)), _ptr(pw), _ptr(uvc), _ptr(use8), len(pw), intr.fx, intr.fy, intr.cx, intr.cy,
                  int(robust), float(np.float32(delta)), int(global_edges), _ptr(out))
    return out[:43]


def host_fma(lib, a, b, c) -> np.ndarray:
    """The kernel's `__fmaf_rn` (the C library's `fmaf`) elementwise."""
    a, b, c = (np.ascontiguousarray(x, np.float32) for x in (a, b, c))
    out = np.zeros(a.shape, np.float32)
    lib.host_fma(_ptr(a), _ptr(b), _ptr(c), a.size, _ptr(out))
    return out


def host_solve(lib, H, b, lam: float, strategy1: bool) -> np.ndarray:
    x = np.zeros(6, np.float32)
    lib.host_solve(_ptr(np.ascontiguousarray(H, np.float32).reshape(36)), _ptr(np.ascontiguousarray(b, np.float32)),
                   float(np.float32(lam)), int(strategy1), _ptr(x))
    return x


def host_retract(lib, T, dx) -> np.ndarray:
    out = np.zeros(12, np.float32)
    lib.host_retract(_ptr(_t12(T)), _ptr(np.ascontiguousarray(dx, np.float32)), _ptr(out))
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = out[:9].reshape(3, 3)
    M[:3, 3] = out[9:]
    return M
