"""csrc/stereo.cu compiled for the host, so a CPU test can hold the
kernel's arithmetic against the plain version bit for bit.

The source compiles as C++ under LEGOSLAM_STEREO_HOST: each phase of a
warp runs its 32 lanes one after the other, `__syncwarp` is nothing, and
`__fmaf_rn` / `__fsqrt_rn` are the C library's `fmaf` / `sqrtf` (both
correctly rounded).  Built with g++ at -O2 with -ffp-contract=off (the
kernel's -fmad=false).  What stays the card's alone: the lanes running at
once, and the launch (blocks, shared memory).
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from legoslam_tpu_torch.kernels import stereo as stereo_k
from legoslam_tpu_torch.ops import interp

SOURCE = Path(__file__).resolve().parent.parent / "legoslam_tpu_torch" / "csrc" / "stereo.cu"
FLAGS = ["-O2", "-ffp-contract=off", "-fno-fast-math", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
         "-DLEGOSLAM_STEREO_HOST"]


def build(out_dir: str = None):
    """Compile csrc/stereo.cu for the host; None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = Path(out_dir or tempfile.gettempdir()) / f"legoslam_stereo_host-{digest}.so"
    if not out.exists():
        proc = subprocess.run([gxx, *FLAGS, "-o", str(out), str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on stereo.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.legoslam_stereo_match_host
    fn.restype = ctypes.c_char_p
    fn.argtypes = [p, i, i, i, p, i, i, i, p, p, i, i, i, i, i, f, f, f, f, p, p]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def match(lib, img_l: torch.Tensor, img_r: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor, d_min: float,
          d_max: float, cfg=stereo_k.ScanlineConfig()):
    """`match_kernel`'s arguments as the C entry point takes them (the
    wrapper's own conversions), run through the host build: (uv_r, ok)."""
    d_hi, D = stereo_k.disparities(d_min, d_max)
    L, R = (np.ascontiguousarray(x.numpy(), np.float32) for x in (img_l, img_r))
    kpn = np.ascontiguousarray(kp.numpy(), np.float32)
    vn = np.ascontiguousarray(valid.numpy(), np.uint8)
    n = kpn.shape[0]
    uv = np.zeros((n, 2), np.float32)
    ok = np.zeros(n, np.uint8)
    why = lib.legoslam_stereo_match_host(
        _ptr(L), L.shape[0], L.shape[1], int(interp.fused_rows(L.shape)),
        _ptr(R), R.shape[0], R.shape[1], int(interp.fused_rows(R.shape)),
        _ptr(kpn), _ptr(vn), n, cfg.half_patch, d_hi, D, cfg.refine_iterations,
        stereo_k.f32(cfg.uniqueness), stereo_k.f32(1.0 - cfg.min_zncc), stereo_k.f32(d_min * 0.5),
        stereo_k.f32(d_max * 1.5), _ptr(uv), _ptr(ok))
    if why is not None:
        raise ValueError(why.decode())
    return torch.from_numpy(uv), torch.from_numpy(ok.astype(bool))
