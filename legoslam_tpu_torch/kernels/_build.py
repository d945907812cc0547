"""Build and load the CUDA kernels (csrc/*.cu) as plain-C shared libraries.

Each source is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

plus the source's own flags in SOURCE_FLAGS, into
`legoslam_tpu_torch/_build/lib<name>-<hash>.so`, where the hash covers
the source and the flags, so an edited source is never served a stale
library.  The library is loaded with ctypes; every entry point takes raw
device pointers and the CUDA stream as `void*` and returns the
`cudaError_t` of its launch.  No PyTorch header is compiled, which keeps a
build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# Each kernel rounds as its plain version does, which contracts no
# multiply-add (csrc/klt_anchored.cu and csrc/stereo.cu ask for their one
# fused multiply-add, the bilinear row pass on some image shapes).
SOURCE_FLAGS = {"klt_anchored": ["-fmad=false"], "pose": ["-fmad=false"], "stereo": ["-fmad=false"]}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _flags(name: str):
    return [*NVCC_FLAGS, *SOURCE_FLAGS.get(name, [])]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its `cudaGetLastError`
    after the launch: a refused launch never runs and no later synchronize
    would report it)."""
    if rc != 0:
        fn = lib.legoslam_cuda_error_string
        fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
