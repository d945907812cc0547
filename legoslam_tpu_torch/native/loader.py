"""ctypes bindings for the native PNG decode + prefetch loader (loader.cpp;
twin of legoslam_tpu/native/loader.py, with the same C API).

The library is built on first use with

    g++ -O3 -shared -fPIC -std=c++14 loader.cpp -o <lib> -lz -lpthread

into `legoslam_tpu_torch/_build/libpngloader-<hash>.so`, where the hash
covers the source and the command.  `buildable()` says whether this machine
has the compiler and zlib's header; where it does, a failed build raises.
Where it does not, `available()` is False and `KittiDataset` decodes with
utils/png.py instead."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++14"]
LIBS = ["-lz", "-lpthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_buildable: Optional[bool] = None


def buildable() -> bool:
    """g++ is present and finds zlib's header (asked once per process)."""
    global _buildable
    if _buildable is None:
        _buildable = shutil.which("g++") is not None and subprocess.run(
            ["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n", capture_output=True, text=True,
            timeout=60).returncode == 0
    return _buildable


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpngloader-{digest}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", tmp, *LIBS], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None or not buildable():
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        lib.ls_loader_open.restype = ctypes.c_void_p
        lib.ls_loader_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.ls_loader_next.restype = ctypes.c_int
        lib.ls_loader_next.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p, ctypes.c_int]
        lib.ls_loader_close.argtypes = [ctypes.c_void_p]
        lib.ls_decode_png.restype = ctypes.c_int
        lib.ls_decode_png.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, i32p, i32p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """The library is built and loaded (False only where it is not `buildable`)."""
    return _load() is not None


def decode_png(path: str, half: bool = False) -> Optional[np.ndarray]:
    """Decode one PNG to float32 grayscale (optionally half resolution)."""
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if not lib.ls_decode_png(path.encode(), None, 0, ctypes.byref(w), ctypes.byref(h), int(half)):
        return None
    buf = np.empty(w.value * h.value, np.float32)
    ok = lib.ls_decode_png(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size,
                           ctypes.byref(w), ctypes.byref(h), int(half))
    return buf.reshape(h.value, w.value) if ok else None


class PrefetchLoader:
    """In-order prefetching reader over a KITTI image_0/image_1 directory pair."""

    def __init__(self, dataset_dir: str, start: int = 0, count: int = 1 << 20,
                 half: bool = True, workers: int = 4, prefetch: int = 8,
                 max_pixels: int = 4096 * 4096):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable: g++ or zlib.h is missing")
        self._lib = lib
        self._handle = lib.ls_loader_open(dataset_dir.encode(), start, count, int(half), workers, prefetch)
        self._cap = max_pixels
        self._left = np.empty(max_pixels, np.float32)
        self._right = np.empty(max_pixels, np.float32)

    def next(self) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        idx, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        f32p = ctypes.POINTER(ctypes.c_float)
        ok = self._lib.ls_loader_next(self._handle, self._left.ctypes.data_as(f32p),
                                      self._right.ctypes.data_as(f32p), ctypes.byref(idx), ctypes.byref(w),
                                      ctypes.byref(h), self._cap)
        if not ok:
            return None
        n, shape = w.value * h.value, (h.value, w.value)
        return idx.value, self._left[:n].reshape(shape).copy(), self._right[:n].reshape(shape).copy()

    def close(self) -> None:
        if self._handle:
            self._lib.ls_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
