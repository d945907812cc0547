"""Pyramid KLT: the CUDA kernels (csrc/klt_anchored.cu) and their plain
PyTorch versions, anchored and frame mode.

`klt_pyramid_anchored_kernel` / `klt_pyramid_kernel` launch a kernel (CUDA
tensors only); `klt_pyramid_anchored_eager` / `klt_pyramid_eager` are the
same functions written with the ported ops/klt.py code (any device);
`klt_pyramid_anchored` / `klt_pyramid` pick one by `KLTConfig.backend` and
the device: "auto" launches the kernel for CUDA tensors and runs the plain
version for CPU tensors, "kernel" and "eager" force one.  Nothing falls
back: a CUDA tensor under "auto" gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from legoslam_tpu_torch.kernels import _build
from legoslam_tpu_torch.ops import klt as klt_ops

# csrc/klt_anchored.cu is compiled for this template size only.
KERNEL_HALF_PATCH = 3
_MAX_LEVELS = 8


def klt_pyramid_anchored_eager(
    anchors: torch.Tensor,
    anchor_uv: torch.Tensor,
    pyr2: Sequence[torch.Tensor],
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    min_zncc: float = 0.5,
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch anchored pyramid (ops/klt.py:325-380 of the reference).
    `gn_iterations`, if given, is filled with the GN iterations summed over
    lanes and levels."""
    levels = cfg.levels
    if gn_iterations is not None:
        gn_iterations.zero_()
    scale_top = cfg.scale ** (levels - 1)
    kp1 = anchor_uv * scale_top
    kp2 = kp2_init * scale_top
    guess = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        # Each level gets the original `valid`, not the previous success.
        kp2, success = klt_ops.klt_level_anchored(anchors[:, level], pyr2[level], kp1, kp2, valid, cfg,
                                                  gn_iterations)
        if level > 0:
            kp1 = kp1 / cfg.scale
            guess = guess / cfg.scale
            # Failed lanes restart from the initial guess at the next level.
            kp2 = torch.where(success[:, None], kp2 / cfg.scale, guess)
    if min_zncc > 0:
        success = success & klt_ops.zncc_gate(anchors[:, 0, 1:-1, 1:-1], pyr2[0], kp2, min_zncc)
    return kp2, success


def _lib():
    lib = _build.load("klt_anchored")
    fn = lib.legoslam_klt_pyramid_anchored
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, p, p, p, i, i, i, f, f, f, i, f, p, p, p, p]
        fn = lib.legoslam_klt_pyramid_frame
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, i, i, i, f, f, f, i, p, p, p, p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"klt kernel: {msg}")


def _level_arrays(pyr: Sequence[torch.Tensor], levels: int, dev, what: str):
    """The levels as the C arrays the entry points take (pointer, height,
    width per level); each level must be a contiguous 2-D float32 tensor."""
    for k, lvl in enumerate(pyr[:levels]):
        _require(lvl.dim() == 2 and lvl.dtype == torch.float32 and lvl.device == dev
                 and lvl.is_contiguous(), f"{what} level {k} must be a contiguous 2-D float32 tensor on {dev}")
    return ((ctypes.c_void_p * levels)(*[lvl.data_ptr() for lvl in pyr[:levels]]),
            (ctypes.c_int * levels)(*[lvl.shape[0] for lvl in pyr[:levels]]),
            (ctypes.c_int * levels)(*[lvl.shape[1] for lvl in pyr[:levels]]))


def _check_counter(gn_iterations: Optional[torch.Tensor], dev) -> None:
    if gn_iterations is not None:
        _require(gn_iterations.shape == (1,) and gn_iterations.dtype == torch.int32
                 and gn_iterations.device == dev, f"gn_iterations must be (1,) int32 on {dev}")
        gn_iterations.zero_()


def klt_pyramid_anchored_kernel(
    anchors: torch.Tensor,
    anchor_uv: torch.Tensor,
    pyr2: Sequence[torch.Tensor],
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    min_zncc: float = 0.5,
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/klt_anchored.cu: all `cfg.levels` levels and the
    ZNCC gate.  Same contract as `klt_pyramid_anchored_eager`; the levels
    are passed as separate pointers, so each must be contiguous."""
    n = kp2_init.shape[0]
    levels = cfg.levels
    dev = kp2_init.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(cfg.half_patch == KERNEL_HALF_PATCH, f"half_patch must be {KERNEL_HALF_PATCH}")
    _require(1 <= levels <= _MAX_LEVELS and len(pyr2) >= levels, "bad level count")
    halo = 2 * cfg.half_patch + 3
    _require(anchors.dim() == 4 and anchors.shape[0] == n and anchors.shape[1] >= levels
             and anchors.shape[2:] == (halo, halo), f"anchors must be (N, >={levels}, {halo}, {halo})")
    _require(anchor_uv.shape == (n, 2) and kp2_init.shape == (n, 2), "anchor_uv / kp2_init must be (N, 2)")
    _require(valid.shape == (n,) and valid.dtype == torch.bool, "valid must be (N,) bool")
    for name, t in (("anchors", anchors), ("anchor_uv", anchor_uv), ("kp2_init", kp2_init), ("valid", valid)):
        _require(t.device == dev and t.is_contiguous(), f"{name} must be contiguous on {dev}")
    for name, t in (("anchors", anchors), ("anchor_uv", anchor_uv), ("kp2_init", kp2_init)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    lvl_ptr, h_arr, w_arr = _level_arrays(pyr2, levels, dev, "pyramid")
    _check_counter(gn_iterations, dev)
    kp_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok_out = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.legoslam_klt_pyramid_anchored(
        anchors.data_ptr(), anchors.shape[1], lvl_ptr, h_arr, w_arr, levels,
        anchor_uv.data_ptr(), kp2_init.data_ptr(), valid.data_ptr(), n, cfg.half_patch,
        cfg.iterations, float(cfg.eps * cfg.eps), float(cfg.scale),
        float(cfg.scale ** (levels - 1)), int(bool(cfg.inverse)), float(min_zncc),
        kp_out.data_ptr(), ok_out.data_ptr(),
        None if gn_iterations is None else gn_iterations.data_ptr(), stream,
    )
    _build.check(lib, rc, "klt_pyramid_anchored_kernel")
    klt_pyramid_anchored_kernel.launches += 1
    return kp_out, ok_out


klt_pyramid_anchored_kernel.launches = 0


def klt_pyramid_anchored(
    anchors: torch.Tensor,
    anchor_uv: torch.Tensor,
    pyr2: Sequence[torch.Tensor],
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    min_zncc: float = 0.5,
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on `cfg.backend` ("auto" | "kernel" | "eager") and the device."""
    args = (anchors, anchor_uv, pyr2, kp2_init, valid, cfg, min_zncc, gn_iterations)
    return _dispatch(klt_pyramid_anchored_kernel, klt_pyramid_anchored_eager, cfg.backend,
                     kp2_init.device.type, args)


# --- frame mode ---------------------------------------------------------------

def klt_pyramid_eager(
    pyr1: Sequence[torch.Tensor],
    pyr2: Sequence[torch.Tensor],
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch frame-mode pyramid (ops/klt.py:179-226 of the
    reference).  `gn_iterations`, if given, is filled with the GN iterations
    summed over lanes and levels."""
    levels = cfg.levels
    if gn_iterations is not None:
        gn_iterations.zero_()
    scale_top = cfg.scale ** (levels - 1)
    kp1_pyr = kp1 * scale_top
    kp2_pyr = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        kp2_pyr, success = klt_ops.klt_level(pyr1[level], pyr2[level], kp1_pyr, kp2_pyr, valid, cfg,
                                             gn_iterations)
        if level > 0:
            # Upscale; failed lanes restart from kp1 at the next level.
            kp1_pyr = kp1_pyr / cfg.scale
            kp2_pyr = torch.where(success[:, None], kp2_pyr / cfg.scale, kp1_pyr)
    return kp2_pyr, success


def klt_pyramid_kernel(
    pyr1: Sequence[torch.Tensor],
    pyr2: Sequence[torch.Tensor],
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/klt_anchored.cu's frame-mode kernel: the templates
    sampled from `pyr1` inside the launch, all `cfg.levels` levels, failed
    lanes restarted from kp1.  Same contract as `klt_pyramid_eager`."""
    n = kp1.shape[0]
    levels = cfg.levels
    dev = kp1.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(cfg.half_patch == KERNEL_HALF_PATCH, f"half_patch must be {KERNEL_HALF_PATCH}")
    _require(1 <= levels <= _MAX_LEVELS and len(pyr1) >= levels and len(pyr2) >= levels, "bad level count")
    _require(kp1.shape == (n, 2) and kp2_init.shape == (n, 2), "kp1 / kp2_init must be (N, 2)")
    _require(valid.shape == (n,) and valid.dtype == torch.bool, "valid must be (N,) bool")
    for name, t in (("kp1", kp1), ("kp2_init", kp2_init), ("valid", valid)):
        _require(t.device == dev and t.is_contiguous(), f"{name} must be contiguous on {dev}")
    for name, t in (("kp1", kp1), ("kp2_init", kp2_init)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    ptr1, h1, w1 = _level_arrays(pyr1, levels, dev, "first pyramid")
    ptr2, h2, w2 = _level_arrays(pyr2, levels, dev, "second pyramid")
    _check_counter(gn_iterations, dev)

    kp_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok_out = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.legoslam_klt_pyramid_frame(
        ptr1, h1, w1, ptr2, h2, w2, levels, kp1.data_ptr(), kp2_init.data_ptr(), valid.data_ptr(), n,
        cfg.half_patch, cfg.iterations, float(cfg.eps * cfg.eps), float(cfg.scale),
        float(cfg.scale ** (levels - 1)), int(bool(cfg.inverse)), kp_out.data_ptr(), ok_out.data_ptr(),
        None if gn_iterations is None else gn_iterations.data_ptr(), stream,
    )
    _build.check(lib, rc, "klt_pyramid_kernel")
    klt_pyramid_kernel.launches += 1
    return kp_out, ok_out


klt_pyramid_kernel.launches = 0


def _dispatch(kernel_fn, eager_fn, backend: str, kind: str, args):
    if backend == "eager":
        return eager_fn(*args)
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown klt_backend {backend!r} (auto | kernel | eager)")
    if kind == "cuda":
        return kernel_fn(*args)
    if kind == "cpu" and backend == "auto":
        return eager_fn(*args)
    raise RuntimeError(f"klt backend {backend!r} has no path for {kind} tensors")


def klt_pyramid(
    pyr1: Sequence[torch.Tensor],
    pyr2: Sequence[torch.Tensor],
    kp1: torch.Tensor,
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    gn_iterations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on `cfg.backend` ("auto" | "kernel" | "eager") and the device."""
    args = (pyr1, pyr2, kp1, kp2_init, valid, cfg, gn_iterations)
    return _dispatch(klt_pyramid_kernel, klt_pyramid_eager, cfg.backend, kp1.device.type, args)
