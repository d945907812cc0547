"""Anchored pyramid KLT: the CUDA kernel (csrc/klt_anchored.cu) and its plain
PyTorch version.

`klt_pyramid_anchored_kernel` launches the kernel (CUDA tensors only);
`klt_pyramid_anchored_eager` is the same function written with the ported
ops/klt.py code (any device); `klt_pyramid_anchored` picks one by
`KLTConfig.backend` and the device: "auto" launches the kernel for CUDA
tensors and runs the plain version for CPU tensors, "kernel" and "eager"
force one.  Nothing falls back: a CUDA tensor under "auto" gets the kernel
or an exception.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch anchored pyramid (ops/klt.py:325-380 of the reference)."""
    levels = cfg.levels
    scale_top = cfg.scale ** (levels - 1)
    kp1 = anchor_uv * scale_top
    kp2 = kp2_init * scale_top
    guess = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        # Each level gets the original `valid`, not the previous success.
        kp2, success = klt_ops.klt_level_anchored(anchors[:, level], pyr2[level], kp1, kp2, valid, cfg)
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
        fn.restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, f, f, f, i, f, p, p, p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"klt_pyramid_anchored_kernel: {msg}")


def klt_pyramid_anchored_kernel(
    anchors: torch.Tensor,
    anchor_uv: torch.Tensor,
    pyr2: Sequence[torch.Tensor],
    kp2_init: torch.Tensor,
    valid: torch.Tensor,
    cfg: klt_ops.KLTConfig = klt_ops.KLTConfig(),
    min_zncc: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/klt_anchored.cu: all `cfg.levels` levels and the
    ZNCC gate.  Same contract as `klt_pyramid_anchored_eager`."""
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
    for lvl in pyr2[:levels]:
        _require(lvl.dim() == 2 and lvl.dtype == torch.float32 and lvl.device == dev,
                 "pyramid levels must be 2-D float32 on the same device")

    packed = torch.cat([lvl.reshape(-1) for lvl in pyr2[:levels]])
    sizes = [lvl.numel() for lvl in pyr2[:levels]]
    offsets = [sum(sizes[:k]) for k in range(levels)]
    off_arr = (ctypes.c_longlong * levels)(*offsets)
    h_arr = (ctypes.c_int * levels)(*[lvl.shape[0] for lvl in pyr2[:levels]])
    w_arr = (ctypes.c_int * levels)(*[lvl.shape[1] for lvl in pyr2[:levels]])
    kp_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok_out = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.legoslam_klt_pyramid_anchored(
        anchors.data_ptr(), anchors.shape[1], packed.data_ptr(), off_arr, h_arr, w_arr, levels,
        anchor_uv.data_ptr(), kp2_init.data_ptr(), valid.data_ptr(), n, cfg.half_patch,
        cfg.iterations, float(cfg.eps * cfg.eps), float(cfg.scale),
        float(cfg.scale ** (levels - 1)), int(bool(cfg.inverse)), float(min_zncc),
        kp_out.data_ptr(), ok_out.data_ptr(), stream,
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on `cfg.backend` ("auto" | "kernel" | "eager") and the device."""
    kind = kp2_init.device.type
    if cfg.backend == "eager":
        return klt_pyramid_anchored_eager(anchors, anchor_uv, pyr2, kp2_init, valid, cfg, min_zncc)
    if cfg.backend not in ("auto", "kernel"):
        raise ValueError(f"unknown klt_backend {cfg.backend!r} (auto | kernel | eager)")
    if kind == "cuda":
        return klt_pyramid_anchored_kernel(anchors, anchor_uv, pyr2, kp2_init, valid, cfg, min_zncc)
    if kind == "cpu" and cfg.backend == "auto":
        return klt_pyramid_anchored_eager(anchors, anchor_uv, pyr2, kp2_init, valid, cfg, min_zncc)
    raise RuntimeError(f"klt backend {cfg.backend!r} has no path for {kind} tensors")
