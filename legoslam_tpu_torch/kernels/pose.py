"""Motion-only pose estimation: the CUDA kernel (csrc/pose.cu) and its plain
PyTorch version.

`estimate_pose_kernel` launches the kernel (CUDA tensors only);
`estimate_pose_eager` is solver/lm.py estimate_pose (any device);
`estimate_pose` picks by the tensors' device alone: the kernel for CUDA
tensors, the plain version for CPU tensors, an exception otherwise.
All three take an optional `attempts` tensor, (outer_iterations,) int32,
which is filled with the LM attempts of each round (the work count).
`verify_pose` is the loop closer's entry: `estimate_pose` with
`verification`, picked by device in the same way but not through the
attribute `estimate_pose`, so what wraps that attribute sees tracking's
calls alone; on a card its launches carry the kernel's second name,
`loop_verify_pose_kernel`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from legoslam_tpu_torch.kernels import _build
from legoslam_tpu_torch.solver import lm, reprojection

estimate_pose_eager = lm.estimate_pose
_shared_edges: Dict[Tuple[int, int], int] = {}


def _lib():
    lib = _build.load("pose")
    fn = lib.legoslam_estimate_pose
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, f, f, f, f, f, i, i, i, i, i, i, f, f, f, i, f, p, p, p, p, p, p]
        lib.legoslam_pose_shared_edges.restype = ctypes.c_int
        lib.legoslam_pose_shared_edges.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


def shared_edges(dev: torch.device) -> int:
    """The most edges a launch on `dev` keeps in shared memory (what the
    opt-in shared memory per block leaves beside csrc/pose.cu's ring);
    above it the kernel reads its edges from global memory."""
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    lib = _lib()
    key = (lib._handle, index)  # a build of another source may hold fewer
    if key not in _shared_edges:
        cap = ctypes.c_int()
        with torch.cuda.device(index):
            _build.check(lib, lib.legoslam_pose_shared_edges(ctypes.byref(cap)), "shared_edges")
        _shared_edges[key] = cap.value
    return _shared_edges[key]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"estimate_pose_kernel: {msg}")


def estimate_pose_kernel(
    intr: reprojection.Intrinsics,
    T_init: torch.Tensor,
    p_world: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    *,
    chi2_th: float = 5.991,
    outer_iterations: int = 4,
    drop_kernel_after: int = 2,
    exclude_outliers: bool = True,
    cfg: lm.LMConfig = lm.LMConfig(),
    attempts: Optional[torch.Tensor] = None,
    verification: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of csrc/pose.cu; same contract as `estimate_pose_eager`,
    at any edge count: up to `shared_edges(dev)` edges the kernel copies
    them into shared memory, above it it reads them from global memory,
    with their flags in a scratch of E bytes allocated here."""
    dev = T_init.device
    E = p_world.shape[0]
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(cfg.strategy in ("default", "strategy1"), f"unknown strategy {cfg.strategy!r}")
    _require(T_init.shape == (4, 4) and p_world.shape == (E, 3) and uv.shape == (E, 2)
             and valid.shape == (E,), "shapes must be T (4, 4), p_world (E, 3), uv (E, 2), valid (E,)")
    _require(valid.dtype == torch.bool, "valid must be bool")
    for name, t in (("T_init", T_init), ("p_world", p_world), ("uv", uv)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    for name, t in (("T_init", T_init), ("p_world", p_world), ("uv", uv), ("valid", valid)):
        _require(t.device == dev and t.is_contiguous(), f"{name} must be contiguous on {dev}")

    if attempts is not None:
        _require(attempts.shape == (outer_iterations,) and attempts.dtype == torch.int32
                 and attempts.device == dev and attempts.is_contiguous(),
                 f"attempts must be ({outer_iterations},) int32 on {dev}")
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inlier = torch.empty((E,), dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((E,), dtype=torch.uint8, device=dev) if E > shared_edges(dev) else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.legoslam_estimate_pose(
        T_init.data_ptr(), p_world.data_ptr(), uv.data_ptr(), valid.data_ptr(), E,
        intr.fx, intr.fy, intr.cx, intr.cy, float(chi2_th), cfg.iterations, outer_iterations,
        drop_kernel_after, int(bool(exclude_outliers)), int(bool(verification)), int(cfg.strategy == "strategy1"),
        float(cfg.tau), float(cfg.max_diag_cap), float(cfg.diff_chi_threshold),
        cfg.false_cnt_threshold, float(cfg.init_lambda),
        T_out.data_ptr(), inlier.data_ptr(), n_in.data_ptr(),
        None if attempts is None else attempts.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
    )
    _build.check(lib, rc, "estimate_pose_kernel")
    estimate_pose_kernel.launches += 1
    return T_out, inlier, n_in


estimate_pose_kernel.launches = 0


def _by_device(intr, T_init, p_world, uv, valid, **kw):
    kind = T_init.device.type
    if kind == "cuda":
        return estimate_pose_kernel(intr, T_init, p_world, uv, valid, **kw)
    if kind == "cpu":
        return estimate_pose_eager(intr, T_init, p_world, uv, valid, **kw)
    raise RuntimeError(f"estimate_pose has no path for {kind} tensors")


def estimate_pose(intr, T_init, p_world, uv, valid, **kw):
    """Dispatch on the device: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    return _by_device(intr, T_init, p_world, uv, valid, **kw)


def verify_pose(intr, T_init, p_world, uv, valid, **kw):
    """The loop verifier's pose: `estimate_pose(..., verification=True)`,
    dispatched on the device without going through `estimate_pose`."""
    return _by_device(intr, T_init, p_world, uv, valid, verification=True, **kw)
