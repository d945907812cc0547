"""The control: the reference computed in TF32, the precision next below
the configuration's float32 (TF32 off).  Under `TF32()` every float32
tensor a torch function returns is rounded to TF32's 10 explicit mantissa
bits (to nearest, ties to even), as a pipeline that keeps its
intermediates in TF32 would hold them; float64 and integer results are
left alone."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding only TF32's bits (non-finite values kept)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _round(out):
    if isinstance(out, torch.Tensor):
        return round_tf32(out) if out.dtype == torch.float32 and not out.requires_grad else out
    if type(out).__module__ == "torch.return_types":
        return type(out)([_round(o) for o in out])
    if type(out) is tuple:
        return tuple(_round(o) for o in out)
    if isinstance(out, list):
        return [_round(o) for o in out]
    return out


class TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name.endswith("_") or name.startswith("__set") or name.startswith("__i"):
            return out  # in-place: the tensor written keeps what it holds
        return _round(out)


class Control:
    """The reference `ref` put in the port's place, under TF32: passed to
    `check.replay(control=...)`, it runs each stage's `compute(ref)` with
    its inputs and every intermediate rounded to TF32."""

    def __init__(self, ref):
        self.ref = ref

    def __call__(self, compute):
        with TF32():
            return compute(self.ref)
