"""Timing (twin of legoslam_tpu/utils/timer.py, the analogue of `lego::Timer`).

PyTorch returns before a CUDA device finishes, so on a CUDA device `Timer`
brackets the work with CUDA events and `toc()` waits for the end event; on
the CPU it reads the host clock.  `CumulativeTimer` aggregates named
sections the way the reference accumulates `t_hessian_cost_` across solver
iterations (problem.cpp:273-358); a section reads the host clock and waits
for the card only where it is given tensors to wait for, as the JAX section
blocks only on the values it is given."""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Dict, Union

import torch


class Timer:
    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self._cuda = torch.device(device).type == "cuda"
        self.tic()

    def tic(self) -> None:
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds since tic(); on CUDA, device time up to now."""
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._start.elapsed_time(end)
        return (time.perf_counter() - self._start) * 1e3


def _cuda_devices(tree: Any) -> set:
    """The CUDA devices of the tensors in a nest of tensors, sequences,
    dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree else set()
    return set()


class CumulativeTimer:
    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, ms: float) -> None:
        self._totals[name] += ms
        self._counts[name] += 1

    def section(self, name: str, block_on: Any = None):
        """`with timers.section(name, block_on):` adds the block's wall time;
        with `block_on`, after waiting for the CUDA devices its tensors live on."""
        return _Section(self, name, block_on)

    def total_ms(self, name: str) -> float:
        return self._totals[name]

    def mean_ms(self, name: str) -> float:
        return self._totals[name] / max(1, self._counts[name])

    def report(self) -> str:
        return "\n".join(
            f"{name}: total={self._totals[name]:.2f} ms, mean={self.mean_ms(name):.3f} ms, n={self._counts[name]}"
            for name in sorted(self._totals))


class _Section:
    def __init__(self, parent: CumulativeTimer, name: str, block_on: Any):
        self._parent, self._name, self._block_on = parent, name, block_on

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for dev in _cuda_devices(self._block_on):
            torch.cuda.synchronize(dev)
        self._parent.add(self._name, (time.perf_counter() - self._t0) * 1e3)
        return False
