"""Timing (twin of legoslam_tpu/utils/timer.py, the analogue of `lego::Timer`).

PyTorch returns before a CUDA device finishes, so on a CUDA device `Timer`
brackets the work with CUDA events and `toc()` waits for the end event; on
the CPU it reads the host clock."""

from __future__ import annotations

import time
from typing import Union

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
