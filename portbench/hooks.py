"""Wrappers the benchmark installs around the port's module functions,
from its own files: `process_frame` looks each of them up as a module
attribute when it calls it, so nothing of the port is edited.

Three uses, each off unless asked for:
- `spans`: a `torch.profiler.record_function` span named
  "portbench.<tag>" around the call, ending in a synchronize, so a span
  covers the device work it issued (traced runs only);
- `record`: for the frames the harness samples, the state each covered
  stage was handed and what it returned, kept by reference (the port's
  stage functions write into none of their inputs), for the comparison
  with the reference after the window;
- `kernel_log`: the inputs and outputs of every K1 and K2 call in the
  traced slice, for the rooflines.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, List, Optional

import torch

_PKG = "legoslam_tpu_torch"
# (module, function, tag): the stages the comparison covers.
STAGES = (
    ("pipeline.frontend", "stereo_init", "init"),
    ("pipeline.frontend", "track_last_frame", "track"),
    ("pipeline.frontend", "estimate_current_pose", "pose"),
    ("pipeline.frontend", "insert_keyframe", "insert"),
    ("pipeline.backend", "ba_step", "ba"),
)
# Finer spans, for the breakdown's idle gaps.
SPANS = (
    ("pipeline.frontend", "detect_features", "detect"),
    ("pipeline.frontend", "find_features_in_right", "stereo"),
    ("pipeline.frontend", "triangulate_new_points", "triangulate"),
    ("pipeline.backend", "build_problem", "ba_problem"),
    ("solver.lm", "solve_ba", "lm_solve"),
)
# The calls that launch K1 and K2 on a card.
KERNELS = (
    ("ops.klt", "klt_pyramid_anchored", "k1_anchored"),
    ("ops.klt", "klt_pyramid", "k1_frame"),
    ("kernels.pose", "estimate_pose", "k2"),
)


class Hooks:
    def __init__(self):
        self.spans = False
        self.sync = False
        self.record: Optional[Dict] = None
        self.kernel_log: Optional[List] = None
        self._saved = []

    def install(self) -> "Hooks":
        vo = importlib.import_module(f"{_PKG}.pipeline.visual_odometry")
        self._wrap(vo, "process_frame", self._frame)
        for mod, name, tag in STAGES:
            self._wrap(importlib.import_module(f"{_PKG}.{mod}"), name, self._stage(tag))
        for mod, name, tag in SPANS:
            self._wrap(importlib.import_module(f"{_PKG}.{mod}"), name, self._stage(tag, keep=False))
        for mod, name, tag in KERNELS:
            self._wrap(importlib.import_module(f"{_PKG}.{mod}"), name, self._kernel(tag))
        return self

    def remove(self) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def _wrap(self, mod, name: str, make: Callable) -> None:
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        setattr(mod, name, functools.wraps(fn)(make(fn)))

    def _frame(self, fn):
        def wrapper(cfg, rig, carry, img_l, img_r, frame_id, *a, **kw):
            if self.record is not None:
                self.record.update(frame_id=int(frame_id), carry_in=carry)
            return fn(cfg, rig, carry, img_l, img_r, frame_id, *a, **kw)
        return wrapper

    def _span(self, tag: str, fn, args, kw):
        if not self.spans:
            return fn(*args, **kw)
        with torch.profiler.record_function(f"portbench.{tag}"):
            out = fn(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
        return out

    def _stage(self, tag: str, keep: bool = True):
        def make(fn):
            def wrapper(*args, **kw):
                out = self._span(tag, fn, args, kw)
                if keep and self.record is not None:
                    self.record.setdefault("stages", {})[tag] = (args, kw, out)
                return out
            return wrapper
        return make

    def _kernel(self, tag: str):
        def make(fn):
            def wrapper(*args, **kw):
                out = fn(*args, **kw)
                if self.kernel_log is not None:
                    self.kernel_log.append((tag, args, kw, out))
                return out
            return wrapper
        return make
