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

A configuration may name stage files (`portbench/stages/<name>.py`, the
seam for stages the per-frame records cannot see, such as the loop closer,
which `VisualOdometry.step` runs outside `process_frame`).  A stage file declares:
- `WRAP`: (module, attribute, tag) of each callable of the port to wrap;
  the attribute may be a class's, "Class.method"; a `portbench.<tag>` span
  goes round each call in a traced slice;
- `KEEP`: how many calls of each to keep while `kept` is a dict (the
  window), every call up to that cap, whatever the frame sampling does;
- `keep(args, kwargs, out)`: what to keep of one call, taken when it
  returns; it must not read the device, and gives data only (tensors,
  arrays, numbers, strings, None, dataclasses, and dicts, lists and tuples
  of them; `as_data` refuses anything else, such as a method's `self`),
  with a clone of any tensor the port writes into after the call;
- `GAPS`: the names of the numbers its `replay` gives, which a
  configuration's `limits` may hold;
- `replay(calls, ctx, control=None)`: after the window, with the port's
  state freed, the gaps (name to number) worked out from the kept calls
  (tag to the list of what `keep` gave, through `as_data`); `ctx` carries the
  configuration's settings and camera, the frames handed over and the
  plain reference; with `control` (the reference in a lower precision) its
  outputs stand in the port's place.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
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


def _owner(mod: str, attr: str):
    """The object that holds `attr` ("name" or "Class.name") of the port's
    module `mod`, and the last name."""
    obj = importlib.import_module(f"{_PKG}.{mod}")
    *path, name = attr.split(".")
    for part in path:
        obj = getattr(obj, part)
    return obj, name


def as_data(obj):
    """What a stage file's `keep` gave, with every tensor as a NumPy array
    and every dataclass as a dict of its fields, so nothing of the port's
    objects survives in it; anything that is not data raises."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray, np.generic)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: as_data(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: as_data(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [as_data(v) for v in obj] if isinstance(obj, list) else tuple(as_data(v) for v in obj)
    raise TypeError(f"a stage file kept a {type(obj).__module__}.{type(obj).__qualname__}, which is not data")


class Hooks:
    def __init__(self, stages: Sequence = ()):
        self.spans = False
        self.sync = False
        self.record: Optional[Dict] = None
        self.kernel_log: Optional[List] = None
        self.stages = tuple(stages)  # the configuration's stage files
        self.kept: Optional[Dict[str, List]] = None
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
        for st in self.stages:
            for mod, attr, tag in st.WRAP:
                self._wrap(*_owner(mod, attr), self._kept(tag, int(st.KEEP), st.keep))
        return self

    def remove(self) -> None:
        """Put back every attribute as it was: the same object, or none
        where the attribute was inherited."""
        for owner, name, raw, own in reversed(self._saved):
            if own:
                setattr(owner, name, raw)
            else:
                delattr(owner, name)
        self._saved = []

    def _wrap(self, owner, name: str, make: Callable) -> None:
        raw = inspect.getattr_static(owner, name)
        self._saved.append((owner, name, raw, name in vars(owner)))
        if isinstance(raw, (staticmethod, classmethod)):
            fn = raw.__func__
            setattr(owner, name, type(raw)(functools.wraps(fn)(make(fn))))
        else:
            setattr(owner, name, functools.wraps(raw)(make(raw)))

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

    def _kept(self, tag: str, cap: int, keep: Callable):
        def make(fn):
            def wrapper(*args, **kw):
                out = self._span(tag, fn, args, kw)
                if self.kept is not None:
                    calls = self.kept.setdefault(tag, [])
                    if len(calls) < cap:
                        calls.append(keep(args, kw, out))
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
