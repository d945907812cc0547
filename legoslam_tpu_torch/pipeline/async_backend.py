"""Asynchronous backend scheduling: window BA overlapped with tracking (twin
of legoslam_tpu/pipeline/async_backend.py).

The reference C++ runs BA on a backend thread that wakes on a condition
variable, optimizes a snapshot of the active map while the frontend keeps
tracking, and writes the result back under per-object mutexes
(backend_lego.cpp:38-54, 198-217).  The JAX package replaces the thread by
asynchronous dispatch.  Here the thread comes back: the port's LM loop
reads the device once per attempt (solver/lm.py), so a solve dispatched on
the calling thread would hold the frame loop for the whole solve.  Each
solve runs on a worker thread of its own; on a card it runs on a side CUDA
stream, so the frame loop's kernels and the solve's interleave on the
device.

- **snapshot**: the world map is functional state (every update makes new
  tensors), so the tensors handed to the solve are the snapshot.  On a
  card the side stream first waits for the main stream's work so far, and
  the snapshot is kept alive until the merge, so the caching allocator
  reuses none of it before the solve has read it.
- **merge**: `backend.merge_ba_result` reconciles the finished result with
  however far the map has moved on.  The main stream waits for the solve's
  event first, and the result's tensors are recorded on the main stream,
  since the merged map keeps some of them.
- **schedule**: the reference's.  A solve is dispatched on a frame cadence
  (`dispatch_every`, default 4), never on a keyframe flag read from the
  device; a cadence tick that arrives while a solve is in flight counts as
  `skipped` (the reference's notify lost mid-solve).  `poll` never blocks:
  it asks whether the worker has returned and, on a card, whether the
  solve's event has completed.

A merge lands when the solve is ready, so two async runs need not give the
same bits, as in the reference.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import torch

from legoslam_tpu_torch.pipeline import backend as backend_mod
from legoslam_tpu_torch.utils import timer



def pick_ba_device(spec: str = "auto", device=None) -> Optional[torch.device]:
    """Resolve the device the BA solve runs on, for a frame loop on `device`.

    "auto": the second card where the frame loop runs on a card and there
    is more than one, else None: the frame loop's own device (on a card, a
    side stream of it).  "none": None.  An integer string picks that card; 0, or
    an index without a card, gives None, as in the reference."""
    device = torch.device(device if device is not None else "cuda")
    if spec == "none" or device.type != "cuda":
        return None
    n = torch.cuda.device_count()
    idx = 1 if spec == "auto" else int(spec)
    return torch.device("cuda", idx) if 0 < idx < n else None


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a (nested) state dataclass, NamedTuple or tuple."""
    if torch.is_tensor(tree):
        return [tree]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for name in tree.__dataclass_fields__ for t in _tensors(getattr(tree, name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _to(result: backend_mod.BAResult, device) -> backend_mod.BAResult:
    """A `BAResult` with its tensors on `device`."""
    def move(x):
        if torch.is_tensor(x):
            return x.to(device)
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return tuple(move(v) for v in x)
        if hasattr(x, "_fields"):
            return type(x)(*(move(v) for v in x))
        return x
    return move(result)


class _Job:
    """One solve in flight: its future, its event on a card, and the
    snapshot it reads (kept alive until the merge)."""

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.future: Future = Future()
        self.event: Optional[torch.cuda.Event] = None

    def ready(self) -> bool:
        return self.future.done() and (self.event is None or self.event.query())


class AsyncBackend:
    """Host-side scheduler for one in-flight window BA.

    Protocol (driven by VisualOdometry.process):
      1. `poll(wmap) -> wmap`: at the top of every frame; if the solve in
         flight has finished, merge it and return the merged map, else the
         map unchanged.  Never blocks.
      2. `observe(kf_inserted)`: after the frame step; counts the frame
         toward the dispatch cadence (the flag is not read).
      3. if `want_dispatch`: `dispatch(wmap)`, a solve of the fresh map.
      4. `flush(wmap) -> wmap`: wait for the solve in flight and merge it
         (end of run, before a checkpoint or a loop correction)."""

    def __init__(self, frontend_cfg, rig, ba_cfg: backend_mod.BAConfig, solve_fn: Optional[Callable] = None,
                 ba_device=None, dispatch_every: int = 4, device=None):
        self.cfg, self.ba_cfg, self.solve_fn = frontend_cfg, ba_cfg, solve_fn
        self.device = torch.device(device) if device is not None else rig.left.pose.device
        self.ba_device = torch.device(ba_device) if ba_device is not None else None
        self.rig = rig.to(self.ba_device) if self.ba_device is not None else rig
        solve_dev = self.ba_device or self.device
        self._stream = torch.cuda.Stream(solve_dev) if solve_dev.type == "cuda" else None
        self.dispatch_every = max(1, int(dispatch_every))
        self.pending: Optional[_Job] = None
        self._frames_since_dispatch = 0
        self.stats: Dict[str, int] = {"dispatched": 0, "merged": 0, "skipped": 0}
        self.merged_stats: List[backend_mod.BAStats] = []

    # --- step 1 ---
    def poll(self, wmap):
        """Merge the pending result if it has finished; never blocks."""
        if self.pending is not None and self.pending.ready():
            return self._do_merge(wmap)
        return wmap

    # --- step 2 ---
    def observe(self, kf_inserted=None) -> None:
        """Count a processed frame toward the dispatch cadence; the
        keyframe flag is accepted for the reference's signature and not
        read."""
        self._frames_since_dispatch += 1
        if self.pending is not None and self._frames_since_dispatch >= self.dispatch_every:
            # A cadence tick while a solve is in flight: the reference's
            # notify dropped during an active solve.
            self.stats["skipped"] += 1
            self._frames_since_dispatch = 0

    @property
    def want_dispatch(self) -> bool:
        return self.pending is None and self._frames_since_dispatch >= self.dispatch_every

    # --- step 3 ---
    def dispatch(self, wmap) -> None:
        """Start a window solve of the current map on a worker thread (the
        reference snapshots at the start of a solve, backend_lego.cpp:45-46)."""
        if self.pending is not None:
            raise RuntimeError("dispatch while a solve is in flight")
        self._frames_since_dispatch = 0
        job = self.pending = _Job(wmap)
        if self._stream is not None:
            # The snapshot is read on the side stream after the main stream's
            # work so far; `job` keeps it alive until the merge, which waits
            # for the solve's event, so the allocator reuses none of it early.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            job.event = torch.cuda.Event()
        threading.Thread(target=self._work, args=(job,), name="legoslam-async-ba", daemon=True).start()
        self.stats["dispatched"] += 1

    def _work(self, job: _Job) -> None:
        try:
            if self._stream is None:
                job.future.set_result(self._solve(job.snapshot))
                return
            with torch.cuda.device(self._stream.device), torch.cuda.stream(self._stream):
                result = self._solve(job.snapshot)
                job.event.record(self._stream)
            job.future.set_result(result)
        except Exception as e:  # raised again by `flush` / `poll` through the future
            job.future.set_exception(e)

    def _solve(self, wmap) -> backend_mod.BAResult:
        with timer.span("ba"):
            if self.ba_device is not None:
                wmap = wmap.to(self.ba_device)
            return backend_mod.solve_window(self.cfg, self.rig, wmap, self.ba_cfg, solve_fn=self.solve_fn)

    # --- step 4 ---
    def flush(self, wmap):
        """Wait for the solve in flight, if any, and merge it."""
        if self.pending is not None:
            self.pending.future.result()
            return self._do_merge(wmap)
        return wmap

    def _do_merge(self, wmap):
        job, self.pending = self.pending, None
        result = job.future.result()
        if job.event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(job.event)
            if self.ba_device is not None:
                result = _to(result, self.device)
            for t in _tensors(result):
                if t.device == self.device:
                    t.record_stream(main)
        self.merged_stats.append(result.stats)
        self.stats["merged"] += 1
        with timer.span("ba_merge"):
            return backend_mod.merge_ba_result(wmap, result)
