"""Timing (twin of legoslam_tpu/utils/timer.py, the analogue of `lego::Timer`).

PyTorch returns before a CUDA device finishes, so on a CUDA device `Timer`
brackets the work with CUDA events and `toc()` waits for the end event; on
the CPU it reads the host clock.  `CumulativeTimer` aggregates named
sections the way the reference accumulates `t_hessian_cost_` across solver
iterations (problem.cpp:273-358); a section reads the host clock and waits
for the card only where it is given tensors to wait for, as the JAX section
blocks only on the values it is given.

`Tracer` (one per process, `TRACER`, with its methods `span`, `reading`,
`read` and `records` at module level) keeps the program's own spans while
a `torch.profiler` records, each also a `record_function` in the
profiler's trace, and counts the CUDA synchronizations in each;
`count_host_reads` counts them around one call.  `summary` prints a
record by span name."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# The program's spans and host-read counts (see `Tracer`)
# ---------------------------------------------------------------------------

_SYNC = "synchroniz"  # in CUDA sync debug mode's warning, "called a synchronizing CUDA operation"


def profiling() -> bool:
    """Whether a `torch.profiler` is recording.  The profiler's own
    process-wide flag, so that a worker thread sees it too
    (`torch.autograd._profiler_enabled()` answers for the calling thread
    alone)."""
    return _autograd_profiler._is_profiler_enabled


class _SyncWatch:
    """CUDA's sync debug mode, with each synchronization it reports counted
    on the thread that made it.  Process-wide (the mode and Python's
    warnings are), held by whoever needs counts: the tracer while a
    profiler records, `count_host_reads` for its call.  A held watch shows
    every synchronization: its warnings filter is "always", where Python's
    default shows a warning once per call site.  `torch.cuda.synchronize()`
    is not one of them: sync debug mode reports the synchronizations an
    operation makes, not an explicit wait for the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._holds = 0
        self._local = threading.local()
        self._saved = self._filter = None

    def count(self) -> int:
        """Synchronizations counted on this thread so far."""
        return getattr(self._local, "n", 0)

    def hold(self) -> None:
        with self._lock:
            self._holds += 1
            if self._holds == 1:
                self._saved = (warnings.showwarning, torch.cuda.get_sync_debug_mode()
                               if torch.cuda.is_available() else None)
                warnings.showwarning = self._show
                warnings.filterwarnings("always", message=f".*{_SYNC}")
                self._filter = warnings.filters[0]
                if torch.cuda.is_available():
                    torch.cuda.set_sync_debug_mode("warn")

    def release(self) -> None:
        with self._lock:
            self._holds -= 1
            if self._holds == 0:
                show, mode = self._saved
                if mode is not None:
                    torch.cuda.set_sync_debug_mode(mode)
                if warnings.showwarning == self._show:
                    warnings.showwarning = show
                if self._filter in warnings.filters:
                    warnings.filters.remove(self._filter)
                    warnings._filters_mutated()

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC in str(message):
            self._local.n = self.count() + 1
        else:
            self._saved[0](message, category, filename, lineno, file, line)


_WATCH = _SyncWatch()


def count_host_reads(fn):
    """(fn's result, the CUDA synchronizations fn made on this thread),
    counted by CUDA's sync debug mode."""
    _WATCH.hold()
    try:
        n0 = _WATCH.count()
        out = fn()
        return out, _WATCH.count() - n0
    finally:
        _WATCH.release()


class Span(NamedTuple):
    """One closed span of the record."""

    name: str
    id: int
    parent: int    # the enclosing span on the same thread, -1 at the thread's root
    thread: int    # threading.get_native_id(), the Chrome trace's tid
    frame: int     # the frame id of the enclosing `frame` span, -1 outside one
    attrs: dict
    t0_ns: int     # time.perf_counter_ns()
    t1_ns: int
    syncs: int     # CUDA synchronizations on this thread inside the span, its children's included

    @property
    def label(self) -> str:
        """The span's `record_function` name in a profiler trace."""
        return _label(self.name, self.attrs)


# The profiler's event for a span: the C++ `record_function`, which takes
# its times next to the span's own (the Python one goes through the
# dispatcher, tens of microseconds, hundreds on a session's first span), or
# the Python one where torch lacks it.
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


def _label(name: str, attrs: dict) -> str:
    return f"legoslam.read.{attrs['site']}" if name == "read" else f"legoslam.{name}"


class _Off:
    """What a span site gets while no profiler records: nothing happens."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded (the context manager `Tracer.span` returns)."""

    __slots__ = ("tracer", "name", "id", "parent", "frame", "attrs", "rf", "t0", "s0")

    def __init__(self, tracer: "Tracer", name: str, frame: Optional[int], attrs: dict):
        self.tracer, self.name, self.frame, self.attrs = tracer, name, frame, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a frame's branch)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        top = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        self.parent = top.id if top is not None else -1
        if self.frame is None:
            self.frame = top.frame if top is not None else -1
        stack.append(self)
        self.s0 = _WATCH.count()
        self.rf = _RECORD(_label(self.name, self.attrs))
        # The host clock is read right after the profiler's event takes its
        # start and right before it takes its end, so a span and its event
        # lie a few microseconds apart.
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        syncs = _WATCH.count() - self.s0
        self.tracer._stack().pop()
        self.tracer._keep(Span(self.name, self.id, self.parent, threading.get_native_id(), self.frame, self.attrs,
                               self.t0, t1, syncs))
        return False


class Tracer:
    """The program's spans, recorded only while a `torch.profiler` records.

    `with tracer.span(name, **attrs):` enters a `record_function` named
    "legoslam.<name>", so in a profiler trace the span sits on the clock of
    the device's events, and keeps a `Span` (name, parents, thread, frame,
    attributes, `time.perf_counter_ns()` at both ends, synchronizations) in
    a bounded record; `read(t, site)` is a device-to-host read in a `read`
    span.  While no profiler records, a site costs one check and allocates
    nothing.  A profiler's start begins a new record: the first site to see
    it clears the last one and holds CUDA's sync debug mode until a site or
    `records()` sees the profiler stopped."""

    def __init__(self, capacity: int = 1 << 17):
        self.capacity = capacity
        self.dropped = 0
        self._record: List[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._session = False

    def _on(self) -> bool:
        if profiling():
            if not self._session:
                with self._lock:
                    if not self._session:
                        self._record, self.dropped, self._session = [], 0, True
                        _WATCH.hold()
            return True
        if self._session:
            with self._lock:
                if self._session:
                    self._session = False
                    _WATCH.release()
        return False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        if len(self._record) < self.capacity:
            self._record.append(span)
        else:
            self.dropped += 1

    def span(self, name: str, frame: Optional[int] = None, **attrs):
        """A span named `name` around a `with` block; `frame` gives the frame
        id (a child takes its parent's)."""
        if not self._on():
            return _OFF
        return _Open(self, name, frame, attrs)

    def reading(self, site: str):
        """A `read` span around a block that synchronizes with the device."""
        return self.span("read", site=site)

    def read(self, t: torch.Tensor, site: str):
        """`t.tolist()`, a device-to-host read, in a `read` span named by `site`."""
        if not self._on():
            return t.tolist()
        with self.reading(site):
            return t.tolist()

    def records(self) -> List[Span]:
        """The spans of the profiler session running or last run, in the
        order they closed (an empty list where none was recorded)."""
        self._on()
        return list(self._record)


TRACER = Tracer()
span, reading, read, records = TRACER.span, TRACER.reading, TRACER.read, TRACER.records


def summary(spans: Sequence[Span]) -> str:
    """Each span name's count, total and self time (ms) and the host reads
    made in it outside its children, one line each, the largest self time
    first; `read` spans by site."""
    child_ns: Dict[int, int] = defaultdict(int)
    child_syncs: Dict[int, int] = defaultdict(int)
    for s in spans:
        child_ns[s.parent] += s.t1_ns - s.t0_ns
        child_syncs[s.parent] += s.syncs
    rows: Dict[str, list] = {}
    for s in spans:
        r = rows.setdefault(s.label[len("legoslam."):], [0, 0, 0, 0])
        r[0] += 1
        r[1] += s.t1_ns - s.t0_ns
        r[2] += s.t1_ns - s.t0_ns - child_ns[s.id]
        r[3] += s.syncs - child_syncs[s.id]
    return "\n".join(f"{k}: n={n}, total={1e-6 * tot:.3f} ms, self={1e-6 * own:.3f} ms, host reads={syncs}"
                     for k, (n, tot, own, syncs) in sorted(rows.items(), key=lambda kv: -kv[1][2]))
