"""The loop closer's spans and host-read counts (utils/timer.py) on the CPU:
a short drive on the test corridor with the closer on and a minimum gap of
two keyframes, so that consecutive keyframes a few frames apart close onto
each other, under a CPU `torch.profiler`.  `VisualOdometry` records a `loop`
span for each registered keyframe (`records`, `closed`, its copy a `read`
of site `loop_register`), the closer a `loop_detect` span (`candidates`),
a `loop_verify` span for each candidate (`candidate`, `inliers`,
`accepted`; its reads of site `loop_verify`), a `pose_graph` span for each
solve (`records`, `loop_edges`, `dropped`, `factorizations`, `edges`), and
`VisualOdometry` a `loop_apply` span for each correction it applies; the
benchmark's loop readers take them.  The solve factors its Hessian once, or
twice where its outlier pass drops an edge, which the span's
`factorizations` counts as SuperLU's factorizations do.  With no profiler
nothing is recorded.

There is no card here, so each `loop_verify` read's synchronization is
simulated by the warning CUDA's sync debug mode raises for one."""

import contextlib
import types
import warnings

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from legoslam_tpu_torch.pipeline import loop_closure
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.solver import pose_graph_host
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.utils import timer
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_loop_reference import _lap_chain
from tests.test_torch_vo import OVERRIDES

SYNC = "called a synchronizing CUDA operation"
FRAMES = 12


def _vo():
    ds = SyntheticPlanesDataset(n_frames=FRAMES, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    cfg = Config({**OVERRIDES, "max_keyframe_gap": 2, "use_loop_closure": True, "loop_min_gap": 2})
    vo = VisualOdometry(config=cfg, dataset=ds, device="cpu")
    assert vo.init()
    return vo


@pytest.fixture(scope="module")
def traced():
    """The whole drive under a CPU profiler, each `loop_verify` read
    raising one synchronization warning: the record and the closer."""
    real = timer.reading

    @contextlib.contextmanager
    def reading(site):
        with real(site) as r:
            if site == "loop_verify":
                warnings.warn(SYNC)
            yield r

    mp = pytest.MonkeyPatch()
    mp.setattr(timer, "reading", reading)
    try:
        vo = _vo()
        with profile(activities=[ProfilerActivity.CPU]):
            while vo.step():
                pass
            record = timer.records()
    finally:
        mp.undo()
    return record, vo.loop_closer


def _named(record, name):
    return [s for s in record if s.name == name]


def test_the_closer_records_its_spans(traced):
    record, closer = traced
    by_id = {s.id: s for s in record}
    loops = _named(record, "loop")
    # one `loop` span per registered keyframe, the drained last one included
    assert [s.attrs["records"] for s in loops] == list(range(1, len(closer.records) + 1))
    assert sum(s.attrs["closed"] for s in loops) == closer.stats["closures"] >= 2
    for s in loops:
        kids = [c for c in record if c.parent == s.id]
        assert kids[0].name == "read" and kids[0].attrs["site"] == "loop_register"
    detects = _named(record, "loop_detect")
    assert detects and all(by_id[s.parent].name == "loop" for s in detects)
    # no detection while the closer cools down after a closure
    cool, expect = 0, 0
    for s in loops:
        if cool:
            cool -= 1
        else:
            expect += 1
            cool = closer.cfg.cooldown_keyframes if s.attrs["closed"] else 0
    assert len(detects) == expect
    verifies = _named(record, "loop_verify")
    assert len(verifies) == closer.stats["candidates"] == sum(s.attrs["candidates"] for s in detects)
    assert sum(s.attrs["accepted"] for s in verifies) == closer.stats["verified"]
    for s in verifies:
        assert by_id[s.parent].name == "loop" and s.attrs["candidate"] >= 0 and s.attrs["inliers"] >= 0
        reads = [c for c in record if c.parent == s.id and c.name == "read" and c.attrs["site"] == "loop_verify"]
        # one read a direction measured: the reverse one only where the forward one had the inliers
        assert len(reads) == (2 if s.attrs["inliers"] >= closer.cfg.min_inliers else 1)
        assert all(r.syncs == 1 for r in reads)
        assert s.syncs == len(reads)  # the span counts its reads' synchronizations (the CPU makes no others)
    graphs = _named(record, "pose_graph")
    assert len(graphs) == closer.stats["verified"]
    for s in graphs:
        assert by_id[s.parent].name == "loop"
        assert s.attrs["records"] >= closer.cfg.min_gap + 1 and s.attrs["loop_edges"] >= 1
        assert s.attrs["dropped"] == 0
    applies = _named(record, "loop_apply")
    assert len(applies) == closer.stats["closures"]
    for a in applies:  # each correction is applied after the registration that found it
        assert any(s.attrs["closed"] and s.t1_ns <= a.t0_ns for s in loops)


def test_each_drive_solve_factors_once(traced):
    record, closer = traced
    graphs = _named(record, "pose_graph")
    assert graphs
    for s in graphs:  # no outlier drops on the drive: one factorization, every edge
        assert s.attrs["factorizations"] == 1
        assert s.attrs["edges"] == s.attrs["records"] - 1 + s.attrs["loop_edges"]


@pytest.mark.parametrize("outlier", [False, True])
def test_the_pose_graph_span_counts_factorizations(outlier, monkeypatch):
    """tests/test_torch_loop_reference.py's 400-record lap through
    `add_keyframe`, its last keyframe closed by the lap's last loop edge
    onto the closer's 29 others; with `outlier`, the closer also holds one
    40 m and 5 degrees off, which the solve's outlier pass drops before it
    solves again."""
    rel, edges, anchor = _lap_chain(7, outlier)
    if outlier:  # the outlier among the edges held, the closing edge last
        edges = edges[:-2] + edges[-1:] + edges[-2:-1]
    T_cw = [anchor]
    for r in rel:
        T_cw.append(r @ T_cw[-1])
    n, (_, j, M) = len(T_cw), edges[-1]
    closer = loop_closure.LoopCloser(SyntheticPlanesDataset(n_frames=1, shape=(40, 60)).rig,
                                     loop_closure.LoopConfig(), device="cpu")
    closer.loop_edges = list(edges[:-1])
    monkeypatch.setattr(closer, "_detect", lambda: [j] if len(closer.records) == n else [])
    monkeypatch.setattr(closer, "_verify", lambda _: (True, M, 100))
    real, calls = pose_graph_host.spla.splu, []
    monkeypatch.setattr(pose_graph_host.spla, "splu", lambda A: calls.append(1) or real(A))
    img = np.zeros((40, 60), np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(n):
            out = closer.add_keyframe(k, img, T_cw[k], np.zeros((0, 2)), np.zeros((0, 3)))
        record = timer.records()
    assert out is not None and closer.stats["closures"] == 1  # the closure was accepted
    (span,) = _named(record, "pose_graph")
    assert span.attrs["factorizations"] == len(calls) == (2 if outlier else 1)
    assert span.attrs["dropped"] == (1 if outlier else 0)
    assert span.attrs["edges"] == n - 1 + len(closer.loop_edges) == n - 1 + 30


def test_the_loop_readers_read_the_record(traced, monkeypatch):
    from portbench.harness import reader

    record, _ = traced
    t0, t1 = min(s.t0_ns for s in record), max(s.t1_ns for s in record)
    ctx = types.SimpleNamespace(frames=[{"start": 1e-9 * t0 - 1e-6, "done": 1e-9 * t1 + 1e-6}])
    monkeypatch.setattr(timer, "records", lambda: list(record))
    verifies = _named(record, "loop_verify")
    assert reader("loop_host_reads_per_verify")(ctx) == sum(s.syncs for s in verifies) / len(verifies) >= 1.0
    assert reader("loop_verify_ms")(ctx) > 0 and reader("pose_graph_ms")(ctx) > 0


def test_nothing_recorded_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span was entered with no profiler")

    monkeypatch.setattr(timer, "_Open", refuse)
    before = timer.records()
    vo = _vo()
    while vo.step():
        pass
    assert vo.loop_closer.stats["closures"] >= 2
    assert timer.records() == before and timer._WATCH._holds == 0
