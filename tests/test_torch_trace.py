"""The program's spans and host-read counts (utils/timer.py `Tracer`) on the
CPU: nothing is recorded while no profiler records; under a CPU
`torch.profiler`, `process_frame`'s tracking and keyframe frames record
the span tree the benchmark's readers and `--profile` take, the same spans
appear as `legoslam.*` events in the exported Chrome trace, and the
frame's anchor places each span on the trace's clock; the record is
bounded, a second thread's spans and synchronizations are its own, and
`--profile A:B` writes a trace.

There is no card here, so a synchronization is simulated by the warning
CUDA's sync debug mode raises for one (the card test is in
tests/test_torch_kernels_gpu.py)."""

import collections
import gzip
import json
import threading
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from legoslam_tpu_torch.apps import _common, run_synthetic
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.utils import timer
from legoslam_tpu_torch.utils.config import Config
from tests.test_torch_vo import OVERRIDES

SYNC = "called a synchronizing CUDA operation"


def _vo(n_frames=4):
    ds = SyntheticPlanesDataset(n_frames=n_frames, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
    vo = VisualOdometry(config=Config({**OVERRIDES, "max_keyframe_gap": 2}), dataset=ds, device="cpu")
    assert vo.init()
    return vo


def _events(path):
    with gzip.open(path, "rt") if str(path).endswith(".gz") else open(path) as f:
        data = json.load(f)
    return [e for e in data["traceEvents"] if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
            and e["name"].startswith("legoslam.")]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Frame 0 (stereo init) untraced, then frames 1 and 2 under a CPU
    profiler, one a tracking frame and one a keyframe frame
    (`max_keyframe_gap` 2): the record, the trace's `legoslam.*` events
    and the two frames' outputs."""
    vo = _vo()
    assert vo.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert vo.step() and vo.step()
    path = tmp_path_factory.mktemp("trace") / "t.json"
    prof.export_chrome_trace(str(path))
    return timer.records(), _events(path), vo.outputs[1:]


def _children(record):
    kids = collections.defaultdict(list)
    for s in sorted(record, key=lambda s: s.t0_ns):
        kids[s.parent].append(s)
    return kids


def test_nothing_recorded_while_the_profiler_is_off(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = timer.records()
    vo = _vo(3)
    while vo.step():
        pass
    assert timer.records() == before
    # A site hands out one shared do-nothing object and holds no sync watch.
    assert timer.span("frame", frame=1) is timer.span("ba") is timer.reading("x")
    assert timer.read(torch.tensor([True, False]), "lm_accept") == [True, False]
    assert timer._WATCH._holds == 0


def test_frames_record_the_span_tree(traced):
    record, _, outs = traced
    kids = _children(record)
    frames = {s.attrs["branch"]: s for s in record if s.name == "frame"}
    assert sorted(frames) == ["keyframe", "track"] and sorted(o.kf_inserted for o in outs) == [False, True]
    track, kf = frames["track"], frames["keyframe"]
    assert all(s.frame in (1, 2) and s.thread == kf.thread and s.syncs == 0 for s in record)

    def names(span):
        return [c.name if c.name != "read" else f"read.{c.attrs['site']}" for c in kids[span.id]]

    assert names(track) == ["pyramid", "prior", "track", "pose", "read.inliers", "motion"]
    assert names(kf) == ["pyramid", "prior", "track", "pose", "read.inliers", "pyramid", "insert", "ba", "motion"]
    assert [c.attrs["image"] for c in kids[kf.id] if c.name == "pyramid"] == ["left", "right"]
    # The unbatched pose products fill a 0-dim corner (a synchronization on a card).
    assert names(kids[track.id][1]) == ["read.se3_corner"]
    assert names(kids[track.id][-1]) == ["read.se3_corner"] * 2
    insert = kids[kf.id][6]
    assert names(insert) == ["evict", "detect", "stereo", "triangulate", "register"]
    evict, detect, stereo, triangulate, register = kids[insert.id]
    assert set(names(evict)) == {"read.se3_corner", "read.evict_pick", "read.evict_clear"}
    assert names(detect) == ["read.occupancy", "read.detect_append"]
    assert set(names(stereo)) == {"read.stereo_refine"}
    assert set(names(triangulate)) == {"read.triangulate_rays", "read.triangulate_fallback", "read.se3_corner",
                                       "read.triangulate_append"}
    assert names(register) == ["read.register_slot"] * 9
    ba = kids[kf.id][7]
    assert names(ba) == ["ba_problem", "ba_order", "lm_solve", "ba_classify", "ba_merge"]
    lm_solve = kids[ba.id][2]
    attempts = [c for c in kids[lm_solve.id] if c.name == "lm_attempt"]
    assert names(lm_solve) == ["lm_assemble"] + ["lm_attempt"] * len(attempts)
    assert [a.attrs["attempt"] for a in attempts] == list(range(max(int(o.ba.attempts) for o in outs)))
    for a in attempts:
        assert names(a) == ["lm_step", "lm_assemble", "read.lm_accept"]
    # Parents enclose their children on the host clock.
    by_id = {s.id: s for s in record}
    for s in record:
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_trace_events_match_the_record(traced):
    record, events, _ = traced
    assert collections.Counter(e["name"] for e in events) == collections.Counter(s.label for s in record)
    # Pair each span with its event in start order, name by name.
    by_label = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e["ts"]):
        by_label[e["name"]].append(e)
    event_of = {}
    for label, evs in by_label.items():
        for s, e in zip(sorted((s for s in record if s.label == label), key=lambda s: s.t0_ns), evs):
            event_of[s.id] = e
    for s in record:
        if s.parent >= 0:
            e, p = event_of[s.id], event_of[s.parent]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
    assert all(e["tid"] == events[0]["tid"] for e in events)

    # The frame anchor (the frame event's start less the span's host start)
    # places every span of the frame on the trace's clock.
    for f in (s for s in record if s.name == "frame"):
        anchor = event_of[f.id]["ts"] - 1e-3 * f.t0_ns
        for s in record:
            if s.frame == f.frame:
                assert abs(1e-3 * s.t0_ns + anchor - event_of[s.id]["ts"]) < 50.0, s


def test_the_record_is_bounded_and_counts_what_it_drops():
    tracer = timer.Tracer(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with tracer.span("lm_attempt", attempt=k):
                pass
    assert [s.attrs["attempt"] for s in tracer.records()] == [0, 1, 2] and tracer.dropped == 2
    with profile(activities=[ProfilerActivity.CPU]):  # a new session starts a new record
        with tracer.span("ba"):
            pass
    assert [s.name for s in tracer.records()] == ["ba"] and tracer.dropped == 0


def test_second_thread_spans_and_syncs_are_its_own():
    tracer = timer.Tracer()
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with tracer.span("ba"):
            warnings.warn(SYNC)
            with tracer.reading("lm_accept"):
                warnings.warn(SYNC)

    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("frame", frame=7):
            warnings.warn(SYNC)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with tracer.reading("inliers"):
                warnings.warn(SYNC)
                warnings.warn(SYNC)  # every one is counted, not once per line
    spans = {s.name if s.name != "read" else s.attrs["site"]: s for s in tracer.records()}
    main = threading.get_native_id()
    assert spans["frame"].thread == spans["inliers"].thread == main != seen["tid"]
    assert spans["ba"].thread == spans["lm_accept"].thread == seen["tid"]
    assert (spans["frame"].syncs, spans["inliers"].syncs) == (3, 2)
    assert (spans["ba"].syncs, spans["lm_accept"].syncs) == (2, 1)
    assert spans["ba"].parent == -1 and spans["ba"].frame == -1 and spans["inliers"].frame == 7
    assert "frame: n=1" in timer.summary(tracer.records()) and "read.inliers: n=1" in timer.summary(tracer.records())
    assert "host reads=1" in [ln for ln in timer.summary(tracer.records()).splitlines() if ln.startswith("frame")][0]


def test_count_host_reads_counts_syncs_and_passes_other_warnings_on():
    def work():
        warnings.warn("something else")
        warnings.warn(SYNC)
        warnings.warn(SYNC)
        return 5

    filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert timer.count_host_reads(work) == (5, 2)
    assert [str(w.message) for w in caught] == ["something else"]
    assert warnings.filters == filters and timer._WATCH._holds == 0


def test_profile_flag_writes_a_trace(tmp_path):
    assert run_synthetic.main(["--frames", "4", "--profile", "1:3", "--device", "cpu", "--no_ba",
                               "--out_dir", str(tmp_path)]) == 0
    names = collections.Counter(e["name"] for e in _events(tmp_path / "profile.trace.json.gz"))
    assert names["legoslam.frame"] == 2 and names["legoslam.read.inliers"] == 2 and names["legoslam.track"] == 2
    assert _common._profile_window("") is None and _common._profile_window("5:10") == (5, 10)
    for bad in ("5", "a:b", "4:4"):
        with pytest.raises(SystemExit):
            _common._profile_window(bad)


def test_window_ba_on_a_cpu_runs_op_by_op(monkeypatch):
    """`lm.solve_ba` on CPU tensors runs `lm.lm_optimize` and never reaches
    the CUDA graph path (solver/ba_graph.py): under a profiler every LM
    attempt of window BA is a `lm_attempt` span with `graph` 0 holding its
    `lm_step` and `lm_assemble`, and no `lm_capture` span is recorded."""
    from legoslam_tpu_torch.solver import ba_graph

    def refuse(*a, **kw):
        raise AssertionError("a CPU solve reached the CUDA graph path")

    monkeypatch.setattr(ba_graph, "solve", refuse)
    vo = _vo()
    assert vo.step()
    with profile(activities=[ProfilerActivity.CPU]):
        assert vo.step() and vo.step()
    record = timer.records()
    kids = _children(record)
    by_id = {s.id: s for s in record}
    attempts = [s for s in record if s.name == "lm_attempt" and by_id[by_id[s.parent].parent].name == "ba"]
    assert attempts and sum(int(o.ba.attempts) for o in vo.outputs[1:]) == len(attempts)
    for a in attempts:
        assert a.attrs["graph"] == 0
        assert [c.name for c in kids[a.id]] == ["lm_step", "lm_assemble", "read"]
    assert not any(s.name == "lm_capture" for s in record)


@pytest.mark.parametrize("graphs, share", [((1, 1, 1), 1.0), ((1, 0, 1, 1), 0.75), ((0, 0), 0.0), ((), None)])
def test_lm_graph_share_reads_the_attempts_graph_attribute(monkeypatch, graphs, share):
    """portbench/metrics/lm_graph_share.py on a made-up record: window BA's
    `lm_attempt` spans with `graph` 1 over all of them; an attempt outside
    window BA (the plain pose solve) and spans outside the traced frames
    are left out; nothing to read where the attempts carry no `graph`
    attribute (a program from before the graphs) or there are none."""
    import types

    from portbench.harness import reader

    t0 = 10_000_000_000
    spans = [timer.Span("frame", 0, -1, 1, 0, {"branch": "keyframe"}, t0, t0 + 900, 0),
             timer.Span("ba", 1, 0, 1, 0, {}, t0 + 10, t0 + 800, 0),
             timer.Span("lm_solve", 2, 1, 1, 0, {}, t0 + 20, t0 + 700, 0),
             timer.Span("lm_attempt", 3, 0, 1, 0, {"attempt": 0, "graph": 0}, t0 + 850, t0 + 860, 0),
             timer.Span("lm_attempt", 4, -1, 1, 5, {"attempt": 0, "graph": 0}, t0 + 2000, t0 + 2100, 0)]
    spans += [timer.Span("lm_attempt", 10 + k, 2, 1, 0, {"attempt": k, "graph": g}, t0 + 30 + 10 * k,
                         t0 + 35 + 10 * k, 0) for k, g in enumerate(graphs)]
    ctx = types.SimpleNamespace(frames=[{"start": 1e-9 * t0, "done": 1e-9 * (t0 + 1000)}])
    monkeypatch.setattr(timer, "records", lambda: list(spans))
    assert reader("lm_graph_share")(ctx) == share
    for s in spans[5:]:
        s.attrs.pop("graph")
    assert reader("lm_graph_share")(ctx) is None
