"""The readers of the program's own spans (portbench/program.py and the five
metrics on it) on a made-up record and trace: three traced frames, two of
them tracking frames and one a keyframe frame with a window BA of two LM
attempts, plus spans the readers must leave out.  Each reader returns None
where the program kept no record, or has no record at all (a program from
before it kept one)."""

import json

import pytest

from legoslam_tpu_torch.utils import timer
from portbench import program, traced
from portbench.harness import reader

NEW = ("host_reads_per_tracking_frame", "tracking_glue_ms", "ba_host_reads_per_solve", "lm_enqueue_ms",
       "lm_attempt_idle_pct")
HOST0 = 50.0       # s, the first frame's start on the host clock
TRACE0 = 1000.0    # us, its benchmark span's start on the trace's clock
FRAME_US = 1000.0  # each frame's slot


def _ev(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _ns(frame, us):
    """Host ns of `us` microseconds into frame `frame`."""
    return round(1e9 * HOST0 + 1e3 * (FRAME_US * frame + us))


class _Record:
    def __init__(self):
        self.spans = []

    def add(self, name, frame, t0, t1, parent=-1, syncs=0, **attrs):
        s = timer.Span(name, len(self.spans), parent, 1, frame, attrs, _ns(frame, t0), _ns(frame, t1), syncs)
        self.spans.append(s)
        return s.id


def _tracking(rec, k, pose_us):
    f = rec.add("frame", k, 1, 101, syncs=3, branch="track")
    rec.add("pyramid", k, 2, 6, f, image="left")
    p = rec.add("prior", k, 6, 9, f)
    rec.add("read", k, 7, 8, p, syncs=1, site="se3_corner")
    rec.add("track", k, 10, 40, f)
    rec.add("pose", k, 40, 40 + pose_us, f)
    rec.add("read", k, 70, 72, f, syncs=1, site="inliers")
    m = rec.add("motion", k, 72, 80, f)
    rec.add("read", k, 73, 74, m, syncs=1, site="se3_corner")


def _made_up(tmp_path, monkeypatch):
    rec = _Record()
    _tracking(rec, 0, 20)    # glue: own 100 - (4 + 3 + 30 + 20 + 2 + 8) = 33, + 4 + 3 + 8 = 48 us
    kf = rec.add("frame", 1, 1, 900, syncs=40, branch="keyframe")
    rec.add("insert", 1, 20, 100, kf)
    ba = rec.add("ba", 1, 100, 800, kf, syncs=3)
    solve = rec.add("lm_solve", 1, 110, 700, ba)
    a0 = rec.add("lm_attempt", 1, 200, 400, solve, attempt=0)
    rec.add("read", 1, 350, 400, a0, syncs=1, site="lm_accept")
    a1 = rec.add("lm_attempt", 1, 400, 700, solve, attempt=1)
    rec.add("lm_step", 1, 410, 500, a1)
    rec.add("read", 1, 600, 700, a1, syncs=1, site="lm_accept")
    _tracking(rec, 2, 10)    # glue 58 us: the frame's own time outside a shorter pose
    # Left out: an LM attempt outside window BA (the plain pose solve), and
    # spans outside the traced frames' host window.
    rec.add("lm_attempt", 2, 41, 49, rec.spans[-4].id, attempt=0)
    rec.add("ba", 3, 100, 200, syncs=99)
    rec.add("frame", -1, 10, 20, syncs=99, branch="track")
    monkeypatch.setattr(timer, "records", lambda: list(rec.spans))

    events, rows = [], []
    for k, kf_flag in enumerate((False, True, False)):
        events.append(_ev("portbench.frame", "user_annotation", TRACE0 + FRAME_US * k, 990.0))
        rows.append({"kf": kf_flag, "attempts": 2 if kf_flag else 0,
                     "start": HOST0 + 1e-6 * FRAME_US * k, "done": HOST0 + 1e-6 * (FRAME_US * k + 990)})
    # Device work inside the attempts: 50 us in the first, 30 + 10 (overlapping 5) in the second.
    for ts, dur in ((1000.0 + 1000 + 250, 50.0), (2000.0 + 450, 30.0), (2000.0 + 475, 10.0), (2000.0 + 900, 40.0)):
        events.append(_ev("elementwise", "kernel", ts, dur))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return traced.Context(path, rows, [])


def test_readers_of_the_program_record(tmp_path, monkeypatch):
    ctx = _made_up(tmp_path, monkeypatch)
    assert reader("host_reads_per_tracking_frame")(ctx) == 3.0
    assert reader("tracking_glue_ms")(ctx) == pytest.approx(0.053)
    assert reader("ba_host_reads_per_solve")(ctx) == 3.0
    # attempts of 200 and 300 us less reads of 50 and 100: 150 and 200 us
    assert reader("lm_enqueue_ms")(ctx) == pytest.approx(0.175)
    # 50 + 35 us busy of 500 us of attempts
    assert reader("lm_attempt_idle_pct")(ctx) == pytest.approx(100.0 * (1.0 - 85.0 / 500.0))


def test_spans_land_on_the_trace_clock_by_their_frame(tmp_path, monkeypatch):
    ctx = _made_up(tmp_path, monkeypatch)
    spans = program.spans(ctx)
    assert {s.frame for s in spans} == {0, 1, 2}
    attempt = program.under(spans, "lm_attempt", "ba")[0]
    assert program.on_trace(ctx, attempt) == (pytest.approx(2200.0), pytest.approx(2400.0))
    assert len(program.under(spans, "lm_attempt", "frame")) == 3


@pytest.mark.parametrize("name", NEW)
def test_readers_without_a_record(tmp_path, monkeypatch, name):
    ctx = _made_up(tmp_path, monkeypatch)
    monkeypatch.setattr(timer, "records", lambda: [])
    assert reader(name)(ctx) is None
    monkeypatch.delattr(timer, "records")  # a program from before the record
    assert reader(name)(ctx) is None
