"""The metric arithmetic: percentiles over all frames, latency from when a
frame was due in both loops, the union of device intervals and the idle
share, the per-layer readers on a made-up trace, and rooflines from counts
and shapes."""

import numpy as np
import pytest

from portbench import roofline, stats, traced, tracefile
from portbench.harness import reader


def test_percentiles_take_every_frame():
    lat = [5.0] * 19 + [150.0]  # one keyframe frame in twenty
    assert stats.percentile(lat, 50) == 5.0
    assert stats.percentile(lat, 95) == pytest.approx(5.0 + 0.05 * 145.0)
    assert stats.percentile(list(range(101)), 95) == 95.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_closed_loop_latency_from_the_previous_frame():
    done = [0.005, 0.155, 0.160, 0.165]
    due = [0.0] + done[:-1]  # due when the previous pose is on the host
    assert stats.latencies(due, done) == pytest.approx([0.005, 0.150, 0.005, 0.005])


def test_open_loop_latency_counts_the_wait_behind_a_stall():
    due = stats.open_loop_due(10.0, 10.0, 4)
    assert due == pytest.approx([10.0, 10.1, 10.2, 10.3])
    # frame 0 takes 150 ms: frame 1 is handed over late and waits
    done = [10.150, 10.155, 10.205, 10.305]
    assert stats.latencies(due, done) == pytest.approx([0.150, 0.055, 0.005, 0.005])
    with pytest.raises(ValueError):
        stats.latencies(due, done[:2])


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.union_length([]) == 0.0
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_ate_is_zero_after_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    assert stats.ate_rmse(gt @ R.T + [1.0, 2.0, 3.0], gt) < 1e-9
    assert stats.ate_rmse(gt + rng.normal(scale=0.1, size=gt.shape), gt) > 0.05


def test_bound_takes_the_larger_of_operations_and_bytes():
    t, kind = roofline.bound(67e12, 1.0)
    assert t == pytest.approx(1.0) and kind == "operations"
    t, kind = roofline.bound(1.0, 3.35e12 * 2)
    assert t == pytest.approx(2.0) and kind == "bytes"


def test_klt_and_pose_work_from_counts_and_shapes():
    per_iter, per_gate, per_template = roofline.klt_flop(3)
    assert (per_iter, per_gate, per_template) == (81 * 12 + 49 * 17 + 20, 49 * 20, 81 * 12)
    # one lane at the centre of a 40x40 level, radius 4: a 10x10 window
    assert roofline.touched_pixels((40, 40), [[20.0, 20.0]], [[20.0, 20.0]], 4) == 100
    # two far-apart lanes do not overlap; one lane moving 5 px widens its window by 5
    assert roofline.touched_pixels((40, 40), [[5.0, 5.0], [30.0, 30.0]], [[5.0, 5.0], [30.0, 30.0]], 4) == 200
    assert roofline.touched_pixels((40, 40), [[10.0, 10.0]], [[15.0, 10.0]], 4) == 150
    valid = np.array([True, False])
    start = np.array([[20.0, 20.0], [1.0, 1.0]])
    assert roofline.klt_window_bytes([(40, 40), (20, 20)], 0.5, 1, valid, start) == 4 * 100
    flop, nbytes = roofline.k2_work(512, 400, 30)
    assert flop == 30 * 400 * roofline.POSE_FLOP_PER_EDGE and nbytes == 64 + 512 * 21 + 64 + 512 + 4
    flop, _ = roofline.k1_anchored_work(2, valid, 7, [(40, 40)], 0.5, 1, 9, start, start, valid, 3)
    assert flop == 7 * per_iter + 1 * per_gate


def _ev(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _context(tmp_path, kf_flags=(False, True, False)):
    """Three frames of 100 us; kernels and spans as a traced slice has them."""
    events = []
    for i, kf in enumerate(kf_flags):
        t = 1000.0 + 100.0 * i
        events.append(_ev("portbench.frame", "user_annotation", t, 100.0))
        events.append(_ev("portbench.track", "user_annotation", t + 5, 20.0))
        events.append(_ev("portbench.pose", "user_annotation", t + 30, 10.0))
        events.append(_ev("void klt_pyramid_anchored_kernel<3>(Params)", "kernel", t + 10, 5.0))
        events.append(_ev("void estimate_pose_kernel<false>(...)", "kernel", t + 32, 4.0))
        if kf:
            events.append(_ev("portbench.ba", "user_annotation", t + 45, 50.0))
            events.append(_ev("portbench.insert", "user_annotation", t + 41, 3.0))
            for k in range(6):
                events.append(_ev("elementwise", "kernel", t + 50 + 5 * k, 2.0))
    events.append(_ev("Memcpy DtoH", "gpu_memcpy", 1290.0, 1.0))
    events.append(_ev("aten::add", "cpu_op", 1000.0, 1.0))
    path = tmp_path / "t.json"
    import json

    path.write_text(json.dumps({"traceEvents": events}))
    rows = [{"kf": kf, "attempts": 3 if kf else 0} for kf in kf_flags]
    return traced.Context(path, rows, [])


def test_trace_parsing(tmp_path):
    ctx = _context(tmp_path)
    tr = ctx.trace
    assert len(tr.kernels) == 12 and len(tr.device) == 13
    assert [e.start for e in tr.spans["frame"]] == [1000.0, 1100.0, 1200.0]
    assert ctx.window_s == pytest.approx(300e-6)
    assert ctx.busy_s == pytest.approx((3 * 9 + 6 * 2 + 1) * 1e-6)


def test_readers_on_a_made_up_slice(tmp_path):
    ctx = _context(tmp_path)
    assert reader("launches_per_tracking_frame")(ctx) == 2.0
    assert reader("track_ms")(ctx) == pytest.approx(0.030)
    assert reader("ba_step_ms")(ctx) == pytest.approx(0.050)
    assert reader("keyframe_insert_ms")(ctx) == pytest.approx(0.003)
    assert reader("ba_launches_per_attempt")(ctx) == 2.0
    assert reader("device_idle_pct")(ctx) == pytest.approx(100.0 * (1 - 40.0 / 300.0))
    # no K1 or K2 calls were logged: the rooflines find nothing to read
    for name in ("k1_anchored_roofline", "k1_frame_roofline", "k2_roofline"):
        assert reader(name)(ctx) is None
    bd = ctx.breakdown()
    assert bd["device_ops"][0] == ["void klt_pyramid_anchored_kernel<3>(Params)", pytest.approx(15e-6)]
    assert dict(bd["device_ops"])["elementwise"] == pytest.approx(12e-6)
    names = dict(bd["idle_gaps"])
    assert set(names) <= {"frame", "track", "pose", "ba", "insert", "between frames"}
    assert sum(names.values()) == pytest.approx(ctx.window_s - ctx.busy_s)


def test_readers_without_keyframes_or_frames(tmp_path):
    ctx = _context(tmp_path, kf_flags=(False, False))
    assert reader("ba_step_ms")(ctx) is None
    assert reader("ba_launches_per_attempt")(ctx) is None
    assert reader("keyframe_insert_ms")(ctx) is None
    empty = _context(tmp_path, kf_flags=())
    assert reader("launches_per_tracking_frame")(empty) is None
    assert reader("device_idle_pct")(empty) is None
