"""The loop closer's cell (`kitti00-loop.lap`): its three readers on a
made-up record, and its stage file (portbench/stages/loop.py) on a toy
closer on the CPU.

- `loop_verify_ms` and `pose_graph_ms` are the medians of the program's
  `loop_verify` and `pose_graph` spans inside the traced frames;
  `loop_host_reads_per_verify` their synchronizations over the
  verifications; each reads nothing where the program kept no record, or
  has none (a program from before the spans);
- the stage file wraps `LoopCloser._verify` and the pose graph's solve,
  keeps data alone, and its replay reads the port's calls within the
  configuration's limits, the control's over at least one of them;
- the cell loads by name with its configuration, its lap and its stage."""

import json
import types
from pathlib import Path

import numpy as np
import pytest

from legoslam_tpu_torch.utils import timer
from portbench import check, harness
from portbench.harness import reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("loop_verify_ms", "loop_host_reads_per_verify", "pose_graph_ms")
T0 = 50_000_000_000  # ns, the first traced frame's start


def _made_up():
    S = timer.Span
    spans = [S("loop", 0, -1, 1, 10, {"records": 320, "closed": 1}, T0 + 1_000_000, T0 + 300_000_000, 8),
             S("loop_detect", 1, 0, 1, 10, {"candidates": 2}, T0 + 2_000_000, T0 + 3_000_000, 0),
             S("loop_verify", 2, 0, 1, 10, {"candidate": 4, "inliers": 10, "accepted": 0},
               T0 + 3_000_000, T0 + 7_000_000, 3),
             S("loop_verify", 3, 0, 1, 10, {"candidate": 9, "inliers": 160, "accepted": 1},
               T0 + 7_000_000, T0 + 15_000_000, 5),
             S("pose_graph", 4, 0, 1, 10, {"records": 320, "loop_edges": 7, "dropped": 0},
               T0 + 15_000_000, T0 + 215_000_000, 0),
             S("loop_apply", 5, -1, 1, -1, {}, T0 + 310_000_000, T0 + 311_000_000, 0),
             # outside the traced frames: left out
             S("loop_verify", 6, -1, 1, 90, {"candidate": 1, "inliers": 0, "accepted": 0},
               T0 + 2_000_000_000, T0 + 2_900_000_000, 99),
             S("pose_graph", 7, -1, 1, 90, {"records": 330, "loop_edges": 8, "dropped": 1},
               T0 + 3_000_000_000, T0 + 3_900_000_000, 0)]
    ctx = types.SimpleNamespace(frames=[{"start": 1e-9 * T0, "done": 1e-9 * (T0 + 400_000_000)}])
    return spans, ctx


def test_the_loop_readers(monkeypatch):
    spans, ctx = _made_up()
    monkeypatch.setattr(timer, "records", lambda: list(spans))
    assert reader("loop_verify_ms")(ctx) == pytest.approx(6.0)   # spans of 4 and 8 ms
    assert reader("loop_host_reads_per_verify")(ctx) == pytest.approx(4.0)  # (3 + 5) / 2
    assert reader("pose_graph_ms")(ctx) == pytest.approx(200.0)


@pytest.mark.parametrize("name", READERS)
def test_the_loop_readers_without_a_record(monkeypatch, name):
    spans, ctx = _made_up()
    monkeypatch.setattr(timer, "records", lambda: [s for s in spans if s.name not in ("loop_verify", "pose_graph")])
    assert reader(name)(ctx) is None
    monkeypatch.delattr(timer, "records")  # a program from before the record
    assert reader(name)(ctx) is None


def test_the_cell_loads_with_its_lap_and_its_stage():
    cell = harness.Cell(BENCH, "kitti00-loop.lap")
    assert cell.chips == 1 and cell.config["stages"] == ["loop"] and cell.config["settings"]["use_loop_closure"]
    assert harness.warmup_floor(cell) == 1560 and harness.frames_to_render(cell, 20) == 4541
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms_p50", "frame_ms_p95", "setup_s"}
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    stage = check.load_stage("loop")
    assert set(stage.GAPS) <= set(cell.config["limits"]) and set(stage.GAPS) <= set(check.NAMES)
    # Everything but the closer is kitti00's.
    base = harness.Cell(BENCH, "kitti00.drive").config
    assert {k: v for k, v in cell.config["settings"].items() if k != "use_loop_closure"} == {
        k: v for k, v in base["settings"].items() if k != "use_loop_closure"}
    assert cell.config["camera"] == base["camera"] and cell.config["yaml"] == base["yaml"]


@pytest.fixture(scope="module")
def toy():
    """A toy closer on the CPU: six keyframes of the test corridor, the
    sixth back beside the first with its odometry 0.25 m off, driven with
    the stage file's wrappers on and its calls kept."""
    from legoslam_tpu_torch.pipeline import loop_closure
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from portbench.hooks import Hooks, as_data

    H, W, focal = 160, 240, 260.0
    ds = SyntheticPlanesDataset(n_frames=2, shape=(H, W), focal=focal, baseline=0.54)

    def pose(yaw, xyz):
        c, s = np.cos(np.deg2rad(yaw)), np.sin(np.deg2rad(yaw))
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = xyz
        return T

    def view(T_wc):
        img, depth = ds._render_with_depth(T_wc, ds.rig.left)
        us, vs = np.meshgrid(np.arange(20, W - 20, 12), np.arange(20, H - 20, 12))
        uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float64)
        z = depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
        ok = np.isfinite(z) & (z < 60)
        uv, z = uv[ok], z[ok]
        p = np.stack([(uv[:, 0] - W / 2) / focal * z, (uv[:, 1] - H / 2) / focal * z, z], -1)
        return img, uv, p @ T_wc[:3, :3].T + T_wc[:3, 3]

    stage = check.load_stage("loop")
    hooks = Hooks([stage]).install()
    try:
        closer = loop_closure.LoopCloser(ds.rig, loop_closure.LoopConfig(min_gap=3), device="cpu")
        hooks.kept = {}
        drift = pose(0.0, [0.25, 0.0, 0.1])
        for k, T_wc in enumerate([pose(0.0, [0.0, 0.0, 4.0 * k]) for k in range(5)] + [pose(2.0, [0.05, 0, 0.4])]):
            img, uv, pw = view(T_wc)
            D = drift if k == 5 else np.eye(4)
            assert (closer.add_keyframe(k, img, np.linalg.inv(T_wc @ D), uv, pw @ D[:3, :3].T + D[:3, 3]) is None) \
                == (k < 5)
        kept = {tag: [as_data(c) for c in calls] for tag, calls in hooks.kept.items()}
    finally:
        hooks.remove()
    config = harness.Cell(BENCH, "kitti00-loop.lap").config
    ctx = types.SimpleNamespace(settings=dict(config["settings"], loop_min_gap=3), camera=config["camera"])
    return stage, kept, ctx, closer


def test_the_stage_keeps_data_and_replays_within_the_limits(toy):
    from portbench.reference.lowp import Control

    stage, kept, ctx, closer = toy
    assert [len(kept[t]) for t in ("verify", "pose_graph")] == [1, 1]
    verify, graph = kept["verify"][0], kept["pose_graph"][0]
    assert verify["out"]["ok"] and verify["rec_j"]["img"].dtype == np.uint8 and verify["path_T_cw"].shape == (6, 4, 4)
    assert graph["rel"].shape == (5, 4, 4) and [e[:2] for e in graph["loop_edges"]] == [(5, 0)]
    # The toy's camera is the test corridor's, not the configuration's: the verifier replays at its own.
    intr = stage.ref_loop.reprojection.Intrinsics(*closer.intr)
    cfg = stage.ref_loop.loop_config(ctx.settings)
    gaps = {**stage.verify_gaps(verify, intr, cfg), **stage.pose_graph_gaps(graph, cfg)}
    limits = harness.Cell(BENCH, "kitti00-loop.lap").config["limits"]
    assert all(gaps[k] <= limits[k] for k in stage.GAPS), gaps
    low = {**stage.verify_gaps(verify, intr, cfg, Control(None)), **stage.pose_graph_gaps(graph, cfg, True)}
    assert any(low[k] > limits[k] for k in stage.GAPS), low
    assert stage.replay({"verify": [], "pose_graph": []}, ctx) == {}  # nothing read: no limit is met
