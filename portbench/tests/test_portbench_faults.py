"""`correct` on the CPU at a small size (94x310, a window of 4 keyframes,
128 lanes): a sound run of the port holds every number to its limit, and
the control and each fault the cells can have make it not correct.

The harness's look for a card is skipped (`run_cell(device="cpu")`); the
port runs its plain versions, the rest of a run is as on the card.  The
faults are planted in the port's stage functions, under the wrappers the
benchmark installs:
- a step that returns its state unchanged: window BA hands back the map it
  was given; tracking hands back the features it was given;
- half of the batch left out: the pose solved from every second lane;
- an answer altered where it is produced: the pose's translation moved by
  a millimetre.
The cells run on one chip, so no exchange between chips can be left out.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import check, harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 17


def tiny_cell(name="kitti00.drive"):
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)
    cell.config["camera"]["image_scale"] = 0.25
    cell.config["settings"].update(
        num_active_keyframes=4, keyframe_window_capacity=5, max_features=128, max_active_landmarks=512,
        max_ba_edges=1280, max_landmarks=8192, num_features=60, num_features_init=20,
        num_features_needed_for_keyframe=40, num_features_tracking=12)
    cell.traffic.update(warmup_max_frames=60, max_frames_per_s=6)
    cell.traffic["sample"].update(min_frames_per_s=2, frames=4, keyframes=2)
    return cell


def _run(control=False):
    torch.set_num_threads(2)
    return harness.run_cell(tiny_cell(), SEED, 2.0, False, "cpu", log=lambda m: None, control=control)


def _failing(res):
    return [r["name"] for r in res["checks"] if r["value"] > r["limit"]]


def test_sound_run_and_control():
    res = _run(control=True)
    assert res["correct"], res["checks"]
    names = {r["name"] for r in res["checks"]}
    assert {"track_px", "pose_T", "kf_px", "ba_chi"} <= names
    limits = tiny_cell().config["limits"]
    ctl_ok, rows = check.verdict(res["control"], limits)
    assert not ctl_ok, rows


def _plant(monkeypatch, module, name, make):
    import importlib

    mod = importlib.import_module(f"legoslam_tpu_torch.{module}")
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))


def test_window_ba_returning_its_map_unchanged(monkeypatch):
    _plant(monkeypatch, "pipeline.backend", "ba_step",
           lambda fn: lambda cfg, rig, wmap, *a, **kw: (wmap, fn(cfg, rig, wmap, *a, **kw)[1]))
    res = _run()
    assert not res["correct"] and set(_failing(res)) & {"ba_pose", "ba_lm_m", "ba_chi"}


def test_tracking_returning_its_features_unchanged(monkeypatch):
    _plant(monkeypatch, "pipeline.frontend", "track_last_frame",
           lambda fn: lambda cfg, rig, pyr_last, pyr_cur, feats, *a, **kw: feats)
    res = _run()
    assert not res["correct"] and set(_failing(res)) & {"track_px", "track_lanes"}


def test_pose_from_half_the_lanes(monkeypatch):
    def make(fn):
        def half(cfg, rig, feats, lm_pos, T_prior):
            keep = torch.arange(feats.valid.shape[0], device=feats.valid.device) % 2 == 0
            T, _, n_in = fn(cfg, rig, feats.replace(valid=feats.valid & keep), lm_pos, T_prior)
            _, feats_out, _ = fn(cfg, rig, feats, lm_pos, T_prior)
            return T, feats_out, n_in
        return half

    _plant(monkeypatch, "pipeline.frontend", "estimate_current_pose", make)
    res = _run()
    assert not res["correct"] and "pose_T" in _failing(res)


def test_pose_altered_where_it_is_produced(monkeypatch):
    def make(fn):
        def moved(*a, **kw):
            T, feats, n_in = fn(*a, **kw)
            T = T.clone()
            T[0, 3] += 1e-3
            return T, feats, n_in
        return moved

    _plant(monkeypatch, "pipeline.frontend", "estimate_current_pose", make)
    res = _run()
    assert not res["correct"] and "pose_T" in _failing(res)
