"""Every cell, configuration and metric of BENCHMARK.json loads by its
name, and the file keeps the benchmark's contract: names, units, bounds,
the metrics each cell reports, and a limit for every number compared."""

import json
import re
from pathlib import Path

import pytest

from portbench import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells, each run with a minute's allowance, fits in 43,200 s
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"], e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith("portbench/") and path.exists()
    doc = json.loads(path.read_text())
    assert doc["name"] == cfg["name"] and doc["reduced"] == cfg["reduced"]
    assert 1 <= len(cfg["source"]) <= 200 and cfg["source"].startswith("https://")
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in doc and key in doc["published"], key
    assert doc["assumed"] and doc["settings"]["max_keyframe_gap"] >= 1
    assert doc["limits"] and set(doc["limits"]) <= set(check.NAMES)
    for stage in ("track", "pose", "kf", "ba"):
        assert any(k.startswith(stage + "_") for k in doc["limits"]), f"{cfg['name']}: no {stage} number compared"
    assert all(isinstance(v, (int, float)) and v >= 0 for v in doc["limits"].values())


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = harness.Cell(BENCH, name)
    assert cell.chips == 1
    assert cell.traffic["loop"] in ("closed", "open")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, (name, m["name"])
        assert callable(harness.reader(m["name"]))


def test_pairs_and_metric_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in moved.get("workloads", CELLS), (m["name"], w)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_unknown_workload():
    with pytest.raises(KeyError):
        harness.Cell(BENCH, "no.such.cell")


def _command(cwd, *extra):
    import subprocess
    import sys

    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "kitti00.drive", "--seed", str(2**40 + 1),
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_exits_without_a_result_where_there_is_no_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_exits_without_a_result_beside_no_port(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _command(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p50", "frame_ms_p95", "setup_s"}
