"""scripts/pose_kernel_cycles.py's instrumented build of csrc/pose.cu, made
without a card: the source it compiles turns the kernel's CYCLES_* hooks
on and reads them back, and every hook's slot is one the script names (or
counts by), so an edit to the kernel cannot break the profiler unseen.
The build itself (nvcc) and the run need the card."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cycles():
    spec = importlib.util.spec_from_file_location("pose_kernel_cycles", ROOT / "scripts" / "pose_kernel_cycles.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_instrumented_source_turns_the_hooks_on(cycles):
    src = cycles.instrumented_source()
    plain = (ROOT / "legoslam_tpu_torch" / "csrc" / "pose.cu").read_text()
    assert src.startswith("#define POSE_CYCLES\n") and plain in src
    assert src.count("{") == src.count("}")
    reader = src[len("#define POSE_CYCLES\n") + len(plain):]
    assert "legoslam_pose_cycles" in reader and "g_cycles" in reader
    hooks = plain[plain.index("namespace {"):]
    size = int(re.search(r"g_cycles\[(\d+)\]", plain).group(1))
    used = {int(x) for x in re.findall(r"CYCLES_(?:ADD|COUNT)\((\d+)", hooks)}
    used |= {int(x) for x in re.findall(r"seq_chain_pass<\d+, \d+, (\d+), (?:true|false)>\(", hooks)}  # the chains' wait slots
    named = set(cycles.SLOTS) | {cycles.COUNT_STEPS, cycles.COUNT_CHUNKS, cycles.COUNT_REJECTS}
    assert used == named and max(named) < size == cycles.NSLOTS, (sorted(used), sorted(named))
    for name in ("CYCLES_START", "CYCLES_ADD", "CYCLES_COUNT"):  # defined on both sides of POSE_CYCLES
        assert len(re.findall(r"#define " + name + r"\(", plain)) == 2


def test_instrumented_source_refuses_a_kernel_without_hooks(cycles):
    with pytest.raises(ValueError):
        cycles.instrumented_source("__global__ void k() {}\n")
