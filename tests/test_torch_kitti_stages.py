"""ROADMAP C15 kept shut: one KITTI soak frame stage by stage from the JAX
reference's own carry, the port against the reference's three CPU settings.

The fixture (tests/data/kitti_soak_stages_f5.npz, written by `python -m
tests.ba_parity_report --kitti-stages <seq> 0 30 --save OUT
--fixture-frame 5` on `scripts/kitti_soak_torch.py`'s 460-frame sequence)
holds the reference's carry after 5 frames under XLA's own instruction
set, frame 5 (a keyframe) at 188x620 as uint8, the inputs the reference
fed each of its stages, and each stage's outputs and one whole step under
`--xla_cpu_max_isa` unset, AVX2 and SSE4_2.  Frame 5 is where the port
first parted from every setting in tracking (3.05e-4 px against a spread
of 3.05e-5 px) while it rounded otherwise than the reference's compiled
code (legoslam_tpu_torch/ops/rounding.py, ops/interp.py): without that
rounding, tracking at h = 5 fails here.

Each stage of the port (tests/kitti_stages.py `stage_outputs`, each fed the
reference's inputs) is held within twice the settings' spread, or within
its unit test's bar where the settings agree exactly (`kitti_stages.bar`),
and so is one whole `process_frame` from the carry.  The reference's own
stages run live under the host's setting and must land inside the stored
spread, which guards the fixture.  `ba_step`'s solve is not a stage here
(tests/test_torch_backend.py holds it on the same soak's map); the
keyframe's `insert_keyframe` runs as its stages, the map it hands BA coming
from the fixture.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from tests import kitti_stages as ks
from tests import torch_parity  # noqa: F401  (caps torch at 2 threads per xdist worker)

FIXTURE = Path(__file__).parent / "data" / "kitti_soak_stages_f5.npz"
SETTINGS = ks.FIXTURE_SETTINGS
STAGES = ks.FIXTURE_STAGES


@pytest.fixture(scope="module")
def fx():
    """The fixture, with what it leaves out rebuilt by the port
    (`kitti_stages.load_stage_fixture`)."""
    return ks.load_stage_fixture(FIXTURE, "cpu")


@pytest.fixture(scope="module")
def port(fx):
    """The port on the CPU: the stages fed the reference's inputs, and one
    whole frame from the carry."""
    return ks.run_stage_fixture(fx)


def test_fixture_is_the_soak_keyframe(fx):
    """Frame 5 of the soak, a keyframe after four tracking frames from the
    init frame; the pyramids the port rebuilds are every setting's bits."""
    d = fx["d"]
    assert fx["h"] == 5 and int(d["kf_frame"]) == 0 and int(fx["carry"]["frames_since_kf"]) == 4
    assert d["left"].shape == d["right"].shape == (188, 620) and d["left"].dtype == np.uint8
    assert bool(fx["feed"]["kf/insert"])
    for name in SETTINGS:
        for k in ("pyr_l", "pyr_r"):
            assert str(d[f"digest/{name}/{k}"]) == fx["pyr_digest"][k], (name, k)
    assert FIXTURE.stat().st_size < 1_000_000


@pytest.mark.parametrize("stage", [*STAGES, "one step"])
def test_port_stage_within_the_settings_spread(fx, port, stage):
    """Each quantity of the stage within twice the settings' spread (or the
    unit bar where they agree exactly) of every setting."""
    spread = ks.fixture_spread(fx["settings"])
    quantities = ks.ONE_STEP if stage == "one step" else STAGES[stage]
    for name in SETTINGS:
        gaps = ks.fixture_gaps(port, fx["settings"][name])
        for q in quantities:
            assert gaps[q] <= ks.bar(q, spread[q]), (stage, q, name, gaps[q], spread[q])


def test_reference_lands_inside_its_spread(fx):
    """The reference's stages, live under this host's XLA setting and fed
    the same inputs, are within the stored spread of every setting: the
    fixture is what the reference computes."""
    d = fx["d"]
    ops = ks.RefOps({}, d["P0"], d["P1"])
    live = {"stages": ks.stage_outputs(ops, fx["carry"], d["left"], d["right"], fx["h"], feed=fx["feed"],
                                       solve=False)}
    spread = ks.spread(ks.stage_gaps, {n: fx["settings"][n]["stages"] for n in SETTINGS})
    for name in SETTINGS:
        gaps = ks.stage_gaps(live["stages"], fx["settings"][name]["stages"])
        for q, v in gaps.items():
            assert v <= spread[q], (q, name, v, spread[q])
