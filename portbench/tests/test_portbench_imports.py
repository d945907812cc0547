"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's `legoslam_tpu_torch` is not
`legoslam_tpu`), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.harness import FORBIDDEN

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_whole_name_comparison():
    assert "legoslam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "legoslam_tpu.ops".split(".")[0] in FORBIDDEN
    assert "jaxlib.xla_client".split(".")[0] in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        bad = set(_top_names(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_reference_sources_import_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert "legoslam_tpu_torch" not in set(_top_names(path)), path.name


def test_reference_loads_nothing_of_the_port():
    mods = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "import importlib, pathlib\n"
                   "for p in sorted(pathlib.Path('portbench/reference').glob('*.py')):\n"
                   "    importlib.import_module('portbench.reference.' + p.stem)")
    tops = _tops(mods)
    assert "portbench" in tops
    assert not tops & {"legoslam_tpu_torch", *FORBIDDEN}, tops & {"legoslam_tpu_torch", *FORBIDDEN}


def test_harness_run_path_loads_no_jax():
    mods = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "import importlib, pathlib\n"
                   "from portbench import harness, check, stats, roofline, tracefile, traced, control\n"
                   "from portbench.hooks import Hooks\n"
                   "from portbench.world import source\n"
                   "from portbench.reference import lowp, stages\n"
                   "import legoslam_tpu_torch.pipeline.visual_odometry, legoslam_tpu_torch.kernels._build\n"
                   "Hooks().install()\n"
                   "for p in sorted(pathlib.Path('portbench/metrics').glob('*.py')):\n"
                   "    harness.reader(p.stem)\n"
                   "import runpy; runpy.run_path('portbench/run.py', run_name='not_main')")
    tops = _tops(mods)
    assert "legoslam_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
