"""The benchmark's own tests: `python -m pytest portbench/tests -q -p no:cacheprovider`.
They run on the CPU; the one marked `gpu` runs a cell on a card and skips
without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
