"""Each cell cut to a size a CPU test run holds: ``tiny/<cell>.json``, the
overrides (``{"config": {...}, "traffic": {...}}``) the tests merge over
the configuration and traffic files (widths cut too: these sizes test the
harness's plumbing and the comparison, not the program's speed).  A new
cell brings its own file; ``TINY[cell]`` for a cell without one raises a
KeyError that names the file to add."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SIZES = Path(__file__).resolve().parent / "tiny"


class _Sizes(dict):
    def __missing__(self, cell):
        raise KeyError(f"cell {cell!r} has no CPU size: add "
                       f"{(SIZES / f'{cell}.json').relative_to(ROOT)}")


TINY = _Sizes({p.name[:-len(".json")]: json.loads(p.read_text())
               for p in sorted(SIZES.glob("*.json"))})
SECONDS = 0.5
