"""Each cell cut to a size a CPU test run holds: the overrides the tests
merge over the configuration and traffic files (widths cut too: these
sizes test the harness's plumbing and the comparison, not the program's
speed)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "svgp_airline.predict": {"config": {"num_data": 4000, "num_inducing": 64},
                             "traffic": {"min_points": 64, "max_points": 4096, "block_size": 512,
                                         "cycle": 16, "pool_points": 8192, "sample_every": 4,
                                         "sample_points": 65536}},
    "svgp_airline.fullbatch": {"config": {"num_data": 3000, "num_inducing": 64},
                               "traffic": {"block_size": 512}},
}
SECONDS = 0.5
