"""The SVGP twins of the examples (``examples/torch/``: a, b, d, h) on
the CPU at ``scripts/run_examples.py``'s reduced sizes, each with its
example's own asserts at their own values (a: posterior-mean RMSE < 0.2;
b: training accuracy > 0.7; d: mean relative rate error < 0.3; h: interior
RMSE < 0.2 and the sweep over a gloo world of one equal to the single
sweep to 1e-12).  About 25 s in one process."""

import sys
from pathlib import Path

import pytest

TWINS = Path(__file__).resolve().parent.parent / "examples" / "torch"
if str(TWINS) not in sys.path:
    sys.path.insert(0, str(TWINS))

import run_twins  # noqa: E402


@pytest.mark.parametrize("name", ['a', 'b', 'd', 'h'])
def test_torch_example_twin_runs_on_cpu(name):
    run_twins.run_on_cpu(name)
