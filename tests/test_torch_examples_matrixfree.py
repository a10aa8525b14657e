"""The matrix-free twin of the examples (``examples/torch/g_matrixfree.py``)
on the CPU with its example's own asserts at their own values (CG
regression within 0.15 of the truth, the SLQ Adam steps lowering the loss,
finite pathwise samples, CG-Newton Laplace sign agreement > 0.9).

Cut below ``scripts/run_examples.py``'s size (N = 4000, Nh = 1500) to
N = 2000, Nh = 1000: the unpreconditioned SLQ value (CG to 1e-8 at noise
0.01) took about 100 s at that size in one CPU thread, 13 s at this one."""

import sys
from pathlib import Path

TWINS = Path(__file__).resolve().parent.parent / "examples" / "torch"
if str(TWINS) not in sys.path:
    sys.path.insert(0, str(TWINS))

import run_twins  # noqa: E402


def test_torch_example_twin_g_runs_on_cpu():
    run_twins.run_on_cpu('g', N=2000, Nh=1000)
