"""The Vecchia twin of the examples (``examples/torch/j_vecchia.py``) on
the CPU at ``scripts/run_examples.py``'s reduced size, with its example's
own asserts at their own values (maximin+nearest under half the natural
ordering's evidence error, the noise sd recovered within a factor 2,
``predict_knn``'s RMSE under the noise sd, positive variances, calibrated
residuals); the maximin ordering through ``native/`` (g++)."""

import sys
from pathlib import Path

TWINS = Path(__file__).resolve().parent.parent / "examples" / "torch"
if str(TWINS) not in sys.path:
    sys.path.insert(0, str(TWINS))

import run_twins  # noqa: E402


def test_torch_example_twin_j_runs_on_cpu():
    run_twins.run_on_cpu('j')
