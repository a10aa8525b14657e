"""The Laplace, multi-latent and online twins of the examples
(``examples/torch/``: c, e, f, i) on the CPU at ``scripts/run_examples.py``'s
reduced sizes, each with its example's own asserts at their own values (c:
the optimised evidence above the initial one and train accuracy > 0.7 at the
posterior rebuilt from ``objective.cache.f``; e: the learned noise sd
growing with x; f: MAP variance under ML variance and the Student-t RMSE
under half the Gaussian one; i: the fixed-site stream within 1e-7 of the
batch optimum in f64, the moving sites' RMSE < 0.1, the Bernoulli stream's
accuracy > 0.75)."""

import sys
from pathlib import Path

import pytest
import torch

TWINS = Path(__file__).resolve().parent.parent / "examples" / "torch"
if str(TWINS) not in sys.path:
    sys.path.insert(0, str(TWINS))

import run_twins  # noqa: E402


@pytest.mark.parametrize("name", ['c', 'e', 'f', 'i'])
def test_torch_example_twin_runs_on_cpu(name):
    run_twins.run_on_cpu(name)


def test_torch_example_twins_cover_the_examples():
    """One twin for each example that scripts/run_examples.py runs, named
    as the example, whose ``main`` takes that table's reduced sizes and a
    device."""
    import inspect

    examples = TWINS.parent
    names = {p.stem for p in examples.glob("[a-j]_*.py")}
    assert {mod for mod, _ in run_twins.RUNS.values()} == names
    assert {p.stem for p in TWINS.glob("[a-j]_*.py")} == names
    for name, (_, kwargs) in run_twins.RUNS.items():
        params = inspect.signature(run_twins.load(name).main).parameters
        assert set(kwargs) | {"device"} <= set(params), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
@pytest.mark.parametrize("name", sorted(run_twins.RUNS))
def test_torch_example_twin_raises_without_a_card(name):
    """With no device asked for, a twin runs on the card, and raises where
    there is none rather than falling back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_twins.load(name).main()
