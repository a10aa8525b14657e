"""The frozen least-time arithmetic reproduces the bounds that the
repository's kernel table (PERF.md §6) gives at the paths' shapes, to the
table's last printed digit (its entries were rounded or cut there)."""

import pytest

import tiny  # noqa: F401

from gpbench.counts import bounds, flops


@pytest.mark.parametrize("which, tc, simt", [("fwd", 0.417, 1.039), ("bwd", 1.249, 3.090)])
def test_gpbench_epilogue_bounds(which, tc, simt):
    (t, _), (s, _) = bounds.epilogue_bounds(which, 2048, 16384, 8)
    assert t == pytest.approx(tc, abs=1e-3) and s == pytest.approx(simt, abs=1e-3)


@pytest.mark.parametrize("gram", [True, False])
def test_gpbench_gram_chol_bounds(gram):
    (t, by), (s, _) = bounds.gram_chol_bounds(2048, 8, gram)
    assert t == pytest.approx(0.035, abs=1e-3) and s == pytest.approx(0.086, abs=1e-3)
    assert by == "operations"


def test_gpbench_flops_by_hand():
    m, b, d = 2048, 16384, 8
    fwd = m * m * 25 / 2 + 2 * m ** 3 / 3 + b * m * 25 + 2 * m * m * b + 6 * m * b
    assert flops.svgp_train_step(m, b, d) == pytest.approx(3 * fwd, rel=1e-12)
    assert flops.svgp_predict(m, 10, d) == pytest.approx(10 * (2 * m * m + 25 * m + 6 * m))
