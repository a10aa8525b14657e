"""The k-nearest-neighbour search (``ops/knn.py``) on the CPU in f64 against
the JAX package's ``knn_search`` and a numpy brute force.

Distances must agree to 1e-12 (relative; the scan's |x|²-identity and the
grid's exact differences round differently), and the returned indices must
point at points of those distances (ties may swap indices)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.ops.knn import knn_search as jax_knn
from approximategps_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)


def _brute(Xtr, Xte, k):
    D = np.sum((Xte[:, None, :] - Xtr[None, :, :]) ** 2, axis=-1)
    return D, np.sort(D, axis=1)[:, :k]


def _check(Xtr, Xte, k, idx, d2, jax_d2=None):
    D, ref = _brute(Xtr, Xte, k)
    idx, d2 = idx.numpy(), d2.numpy()
    assert idx.dtype == np.int64 and idx.shape == d2.shape == (Xte.shape[0], k)
    np.testing.assert_allclose(d2, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.take_along_axis(D, idx, axis=1), ref, rtol=1e-12, atol=1e-12)
    if jax_d2 is not None:
        np.testing.assert_allclose(d2, np.asarray(jax_d2), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_torch_knn_scan_matches_jax_and_brute_force(d):
    """The blocked scan over several training tiles, the last one ragged,
    with the segmented pruning engaged (train_block ≥ 4·k·64) and a ragged
    last test tile."""
    rng = np.random.default_rng(d)
    Xtr, Xte = rng.standard_normal((5000, d)), rng.standard_normal((70, d))
    kw = dict(train_block=2048, test_block=32, mode="scan")
    idx, d2 = tknn.knn_search(torch.tensor(Xtr), torch.tensor(Xte), 7, **kw)
    _, jd2 = jax_knn(jnp.asarray(Xtr), jnp.asarray(Xte), 7, **kw)
    _check(Xtr, Xte, 7, idx, d2, jd2)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_torch_knn_grid_matches_jax_and_brute_force(d):
    """The bucketed grid, forced, with test points outside the training
    bounding box (their clipped cells keep the guarantee)."""
    rng = np.random.default_rng(10 + d)
    Xtr, Xte = rng.standard_normal((20000, d)), 1.6 * rng.standard_normal((300, d))
    tknn.reset_stats()
    idx, d2 = tknn.knn_search(torch.tensor(Xtr), torch.tensor(Xte), 7, test_block=128,
                              mode="grid")
    assert tknn.stats["tiles"] == tknn.stats["host_syncs"] == 3
    _, jd2 = jax_knn(jnp.asarray(Xtr), jnp.asarray(Xte), 7, test_block=128, mode="grid")
    _check(Xtr, Xte, 7, idx, d2, jd2)


def test_torch_knn_grid_fallback_is_exact():
    """Test points in the void between a dense core and a far cluster fail
    the certificate: their tiles fall back to the scan, and the result stays
    exact."""
    rng = np.random.default_rng(3)
    Xtr = np.concatenate([0.01 * rng.standard_normal((8000, 2)),
                          2.0 * rng.standard_normal((2000, 2)) + 8.0])
    Xte = np.stack([np.linspace(-1.0, 9.0, 160), np.linspace(9.0, -1.0, 160)], axis=1)
    tknn.reset_stats()
    idx, d2 = tknn.knn_search(torch.tensor(Xtr), torch.tensor(Xte), 9, test_block=64,
                              mode="grid")
    assert tknn.stats["tiles"] == 3 and tknn.stats["fallbacks"] >= 1
    _, jd2 = jax_knn(jnp.asarray(Xtr), jnp.asarray(Xte), 9, test_block=64, mode="grid")
    _check(Xtr, Xte, 9, idx, d2, jd2)


def test_torch_knn_grid_forced_signals_degradation():
    """d > 3 with the grid forced raises; a problem too small for a useful
    grid warns and runs the scan; auto stays silent there."""
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="d <= 3"):
        tknn.knn_search(torch.tensor(rng.standard_normal((64, 4))),
                        torch.tensor(rng.standard_normal((8, 4))), 3, mode="grid")
    Xtr, Xte = rng.standard_normal((200, 2)), rng.standard_normal((16, 2))
    with pytest.warns(RuntimeWarning, match="no useful grid"):
        idx, d2 = tknn.knn_search(torch.tensor(Xtr), torch.tensor(Xte), 5, mode="grid")
    _check(Xtr, Xte, 5, idx, d2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tknn.knn_search(torch.tensor(Xtr), torch.tensor(Xte), 5, mode="auto")


def test_torch_knn_rejects_bad_arguments():
    x = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="exceeds"):
        tknn.knn_search(x, x, 5)
    with pytest.raises(ValueError, match="unknown knn mode"):
        tknn.knn_search(x, x, 2, mode="kd")
