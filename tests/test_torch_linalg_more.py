"""The ``core/linalg`` exports that came with the data-parallel slice:
``At_A``, ``diag_At_A``, ``Xt_invA_X``, ``diag_Xt_invA_X`` (the AbstractGPs
helpers), ``blocked_cholesky`` and ``tri_project`` with their closed-form
pullbacks, held to the JAX package on the same numpy inputs in f64 (as
``tests/test_core.py`` and ``tests/test_ad_rules.py`` hold the JAX ones)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.core import linalg as jl
from approximategps_tpu_torch.core import linalg as tl

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _psd(rng, n, jitter=1e-3):
    A = rng.standard_normal((n, n))
    return A @ A.T + jitter * np.eye(n)


def test_torch_abstractgps_helpers_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    A, B = _psd(rng, 6), rng.standard_normal((6, 4))
    L = np.linalg.cholesky(A)
    ref = B.T @ np.linalg.solve(A, B)
    for got, jax_val, want, tol in (
        (tl.At_A(_t(B)), jl.At_A(jnp.asarray(B)), B.T @ B, 1e-12),
        (tl.diag_At_A(_t(B)), jl.diag_At_A(jnp.asarray(B)), np.diag(B.T @ B), 1e-12),
        (tl.Xt_invA_X(_t(L), _t(B)), jl.Xt_invA_X(jnp.asarray(L), jnp.asarray(B)), ref, 1e-8),
        (tl.diag_Xt_invA_X(_t(L), _t(B)), jl.diag_Xt_invA_X(jnp.asarray(L), jnp.asarray(B)),
         np.diag(ref), 1e-8),
    ):
        np.testing.assert_allclose(got.numpy(), want, atol=tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_val), rtol=1e-12, atol=1e-14)


def test_torch_diag_at_a_accumulates_in_f32():
    B = torch.randn(64, 5, dtype=torch.bfloat16)
    out = tl.diag_At_A(B)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, (B.float() ** 2).sum(0))


@pytest.mark.parametrize("n", [96, 300])
def test_torch_blocked_cholesky_matches_jax(n):
    """96 (one split at base 64) and 300 (an uneven split)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    L = tl.blocked_cholesky(_t(K), base=64).numpy()
    np.testing.assert_allclose(L @ L.T, K, rtol=1e-10)
    assert np.array_equal(L, np.tril(L))
    np.testing.assert_allclose(L, np.asarray(jl.blocked_cholesky(jnp.asarray(K), 64)),
                               rtol=1e-10, atol=1e-12)


def test_torch_blocked_cholesky_pullback_matches_jax_and_autograd():
    """The closed-form pullback through K = R Rᵀ + 8I at base 2 (the
    recursion's every level), against the JAX custom VJP and finite
    differences."""
    rng = np.random.default_rng(1)
    R, C = rng.standard_normal((8, 8)), rng.standard_normal((8, 8))

    def jax_f(R):
        return jnp.sum(jl.blocked_cholesky(R @ R.T + 8 * jnp.eye(8), 2) * C)

    def torch_f(R):
        return torch.sum(tl.blocked_cholesky(R @ R.T + 8 * torch.eye(8, dtype=R.dtype), 2)
                         * _t(C))

    Rt = _t(R, grad=True)
    (g,) = torch.autograd.grad(torch_f(Rt), Rt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jax_f)(jnp.asarray(R))),
                               rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradcheck(torch_f, (Rt,))


@pytest.mark.parametrize("transpose_t", [False, True])
def test_torch_tri_project_matches_jax(transpose_t):
    """M = 2048 (the JAX package's blocked path), B = 16: the value and the
    pullback of a random cotangent against JAX's, T's strictly upper half
    not read; and finite differences at M = 6."""
    rng = np.random.default_rng(2)
    M, B = 2048, 16
    T, X, Yb = 0.05 * rng.standard_normal((M, M)), rng.standard_normal((M, B)), \
        rng.standard_normal((M, B))
    Tl = np.tril(T)
    y, vjp = jax.vjp(lambda T, X: jl.tri_project(T, X, transpose_t), jnp.asarray(Tl),
                     jnp.asarray(X))
    jT, jX = vjp(jnp.asarray(Yb))
    Tt, Xt = _t(T, grad=True), _t(X, grad=True)
    out = tl.tri_project(Tt, Xt, transpose_t)
    np.testing.assert_allclose(out.detach().numpy(), (Tl.T if transpose_t else Tl) @ X,
                               atol=1e-12)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-12)
    gT, gX = torch.autograd.grad(out, (Tt, Xt), _t(Yb))
    np.testing.assert_allclose(gT.numpy(), np.asarray(jT), atol=1e-11)
    np.testing.assert_allclose(gX.numpy(), np.asarray(jX), atol=1e-11)
    assert np.array_equal(gT.numpy(), np.tril(gT.numpy()))
    small = (_t(rng.standard_normal((6, 6)), grad=True), _t(rng.standard_normal((6, 3)), grad=True))
    assert torch.autograd.gradcheck(
        lambda T, X: tl.tri_project(torch.tril(T), X, transpose_t), small)
