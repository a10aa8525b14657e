"""The triangular-aware block products and the large-M gate
(``config.tri_matmul_min_m``) on the CPU in f64, against the dense products
and the JAX package: each of the five products and ``_tri_blocks`` against
the JAX package's, ``tri_project`` and its pullback, ``_inv_chol_bwd_fused``
and the minibatch ELBO's gradients through the posterior build (the
whitened cache and, above ``s_corr_max_m``, ``chol_with_inv`` with the
projections) at a lowered gate against the dense route and against the JAX
package at the same setting.

At M = 256 ``_tri_blocks`` gives one block (it wants blocks of 1024), so
the block counts are also forced to 4 in both packages by patching their
``_tri_blocks``; the sums then run in another order than the dense
product's, hence 1e-12 and 1e-10 rather than equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.config import config_context as jax_config
from approximategps_tpu.core import linalg as jlinalg
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu_torch.core import linalg as tlinalg
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

PRODUCTS = ("matmul_right_lower", "matmul_right_upper", "matmul_left_upper",
            "matmul_left_lower", "matmul_tril_out")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _operands(name, M, rng, lead=()):
    """(triangular or left operand, right operand, dense reference)."""
    X = rng.standard_normal(lead + (M, M))
    T = rng.standard_normal((M, M))
    L, U = np.tril(T), np.triu(T)
    if name == "matmul_right_lower":
        return X, L, X @ L
    if name == "matmul_right_upper":
        return X, U, X @ U
    B = rng.standard_normal((M, 40)) if not lead else None
    if name == "matmul_left_upper":
        return U, B, U @ B
    if name == "matmul_left_lower":
        return L, B, L @ B
    A2 = rng.standard_normal((M, M))
    return A2, T, np.tril(A2 @ T)


@pytest.mark.parametrize("name", PRODUCTS)
@pytest.mark.parametrize("nb", [None, 1, 2, 4, 8])
def test_torch_tri_product_matches_dense_and_jax(name, nb):
    """Each product against the dense one (f64, 1e-12) and against the JAX
    package's at the same block count; M = 96 splits into 1, 2, 4 and 8
    blocks."""
    rng = np.random.default_rng(3)
    a, b, ref = _operands(name, 96, rng)
    got = getattr(tlinalg, name)(torch.tensor(a), torch.tensor(b), nb=nb)
    jgot = getattr(jlinalg, name)(jnp.asarray(a), jnp.asarray(b), "highest", nb=nb)
    assert _rel(got.numpy(), ref) <= 1e-12
    assert _rel(got.numpy(), np.asarray(jgot)) <= 1e-12
    if name == "matmul_tril_out":
        assert not np.triu(got.numpy(), 1).any()


@pytest.mark.parametrize("name", ["matmul_right_lower", "matmul_right_upper"])
def test_torch_tri_product_right_takes_batches(name):
    """A leading batch axis on the dense operand of the right products."""
    rng = np.random.default_rng(4)
    a, b, ref = _operands(name, 64, rng, lead=(3,))
    got = getattr(tlinalg, name)(torch.tensor(a), torch.tensor(b), nb=4)
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("M", [64, 1024, 2048, 4096, 8192, 12288, 3000])
def test_torch_tri_blocks_as_jax(M):
    assert tlinalg._tri_blocks(M) == jlinalg._tri_blocks(M)


@pytest.fixture
def four_blocks(monkeypatch):
    """Both packages' ``_tri_blocks`` forced to 4 (M = 256: blocks of 64)."""
    monkeypatch.setattr(tlinalg, "_tri_blocks", lambda M, target=1024: 4)
    monkeypatch.setattr(jlinalg, "_tri_blocks", lambda M, target=1024: 4)


@pytest.mark.parametrize("transpose_t", [False, True])
def test_torch_tri_project_and_pullback(four_blocks, transpose_t):
    """``tri_project`` and its hand pullback in blocks against autograd of
    the dense product of tril(T) (f64, 1e-12); T's strictly upper part is
    not read, and its cotangent is lower triangular."""
    rng = np.random.default_rng(5)
    T = torch.tensor(rng.standard_normal((256, 256)), requires_grad=True)
    X = torch.tensor(rng.standard_normal((256, 50)), requires_grad=True)
    W = torch.tensor(rng.standard_normal((256, 50)))
    Y = tlinalg.tri_project(T, X, transpose_t)
    gT, gX = torch.autograd.grad((Y * W).sum(), (T, X))
    Tl = torch.tril(T)
    Y0 = (Tl.T if transpose_t else Tl) @ X
    gT0, gX0 = torch.autograd.grad((Y0 * W).sum(), (T, X))
    assert _rel(Y.detach(), Y0.detach()) <= 1e-12
    assert _rel(gT, gT0) <= 1e-12 and _rel(gX, gX0) <= 1e-12
    assert not torch.triu(gT, 1).any()


def _chol_pair(M, rng):
    Z = rng.standard_normal((M, 2))
    d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    A = np.exp(-0.5 * d2) + 1e-2 * np.eye(M)
    L = np.linalg.cholesky(A)
    return L, np.linalg.inv(L)


@pytest.mark.parametrize("which", ["L_bar", "J_bar", "both"])
@pytest.mark.parametrize("blocks", ["default", "four"])
def test_torch_inv_chol_bwd_fused_triangular_gate(which, blocks, monkeypatch):
    """``_inv_chol_bwd_fused`` at tri_matmul_min_m = 64, M = 256, against the
    dense route (f64, 1e-10) and against the JAX package's at the same
    setting (1e-10)."""
    if blocks == "four":
        monkeypatch.setattr(tlinalg, "_tri_blocks", lambda M, target=1024: 4)
        monkeypatch.setattr(jlinalg, "_tri_blocks", lambda M, target=1024: 4)
    rng = np.random.default_rng(6)
    L, J = _chol_pair(256, rng)
    Lb = rng.standard_normal((256, 256)) if which != "J_bar" else None
    Jb = rng.standard_normal((256, 256)) if which != "L_bar" else None
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    with tgp.config_context(tri_matmul_min_m=4096):
        dense = tlinalg._inv_chol_bwd_fused(t(L), t(J), t(Lb), t(Jb))
    with tgp.config_context(tri_matmul_min_m=64):
        tri = tlinalg._inv_chol_bwd_fused(t(L), t(J), t(Lb), t(Jb))
    with jax_config(tri_matmul_min_m=64):
        jtri = jlinalg._inv_chol_bwd_fused(j(L), j(J), j(Lb), j(Jb))
    assert _rel(tri, dense) <= 1e-10
    assert _rel(tri, np.asarray(jtri)) <= 1e-10


def _elbo_data(M=256, N=300, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(0, 10, (N, 2)),
        "y": rng.standard_normal(N),
        "k": np.array([0.3, 0.1]),
        "z": rng.uniform(0, 10, (M, 2)),
        "m": 0.3 * rng.standard_normal(M),
        "A": 0.6 * np.eye(M) + 0.02 * np.tril(rng.standard_normal((M, M))),
    }


def _port_grads(d):
    p = {k: torch.tensor(d[k], requires_grad=True) for k in ("k", "z", "m", "A")}
    f = tgp.GP(tsoftplus(p["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                            tsoftplus(p["k"][1])))
    sva = tgp.SparseVariationalApproximation(f(p["z"], 1e-4),
                                              tgp.MultivariateNormal(p["m"], torch.tril(p["A"])))
    e = tgp.elbo(sva, f(torch.tensor(d["x"]), 0.1), torch.tensor(d["y"]), num_data=3000)
    g = torch.autograd.grad(e, list(p.values()))
    return e.item(), {k: v.numpy() for k, v in zip(p, g)}


def _jax_grads(d):
    import jax

    def loss(p):
        f = agp.GP(jsoftplus(p["k"][0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                                jsoftplus(p["k"][1])))
        sva = agp.SparseVariationalApproximation(
            f(p["z"], 1e-4), agp.MultivariateNormal(p["m"], jnp.tril(p["A"])))
        return agp.elbo(sva, f(jnp.asarray(d["x"]), 0.1), jnp.asarray(d["y"]), num_data=3000)

    v, g = jax.value_and_grad(loss)({k: jnp.asarray(d[k]) for k in ("k", "z", "m", "A")})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


@pytest.mark.parametrize("route", ["whitened cache", "chol_with_inv"])
def test_torch_posterior_build_gradients_at_lowered_tri_gate(four_blocks, route):
    """The minibatch ELBO's value and gradients (k, z, m, A) at M = 256 with
    tri_matmul_min_m = 64 against the dense route and against the JAX
    package at the same setting (f64, 1e-10): through the whitened cache's
    pullback (M <= s_corr_max_m), and, with s_corr_max_m = 128, through
    ``chol_with_inv``'s pullback and the ``tri_project`` projections."""
    d = _elbo_data()
    cfg = dict(solve_mode="inv_matmul", s_corr_max_m=4096 if route == "whitened cache" else 128)
    with tgp.config_context(tri_matmul_min_m=4096, **cfg):
        v_dense, g_dense = _port_grads(d)
    with tgp.config_context(tri_matmul_min_m=64, **cfg):
        v_tri, g_tri = _port_grads(d)
    with jax_config(tri_matmul_min_m=64, **cfg):
        v_jax, g_jax = _jax_grads(d)
    assert abs(v_tri - v_dense) <= 1e-10 * abs(v_dense)
    assert abs(v_tri - v_jax) <= 1e-10 * abs(v_jax)
    for k in g_tri:
        assert _rel(g_tri[k], g_dense[k]) <= 1e-10, k
        assert _rel(g_tri[k], g_jax[k]) <= 1e-10, k
