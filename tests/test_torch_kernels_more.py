"""The kernels of ``core/kernels.py`` that do not unwrap to a CUDA map, on the
CPU in f64 against the JAX package: the rational quadratic, periodic,
linear, polynomial and product kernels (gram, diag and the gradients in
their parameters), ``k1 * k2`` as a product, and the unwrappers declining
them.

Tolerances: Grams and diagonals 1e-13 relative to the largest entry,
gradients 1e-12 (the two packages round the same formulas in other orders);
both packages take the inputs, made by numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.core import kernels as jk
import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.core import kernels as tk

torch.set_num_threads(1)


def _rel(t, j) -> float:
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _points(seed, N=9, M=6, D=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.5, 1.5, (N, D))
    Z = np.concatenate([X[:2], rng.uniform(-1.5, 1.5, (M - 2, D))])  # pairs at r = 0
    return X, Z


def _jax_kernel(name, pj):
    if name == "rq":
        return jk.RationalQuadraticKernel(alpha=pj)
    if name == "periodic":
        return jk.PeriodicKernel(period=pj)
    if name == "linear":
        return jk.LinearKernel()
    if name == "poly":
        return jk.PolynomialKernel(degree=3, c=pj)
    # a quasi-periodic product: Matérn-3/2 with a lengthscale × periodic
    return agp.with_lengthscale(jk.Matern32Kernel(), 1.7) * jk.PeriodicKernel(period=pj)


def _torch_kernel(name, pt):
    if name == "rq":
        return tk.RationalQuadraticKernel(alpha=pt)
    if name == "periodic":
        return tk.PeriodicKernel(period=pt)
    if name == "linear":
        return tk.LinearKernel()
    if name == "poly":
        return tk.PolynomialKernel(degree=3, c=pt)
    return tgp.with_lengthscale(tk.Matern32Kernel(), 1.7) * tk.PeriodicKernel(period=pt)


def _pair(name, p):
    """The same kernel in both packages, its parameter p a JAX array and a
    torch tensor."""
    return (_jax_kernel(name, jnp.asarray(p)),
            _torch_kernel(name, torch.tensor(p, dtype=torch.float64)))


KINDS = {"rq": 1.3, "periodic": 2.1, "linear": 0.0, "poly": 0.4, "product": 2.1}


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("name", list(KINDS))
def test_torch_more_kernels_gram_and_diag_match_jax(name, D):
    X, Z = _points(1, D=1 if name in ("periodic", "product") else D)
    kj, kt = _pair(name, KINDS[name])
    Xt, Zt = torch.tensor(X), torch.tensor(Z)
    assert _rel(kt.gram(Xt), kj.gram(jnp.asarray(X))) <= 1e-13
    assert _rel(kt.gram(Xt, Zt), kj.gram(jnp.asarray(X), jnp.asarray(Z))) <= 1e-13
    assert _rel(kt.diag(Xt), kj.diag(jnp.asarray(X))) <= 1e-13


@pytest.mark.parametrize("name", ["rq", "periodic", "poly", "product"])
def test_torch_more_kernels_parameter_gradient_matches_jax(name):
    """∂/∂(α, period, c) of Σ sin(K) over a cross-Gram and a Gram, against
    ``jax.grad``."""
    X, Z = _points(2, D=1)
    weights = np.random.default_rng(3).standard_normal((X.shape[0], Z.shape[0]))

    def jloss(p):
        kj = _jax_kernel(name, p)
        return (jnp.sum(jnp.sin(kj.gram(jnp.asarray(X), jnp.asarray(Z))) * weights)
                + jnp.sum(kj.gram(jnp.asarray(X))))

    want = jax.grad(jloss)(jnp.asarray(KINDS[name]))
    p = torch.tensor(KINDS[name], dtype=torch.float64, requires_grad=True)
    kt = _torch_kernel(name, p)
    loss = (torch.sum(torch.sin(kt.gram(torch.tensor(X), torch.tensor(Z))) * torch.tensor(weights))
            + torch.sum(kt.gram(torch.tensor(X))))
    (got,) = torch.autograd.grad(loss, p)
    assert abs(float(got) - float(want)) <= 1e-12 * max(abs(float(want)), 1.0)


def test_torch_kernel_times_kernel_is_a_product():
    """``k1 * k2`` is a ProductKernel in the port, as in the JAX package (it
    raised before); a number times a kernel stays a ScaledKernel."""
    k1, k2 = tk.Matern32Kernel(), tk.PeriodicKernel(period=1.5)
    prod = k1 * k2
    assert isinstance(prod, tk.ProductKernel) and prod.left is k1 and prod.right is k2
    assert isinstance(agp.Matern32Kernel() * agp.PeriodicKernel(), jk.ProductKernel)
    assert isinstance(2.0 * k1, tk.ScaledKernel) and isinstance(k1 * 2.0, tk.ScaledKernel)
    X = torch.tensor(_points(4, D=1)[0])
    torch.testing.assert_close(prod.gram(X), k1.gram(X) * k2.gram(X), rtol=0, atol=0)
    torch.testing.assert_close(prod.diag(X), k1.diag(X) * k2.diag(X), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rq", "periodic"])
def test_torch_parameterised_maps_do_not_unwrap(name):
    """Maps that close over a parameter have no CUDA map, so neither
    unwrapper takes them, bare, scaled or with a nugget (as JAX
    ``tests/test_vecchia.py`` holds for the JAX package)."""
    kj, kt = _pair(name, KINDS[name])
    assert kt.kernel_map() is None
    for k, unwrap, unwrap_nug in ((kt, tk.unwrap_stationary, tk.unwrap_stationary_nugget),
                                  (kj, jk.unwrap_stationary, jk.unwrap_stationary_nugget)):
        white = agp.WhiteKernel() if k is kj else tk.WhiteKernel()
        assert unwrap(k) is None
        assert unwrap(2.0 * agp.with_lengthscale(k, 0.5) if k is kj
                      else 2.0 * tgp.with_lengthscale(k, 0.5)) is None
        assert unwrap_nug(k + 0.1 * white) is None
    # the product and the non-stationary kernels do not unwrap either
    for k in (_pair("product", 2.0)[1], tk.LinearKernel(), tk.PolynomialKernel()):
        assert tk.unwrap_stationary(k) is None and tk.unwrap_stationary_nugget(k) is None
    # the parameter-free maps still do
    assert tk.unwrap_stationary(tk.Matern32Kernel())[0].id == tk.KernelMapId.MATERN32


def test_torch_more_kernels_are_exported():
    for name in ("RationalQuadraticKernel", "PeriodicKernel", "LinearKernel", "PolynomialKernel",
                 "ProductKernel"):
        assert getattr(tgp, name) is getattr(tk, name) is getattr(tgp.core, name)
        assert name in tgp.__all__ and name in tk.__all__
