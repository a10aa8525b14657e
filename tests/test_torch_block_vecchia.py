"""Block-Vecchia on the CPU, f64, against the JAX package: ``approx_lml``,
its θ-gradient and the posterior's mean and variance; b = 1 against the
port's scalar Vecchia; full conditioning against the exact GP; "nearest"
neighbours with the maximin ordering; the ``block_size`` divisibility
error.

Block-Vecchia runs no Pallas kernel in either package.  Inputs come from
numpy with fixed seeds, N ≤ 256."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

KERNELS = {"se": (agp.SqExponentialKernel, tgp.SqExponentialKernel),
           "matern32": (agp.Matern32Kernel, tgp.Matern32Kernel)}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _close(t, j, rtol, atol=0.0):
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(a, np.asarray(j), rtol=rtol, atol=atol)


def _data(N, D=1, seed=0, scale=None):
    """N points: in 1-D a jittered grid over [0, scale] (N by default), no
    two closer than 0.4 of its step, so that the noiseless Grams stay well
    conditioned, and a y smooth on that scale (the root has no noise to
    absorb anything rougher)."""
    rng = np.random.default_rng(seed)
    step = (scale or N) / N
    x = (((np.arange(N) + rng.uniform(-0.3, 0.3, N)) * step)[:, None] if D == 1
         else 2.0 * rng.standard_normal((N, D)))
    y = np.sin(x[:, 0] / 3.0) + 0.5 * np.cos(x[:, -1] / 5.0)
    return x, y


def _models(name, theta_j, theta_t):
    jcls, tcls = KERNELS[name]
    jk = jsoftplus(theta_j[0]) * agp.with_lengthscale(jcls(), jsoftplus(theta_j[1]))
    tk_ = tsoftplus(theta_t[0]) * tgp.with_lengthscale(tcls(), tsoftplus(theta_t[1]))
    return agp.GP(jk), tgp.GP(tk_)


@pytest.mark.parametrize("name,N,b,k", [("se", 64, 8, 8), ("matern32", 96, 4, 12),
                                         ("matern32", 256, 32, 32)])
def test_torch_block_vecchia_lml_grad_and_posterior_match_jax(name, N, b, k):
    """approx_lml and its gradient in raw (variance, lengthscale), and the
    posterior's mean and variance at 9 test points, to 1e-10."""
    x, y = _data(N)
    theta = np.array([0.3, 0.2])  # variance 0.85, lengthscale 0.80
    nn_j = agp.BlockNearestNeighbors(block_size=b, k=k)
    nn_t = tgp.BlockNearestNeighbors(block_size=b, k=k)

    def jlml(th):
        jf, _ = _models(name, th, _t(theta))
        return agp.approx_lml(nn_j, jf(jnp.asarray(x), 0.0), jnp.asarray(y))

    jv, jg = jax.jit(jax.value_and_grad(jlml))(jnp.asarray(theta))
    tth = _t(theta, True)
    _, tf = _models(name, jnp.asarray(theta), tth)
    tv = tgp.approx_lml(nn_t, tf(_t(x), 0.0), _t(y))
    (tg,) = torch.autograd.grad(tv, tth)
    _close(tv, jv, 1e-10)
    _close(tg, jg, 1e-10)

    jf, tf = _models(name, jnp.asarray(theta), _t(theta))
    xs = np.linspace(-5.0, N + 5.0, 9)[:, None]

    @jax.jit
    def jmean_var(xs):
        jpost = agp.posterior(nn_j, jf(jnp.asarray(x), 0.0), jnp.asarray(y))
        return jpost.mean(xs), jpost.var(xs)

    tpost = tgp.posterior(nn_t, tf(_t(x), 0.0), _t(y))
    assert isinstance(tpost.rep, tgp.BlockInvRoot)
    mj, vj = jmean_var(jnp.asarray(xs))
    _close(tpost.mean(_t(xs)), mj, 1e-10, 1e-10 * np.abs(mj).max())
    _close(tpost.var(_t(xs)), vj, 1e-10, 1e-10 * np.abs(vj).max())


def test_torch_block_size_one_equals_scalar_vecchia():
    """b = 1 is the port's scalar Vecchia (NearestNeighbors(k = 6)), to
    1e-9."""
    x, y = _data(48, seed=1, scale=100.0)
    f = tgp.GP(1.4 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.1))
    fx = f(_t(x), 0.0)
    scalar = tgp.approx_lml(tgp.NearestNeighbors(k=6), fx, _t(y))
    block = tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=1, k=6), fx, _t(y))
    _close(block, scalar, 1e-9)


@pytest.mark.parametrize("b", [4, 8, 16])
def test_torch_block_full_conditioning_equals_exact(b):
    """k covering every predecessor: the exact noiseless logpdf (1e-7) and
    the exact posterior's mean and variance (1e-6)."""
    x, y = _data(48, seed=2, scale=100.0)
    f = tgp.GP(1.4 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.1))
    nn = tgp.BlockNearestNeighbors(block_size=b, k=48)
    _close(tgp.approx_lml(nn, f(_t(x), 0.0), _t(y)), f(_t(x), 0.0).logpdf(_t(y)), 1e-7)
    post = tgp.posterior(nn, f(_t(x), 0.0), _t(y))
    gpr = tgp.posterior(f(_t(x), 1e-12), _t(y))
    xs = _t(np.linspace(0, 100, 9)[:, None])
    _close(post.mean(xs), gpr.mean(xs), 0, 1e-6)
    _close(post.var(xs), gpr.var(xs), 0, 1e-6)


def test_torch_block_nearest_with_maximin_matches_jax():
    """"nearest" neighbours of each block's centroid with the maximin
    ordering in 2-D: the ordering and neighbour sets equal the JAX
    package's, the lml equals the JAX package's (1e-10; its host search run
    as its ``_build_block_root`` runs it, the factors jitted), and it is
    closer to the exact one than "previous" at the same k."""
    from approximategps_tpu.models import block_vecchia as jbv

    x, y = _data(120, D=2, seed=3)
    jf = agp.GP(1.4 * agp.with_lengthscale(agp.SqExponentialKernel(), 1.1))
    tf = tgp.GP(1.4 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.1))
    kw = dict(block_size=8, k=24, ordering="maximin", neighbors="nearest")
    order = jbv.resolve_ordering(jnp.asarray(x), "maximin")
    Xo = jnp.asarray(x)[jnp.asarray(order)]
    nbr = jbv._block_neighbor_indices(120, 8, 24, "maximin", "nearest", Xo)

    @jax.jit
    def jlml(Xo, nbr, yo):
        C, Ls_inv = jbv.block_vecchia_factors(Xo, nbr, 8, jf.kernel)
        rep = jbv.BlockInvRoot(nbr=nbr, C=C, Ls_inv=Ls_inv)
        return -(rep.logdet() + 120 * np.log(2 * np.pi) + rep.quad(yo)) / 2.0

    jv = jlml(Xo, nbr, jnp.asarray(y)[jnp.asarray(order)])
    torder, tXo, trep = tgp.models.block_vecchia._build_block_root(
        tgp.BlockNearestNeighbors(**kw), tf(_t(x), 0.0))
    np.testing.assert_array_equal(torder.numpy(), order)
    np.testing.assert_array_equal(trep.nbr.numpy(), np.asarray(nbr))
    tv = tgp.approx_lml(tgp.BlockNearestNeighbors(**kw), tf(_t(x), 0.0), _t(y))
    _close(tv, jv, 1e-10)
    exact = tf(_t(x), 1e-8).logpdf(_t(y)).item()
    prev = tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=8, k=24), tf(_t(x), 0.0), _t(y))
    assert abs(tv.item() - exact) < abs(prev.item() - exact)


def test_torch_block_size_must_divide_n():
    x, y = _data(50)
    f = tgp.GP(tgp.SqExponentialKernel())
    with pytest.raises(ValueError, match="must divide"):
        tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=8, k=4), f(_t(x), 0.0), _t(y))
    with pytest.raises(ValueError, match="unknown neighbors"):
        tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=5, k=4, neighbors="scaled"),
                       f(_t(x), 0.0), _t(y))
