"""Leave-one-out cross-validation of the PyTorch port (``models/crossval.py``)
on the CPU, f64: against the JAX package (``loo_mean_and_var``,
``loo_logpdf`` and its gradient in the lengthscale, the noise and the
points, to 1e-10 relative to the largest entry), and a counterpart of each
test of ``tests/test_crossval.py`` (brute-force leave-one-out to rtol 1e-9,
central differences to rtol 1e-5).  No Pallas kernel is reached."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.models.crossval import loo_logpdf as jax_loo_logpdf
from approximategps_tpu.models.crossval import loo_mean_and_var as jax_loo_mean_and_var

torch.set_num_threads(1)
TOL = 1e-10


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _setup(n=14, noise=0.2, seed=0):
    f = tgp.GP(tgp.with_lengthscale(tgp.Matern52Kernel(), 0.7))
    x = torch.linspace(-2.0, 2.0, n, dtype=torch.float64)
    fx = f(x, noise)
    y = fx.sample(torch.Generator().manual_seed(seed))
    return f, x, y, fx


def _brute_force(f, x, y, noise, i):
    mask = torch.arange(x.shape[0]) != i
    p = tgp.core.posterior(f(x[mask], noise), y[mask])
    mu, var = p.mean_and_var(x[i:i + 1])
    return mu[0], var[0] + noise


def test_torch_loo_matches_brute_force():
    f, x, y, fx = _setup()
    mu, var = tgp.loo_mean_and_var(fx, y)
    for i in (0, 3, 7, 13):
        mu_i, var_i = _brute_force(f, x, y, 0.2, i)
        np.testing.assert_allclose(mu[i].item(), mu_i.item(), rtol=1e-9)
        np.testing.assert_allclose(var[i].item(), var_i.item(), rtol=1e-9)


def test_torch_loo_logpdf_matches_brute_force_sum():
    f, x, y, fx = _setup(n=10)
    total = 0.0
    for i in range(10):
        mu_i, var_i = _brute_force(f, x, y, 0.2, i)
        v = var_i.item()
        total += -0.5 * (np.log(2 * np.pi * v) + (y[i] - mu_i).item() ** 2 / v)
    np.testing.assert_allclose(tgp.loo_logpdf(fx, y).item(), total, rtol=1e-9)


def test_torch_loo_heteroscedastic_noise():
    """Per-point noise through C = K + diag(σ²)."""
    f = tgp.GP(tgp.SqExponentialKernel())
    x = torch.linspace(0.0, 3.0, 9, dtype=torch.float64)
    noise = 0.05 + 0.1 * torch.arange(9.0, dtype=torch.float64) / 9.0
    fx = f(x, noise)
    y = fx.sample(torch.Generator().manual_seed(1))
    mu, var = tgp.loo_mean_and_var(fx, y)
    i = 4
    mask = torch.arange(9) != i
    m_i, v_i = tgp.core.posterior(f(x[mask], noise[mask]), y[mask]).mean_and_var(x[i:i + 1])
    np.testing.assert_allclose(mu[i].item(), m_i[0].item(), rtol=1e-9)
    np.testing.assert_allclose(var[i].item(), (v_i[0] + noise[i]).item(), rtol=1e-9)


def _obj(x, y):
    def obj(params):
        f = tgp.GP(tgp.with_lengthscale(tgp.Matern52Kernel(), torch.exp(params[0])))
        return tgp.loo_logpdf(f(x, torch.exp(params[1])), y)

    return obj


def test_torch_loo_logpdf_gradient_matches_fd():
    """GPML eq. 5.13 by autograd through the composite, against central
    differences in (log lengthscale, log noise)."""
    _, x, y, _ = _setup(n=12)
    obj = _obj(x, y)
    p0 = torch.tensor([np.log(0.6), np.log(0.15)], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(obj(p0), p0)
    h = 1e-6
    with torch.no_grad():
        for k in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[k] = h
            fd = (obj(p0 + e) - obj(p0 - e)) / (2 * h)
            np.testing.assert_allclose(g[k].item(), fd.item(), rtol=1e-5)


def test_torch_loo_prefers_true_lengthscale():
    f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.5))
    x = torch.linspace(-3.0, 3.0, 60, dtype=torch.float64)
    y = f(x, 0.1).sample(torch.Generator().manual_seed(2))

    def score(ls):
        g = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), ls))
        return tgp.loo_logpdf(g(x, 0.1), y).item()

    assert score(0.5) > score(0.05)
    assert score(0.5) > score(5.0)


def test_torch_loo_matches_jax():
    """The LOO moments, the score, and its gradient in the lengthscale, the
    per-point noise and the points against jax.grad (heteroscedastic noise,
    inputs in 2-D)."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (16, 2))
    y = np.sin(X[:, 0]) + 0.3 * rng.standard_normal(16)
    noise = 0.05 + 0.1 * rng.uniform(size=16)

    def jscore(lls, nz, Xv):
        f = agp.GP(1.3 * agp.with_lengthscale(agp.Matern32Kernel(), jnp.exp(lls)))
        return jax_loo_logpdf(f(Xv, nz), jnp.asarray(y))

    args = (np.log(np.array([0.8, 1.1])), noise, X)
    jv, jg = jax.value_and_grad(jscore, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in args))
    targs = [_t(a, True) for a in args]
    f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.Matern32Kernel(), torch.exp(targs[0])))
    tv = tgp.loo_logpdf(f(targs[2], targs[1]), _t(y))
    tg = torch.autograd.grad(tv, targs)
    assert _rel(tv, jv) < TOL
    for a, b in zip(tg, jg):
        assert _rel(a, b) < TOL
    fj = agp.GP(1.3 * agp.with_lengthscale(agp.Matern32Kernel(), jnp.array([0.8, 1.1])))
    ft = tgp.GP(1.3 * tgp.with_lengthscale(tgp.Matern32Kernel(), _t([0.8, 1.1])))
    jm, jvar = jax_loo_mean_and_var(fj(jnp.asarray(X), jnp.asarray(noise)), jnp.asarray(y))
    tm, tvar = tgp.loo_mean_and_var(ft(_t(X), _t(noise)), _t(y))
    assert _rel(tm, jm) < TOL and _rel(tvar, jvar) < TOL
