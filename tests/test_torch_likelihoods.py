"""The port's likelihoods and quadratures on the CPU, f64, against the JAX
package: ``log_prob``, the analytic expectation, ``log_prob_d1_d2`` and
``fisher_information`` of every likelihood and mode, Gauss–Hermite and
Monte-Carlo expectations (the same normal draws handed to both packages),
and ``conditional_sample``'s support and first two moments.

No JAX function here reaches a Pallas kernel.  Inputs come from numpy with
a fixed seed; tolerances 1e-12 (relative, with an absolute floor of 1e-12
for entries near zero)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp

torch.set_num_threads(1)

N = 64


def _pair(name):
    """(JAX likelihood, port likelihood, observations as numpy) of a case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    counts = rng.poisson(2.0, N).astype(np.int64)
    positive = rng.gamma(2.0, 1.0, N)
    binary = rng.integers(0, 2, N)
    real = rng.standard_normal(N)
    cases = {
        "gaussian": (agp.GaussianLikelihood(0.3), tgp.GaussianLikelihood(0.3), real),
        "bernoulli_logit": (agp.BernoulliLikelihood(), tgp.BernoulliLikelihood(), binary),
        "bernoulli_probit": (agp.BernoulliLikelihood(link="probit"),
                             tgp.BernoulliLikelihood(link="probit"), binary),
        "poisson_exp": (agp.PoissonLikelihood(), tgp.PoissonLikelihood(), counts),
        "poisson_softplus": (agp.PoissonLikelihood(link="softplus"),
                             tgp.PoissonLikelihood(link="softplus"), counts),
        "exponential": (agp.ExponentialLikelihood(), tgp.ExponentialLikelihood(), positive),
        "gamma": (agp.GammaLikelihood(2.5), tgp.GammaLikelihood(2.5), positive),
        "negbin_success": (agp.NegativeBinomialLikelihood(2.5),
                           tgp.NegativeBinomialLikelihood(2.5), counts),
        "negbin_failure": (agp.NegativeBinomialLikelihood(2.5, param="failure"),
                           tgp.NegativeBinomialLikelihood(2.5, param="failure"), counts),
        "studentt": (agp.StudentTLikelihood(5.0, 0.7), tgp.StudentTLikelihood(5.0, 0.7), real),
        "gaussnewton_clamp": (agp.GaussNewtonLikelihood(agp.StudentTLikelihood(5.0, 0.7)),
                              tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(5.0, 0.7)), real),
        "gaussnewton_fisher": (
            agp.GaussNewtonLikelihood(agp.StudentTLikelihood(5.0, 0.7), mode="fisher"),
            tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(5.0, 0.7), mode="fisher"), real),
        # a user function, pointwise and not log-concave everywhere
        "function": (agp.FunctionLikelihood(logpdf=lambda f, y: -0.5 * (y - f) ** 2 - 0.1 * f ** 4),
                     tgp.as_likelihood(lambda f, y: -0.5 * (y - f) ** 2 - 0.1 * f ** 4), real),
    }
    return cases[name]


NAMES = ["gaussian", "bernoulli_logit", "bernoulli_probit", "poisson_exp", "poisson_softplus",
         "exponential", "gamma", "negbin_success", "negbin_failure", "studentt",
         "gaussnewton_clamp", "gaussnewton_fisher", "function"]


def _f(seed=1, n=N, scale=1.5):
    return scale * np.random.default_rng(seed).standard_normal(n)


def _close(t, j, tol=1e-12):
    a, b = np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t), np.asarray(j)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_torch_likelihood_matches_jax(name):
    """log_prob, the analytic expectation (None where the JAX one is None),
    log_prob_d1_d2 and fisher_information (None where the JAX one is) to
    1e-12."""
    jl, tl, y = _pair(name)
    f = _f()
    qv = np.random.default_rng(2).uniform(0.05, 0.8, N)
    ft, yt, qvt = torch.tensor(f), torch.tensor(y), torch.tensor(qv)
    fj, yj = jnp.asarray(f), jnp.asarray(y)
    _close(tl.log_prob(ft, yt), jl.log_prob(fj, yj))
    ja = jl.expected_log_prob_analytic(fj, jnp.asarray(qv), yj)
    ta = tl.expected_log_prob_analytic(ft, qvt, yt)
    assert (ja is None) == (ta is None)
    if ja is not None:
        _close(ta, ja)
    for got, want in zip(tl.log_prob_d1_d2(ft, yt), jl.log_prob_d1_d2(fj, yj)):
        _close(got, want)
    jf, tf = jl.fisher_information(fj, yj), tl.fisher_information(ft, yt)
    assert (jf is None) == (tf is None)
    if jf is not None:
        _close(tf, jf)


@pytest.mark.parametrize("name", NAMES)
def test_torch_gauss_hermite_matches_jax(name):
    jl, tl, y = _pair(name)
    f = _f(seed=3)
    qv = np.random.default_rng(4).uniform(0.05, 0.8, N)
    got = tgp.GaussHermite(20).expected_loglik(tl, torch.tensor(f), torch.tensor(qv),
                                               torch.tensor(y))
    want = agp.GaussHermite(20).expected_loglik(jl, jnp.asarray(f), jnp.asarray(qv),
                                                jnp.asarray(y))
    _close(got, want)


@pytest.mark.parametrize("name", ["gaussian", "poisson_exp", "bernoulli_logit", "studentt"])
def test_torch_monte_carlo_matches_jax_with_the_same_draws(name, monkeypatch):
    """The port draws its normals from its generator; the JAX package gets
    the same draws through a patched ``jax.random.normal``."""
    jl, tl, y = _pair(name)
    f = _f(seed=5)
    qv = np.random.default_rng(6).uniform(0.05, 0.8, N)
    n = 17
    eps = torch.randn((n, N), generator=torch.Generator().manual_seed(11), dtype=torch.float64)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(eps.numpy(), dtype=dtype))
    got = tgp.MonteCarlo(n, generator=torch.Generator().manual_seed(11)).expected_loglik(
        tl, torch.tensor(f), torch.tensor(qv), torch.tensor(y))
    want = agp.MonteCarlo(n, key=jax.random.PRNGKey(0)).expected_loglik(
        jl, jnp.asarray(f), jnp.asarray(qv), jnp.asarray(y))
    _close(got, want)


def test_torch_monte_carlo_raises_without_a_generator():
    with pytest.raises(ValueError, match="generator"):
        tgp.MonteCarlo(4).expected_loglik(tgp.GaussianLikelihood(0.1), torch.zeros(3),
                                          torch.ones(3), torch.zeros(3))


def test_torch_poisson_takes_integer_counts():
    """Counts given as an integer tensor are cast to f's dtype."""
    lik = tgp.PoissonLikelihood()
    f = torch.tensor(_f(seed=7, n=9))
    y = torch.arange(9)
    assert lik.log_prob(f, y).dtype == torch.float64
    _close(lik.log_prob(f, y), lik.log_prob(f, y.double()))
    _close(lik.expected_log_prob_analytic(f, f.abs(), y),
           lik.expected_log_prob_analytic(f, f.abs(), y.double()))


def test_torch_gauss_newton_fisher_raises_without_a_closed_form():
    lik = tgp.GaussNewtonLikelihood(tgp.ExponentialLikelihood(), mode="fisher")
    with pytest.raises(NotImplementedError, match="fisher_information"):
        lik.log_prob_d1_d2(torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64))


def _sig(x):
    return 1.0 / (1.0 + math.exp(-x))


F0 = 0.3
# (likelihood, support check, mean, variance) of y | f = F0
SAMPLES = {
    "gaussian": (tgp.GaussianLikelihood(0.3), None, F0, 0.3),
    "bernoulli_logit": (tgp.BernoulliLikelihood(), "binary", _sig(F0), _sig(F0) * (1 - _sig(F0))),
    "bernoulli_probit": (tgp.BernoulliLikelihood(link="probit"), "binary",
                         0.5 * math.erfc(-F0 / math.sqrt(2)),
                         0.5 * math.erfc(-F0 / math.sqrt(2)) * (1 - 0.5 * math.erfc(-F0 / math.sqrt(2)))),
    "poisson_exp": (tgp.PoissonLikelihood(), "count", math.exp(F0), math.exp(F0)),
    "poisson_softplus": (tgp.PoissonLikelihood(link="softplus"), "count",
                         math.log1p(math.exp(F0)), math.log1p(math.exp(F0))),
    "exponential": (tgp.ExponentialLikelihood(), "positive", math.exp(F0), math.exp(2 * F0)),
    "gamma": (tgp.GammaLikelihood(2.5), "positive", 2.5 * math.exp(F0), 2.5 * math.exp(2 * F0)),
    "negbin_success": (tgp.NegativeBinomialLikelihood(2.5), "count", 2.5 * math.exp(-F0),
                       2.5 * math.exp(-F0) / _sig(F0)),
    "negbin_failure": (tgp.NegativeBinomialLikelihood(2.5, param="failure"), "count",
                       2.5 * math.exp(F0), 2.5 * math.exp(F0) / _sig(-F0)),
    "studentt": (tgp.StudentTLikelihood(5.0, 0.7), None, F0, 0.49 * 5.0 / 3.0),
    "gaussnewton": (tgp.GaussNewtonLikelihood(tgp.PoissonLikelihood()), "count", math.exp(F0),
                    math.exp(F0)),
    "function": (tgp.FunctionLikelihood(
        logpdf=lambda f, y: -0.5 * (y - f) ** 2,
        sampler=lambda g, f: f + torch.randn(f.shape, generator=g, dtype=f.dtype)), None, F0, 1.0),
}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_torch_conditional_sample_support_and_moments(name):
    """10^5 draws of y | f = 0.3: the support, and the sample mean and
    variance within 5 standard errors of the exact ones (the variance's
    error from the draws' own fourth moment)."""
    lik, support, mean, var = SAMPLES[name]
    n = 100_000
    y = lik.conditional_sample(torch.Generator().manual_seed(3),
                               torch.full((n,), F0, dtype=torch.float64))
    assert y.shape == (n,)
    yd = y.double()
    if support == "binary":
        assert y.dtype == torch.int32 and bool(((y == 0) | (y == 1)).all())
    elif support == "count":
        assert bool((yd >= 0).all()) and bool((yd == torch.round(yd)).all())
    elif support == "positive":
        assert bool((yd > 0).all())
    m = yd.mean().item()
    v = yd.var().item()
    m4 = ((yd - m) ** 4).mean().item()
    assert abs(m - mean) <= 5 * math.sqrt(var / n), (m, mean)
    assert abs(v - var) <= 5 * math.sqrt(max(m4 - v * v, 0.0) / n), (v, var)
