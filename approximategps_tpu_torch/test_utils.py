"""Shipped test utilities (port of ``approximategps_tpu/test_utils.py``, the
analogue of the reference's ``src/TestUtils.jl``): the fixed Bernoulli test
vector, the standard latent-GP builder, and the conformance checks that an
approximate posterior keeps the GP interface and, under a Gaussian
likelihood, equals exact GP regression.

The data land on the card unless the caller names another device, in f64 by
default (the checks' tolerances are f64 ones).  Random draws come from a
``torch.Generator`` seeded by ``seed``, so they are not the JAX package's
draws.  The functions named ``test_*`` are utilities, not tests: import the
module (``from approximategps_tpu_torch import test_utils``), not the
names, where pytest collects.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.distributions import standard_normals
from .core.gp import GP, LatentGP
from .core.gp import posterior as exact_posterior
from .core.kernels import Matern32Kernel, SqExponentialKernel, with_lengthscale
from .core.likelihoods import BernoulliLikelihood, FunctionLikelihood
from .models.api import approx_lml, posterior
from .utils.bijectors import softplus

__all__ = [
    "generate_data",
    "dist_y_given_f",
    "build_latent_gp",
    "check_internal_gp_interface",
    "test_approximation_predictions",
    "test_approx_lml",
]

# The reference's fixed data set: X = range(0, 23.5, 48); Y was drawn from
# Bernoulli(logistic(3 sin(10 + 0.6X) + sin(0.1X) − 1)) with a seed and then
# written out, so that results compare across implementations.
_Y_FIXED = [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0,
            0, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def generate_data(device="cuda", dtype=torch.float64):
    """(X (48,), Y (48,) int64): the fixed Bernoulli test vector."""
    X = torch.as_tensor(np.linspace(0.0, 23.5, 48), dtype=dtype, device=device)
    return X, torch.as_tensor(_Y_FIXED, device=device)


dist_y_given_f = BernoulliLikelihood()  # Bernoulli(logistic(f))


def build_latent_gp(theta):
    """softplus-constrained SE latent GP: variance softplus(θ₀), lengthscale
    softplus(θ₁), Bernoulli likelihood, jitter 1e-8."""
    kernel = softplus(theta[0]) * with_lengthscale(SqExponentialKernel(), softplus(theta[1]))
    return LatentGP(GP(kernel), dist_y_given_f, 1e-8)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def check_internal_gp_interface(generator, f_post, a, b, atol=1e-9):
    """The AbstractGPs interface of ``f_post``: mean, cov, var,
    mean_and_cov and mean_and_var consistent, shapes, a symmetric PSD cov,
    the FiniteGP round trip (marginals, a sample from ``generator``)."""
    N_a, N_b = a.shape[0], b.shape[0]
    m = f_post.mean(a)
    assert m.shape == (N_a,)
    C = f_post.cov(a)
    assert C.shape == (N_a, N_a)
    v = f_post.var(a)
    assert v.shape == (N_a,)
    np.testing.assert_allclose(_np(C), _np(C).T, atol=1e-8)
    eigs = np.linalg.eigvalsh(_np(C).astype(np.float64))
    assert eigs.min() > -1e-6, f"cov not PSD: min eig {eigs.min()}"
    np.testing.assert_allclose(np.diag(_np(C)), _np(v), atol=1e-8)
    m2, C2 = f_post.mean_and_cov(a)
    np.testing.assert_allclose(_np(m2), _np(m), atol=atol)
    np.testing.assert_allclose(_np(C2), _np(C), atol=atol)
    m3, v3 = f_post.mean_and_var(a)
    np.testing.assert_allclose(_np(m3), _np(m), atol=atol)
    np.testing.assert_allclose(_np(v3), _np(v), atol=atol)
    Cab = f_post.cov(a, b)
    assert Cab.shape == (N_a, N_b)
    np.testing.assert_allclose(_np(Cab), _np(f_post.cov(b, a)).T, atol=1e-8)
    fx = f_post(a, 1e-12)
    mm, vv = fx.marginals().marginals()
    np.testing.assert_allclose(_np(mm), _np(m), atol=1e-8)
    np.testing.assert_allclose(_np(vv), _np(v), atol=1e-6)
    assert fx.sample(generator).shape == (N_a,)


def _gaussian_lik(noise_scale: float) -> FunctionLikelihood:
    """N(f, noise_scale²) as a user function (the approximations under
    test do not see that it is Gaussian)."""

    def logpdf(fv, yv):
        return -0.5 * ((yv - fv) / noise_scale) ** 2 - math.log(noise_scale) \
            - 0.5 * math.log(2 * math.pi)

    def sampler(gen, fv):
        return fv + noise_scale * standard_normals(gen, fv.shape, fv)

    return FunctionLikelihood(logpdf=logpdf, sampler=sampler)


def test_approx_lml(approx, noise_scale=0.1, seed=123456, rtol=1e-4, atol=1e-5,
                    device="cuda", dtype=torch.float64):
    """Conjugate-case evidence check: ``approx_lml(approx, LatentGP(f,
    Gaussian(σ²), 0)(x), y)`` approximately equals the exact log marginal
    likelihood ``logpdf(f(x, σ²), y)``.  Holds for approximations that need
    no variational optimisation (Laplace; NearestNeighbors with k = N − 1,
    whose root ignores observation noise, so it is held to the noise-free
    evidence, as in the reference)."""
    from .models.vecchia import NearestNeighbors

    gen = torch.Generator(device=device).manual_seed(seed)
    f = GP(Matern32Kernel())
    x = torch.linspace(-1.0, 1.0, 6, dtype=dtype, device=device)
    fx = f(x, noise_scale**2)
    y = fx.sample(gen)
    exact = fx.logpdf(y)
    if isinstance(approx, NearestNeighbors):
        fx0 = f(x, 0.0)
        got = approx_lml(approx, fx0, y)
        exact = fx0.logpdf(y)
    else:
        got = approx_lml(approx, LatentGP(f, _gaussian_lik(noise_scale), 0.0)(x), y)
    np.testing.assert_allclose(got.detach().item(), exact.detach().item(), rtol=rtol, atol=atol)


def test_approximation_predictions(approx, noise_scale=0.1, seed=123456, device="cuda",
                                   dtype=torch.float64):
    """Conformance: the approximate posterior keeps the GP interface and,
    for a Gaussian likelihood, equals exact GP regression (the reference's
    ``test_approximation_predictions``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = GP(Matern32Kernel())
    x = torch.linspace(-1.0, 1.0, 5, dtype=dtype, device=device)
    y = f(x, noise_scale**2).sample(gen)
    f_approx_post = posterior(approx, LatentGP(f, _gaussian_lik(noise_scale), 0.0)(x), y)

    a = torch.linspace(-1.2, 1.2, 6, dtype=dtype, device=device)
    check_internal_gp_interface(gen, f_approx_post, a, standard_normals(gen, (7,), x))

    f_exact_post = exact_posterior(f(x, noise_scale**2), y)
    xt = torch.cat([x, standard_normals(gen, (3,), x)])
    m_approx, c_approx = f_approx_post.mean_and_cov(xt)
    m_exact, c_exact = f_exact_post.mean_and_cov(xt)
    np.testing.assert_allclose(_np(m_approx), _np(m_exact), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(c_approx), _np(c_exact), rtol=1e-5, atol=1e-7)
