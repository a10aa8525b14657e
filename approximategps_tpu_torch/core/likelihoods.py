"""Observation likelihoods (port of ``approximategps_tpu/core/likelihoods.py``).

Each likelihood is a frozen dataclass with:

- ``log_prob(f, y)``: pointwise log p(y|f), broadcastable (the Gauss–Hermite
  and Monte-Carlo sums call it on (n, N) nodes);
- ``expected_log_prob_analytic(q_mean, q_var, y)``: the closed-form
  E_{N(q_mean, q_var)}[log p(y|f)] where one exists (Gaussian, exp-link
  Poisson, Exponential and Gamma), else None;
- ``log_prob_d1_d2(f, y)``: (Σ log p, ∂/∂f, ∂²/∂f² per point), closed forms
  where the JAX package has them and autograd of the pointwise ``log_prob``
  otherwise (the JAX package's forward-over-forward ``jax.grad``);
- ``fisher_information(f, y)``: E_y[−∂²/∂f² log p] per point, or None;
- ``conditional_sample(generator, f)``: y | f drawn with an explicit
  ``torch.Generator`` (on ``f``'s device).

The numerically careful forms are kept: log-sigmoid through softplus (as
``logaddexp(0, ·)``, exact at every f where ``torch.nn.functional.softplus``
switches to the identity above 20) and ``lgamma`` for the count
likelihoods.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = [
    "Likelihood",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "PoissonLikelihood",
    "ExponentialLikelihood",
    "GammaLikelihood",
    "NegativeBinomialLikelihood",
    "GaussNewtonLikelihood",
    "StudentTLikelihood",
    "FunctionLikelihood",
    "as_likelihood",
]

_LOG2PI = math.log(2.0 * math.pi)


def _param(v, like: torch.Tensor) -> torch.Tensor:
    """A parameter in ``like``'s dtype; a 0-dim tensor stays where it is (it
    broadcasts onto any device), a larger one moves to ``like``'s."""
    v = torch.as_tensor(v, dtype=like.dtype)
    return v if v.ndim == 0 else v.to(like.device)


def _obs(y, like: torch.Tensor) -> torch.Tensor:
    """Observations in ``like``'s dtype and device (integer counts included)."""
    return torch.as_tensor(y, device=like.device).to(like.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(torch.zeros_like(x), x)


def _autograd_d1_d2(lik: "Likelihood", f: torch.Tensor, y):
    """(Σ log p, ∂/∂f, ∂²/∂f²) by autograd of the pointwise ``log_prob``
    (each point's log p depends on its own f only, so the gradient of the
    sum is the per-point derivative).  Builds a graph for the results
    where gradients are enabled, as the JAX version stays differentiable."""
    build = torch.is_grad_enabled()
    with torch.enable_grad():
        fr = f if build and f.requires_grad else f.detach().requires_grad_()
        lp = lik.log_prob(fr, y)
        (d1,) = torch.autograd.grad(lp.sum(), fr, create_graph=True)
        if d1.requires_grad:
            (d2,) = torch.autograd.grad(d1.sum(), fr, create_graph=build,
                                        materialize_grads=True)
        else:
            d2 = torch.zeros_like(f)
    ll = lp.sum()
    if not build:
        ll, d1, d2 = ll.detach(), d1.detach(), d2.detach()
    return ll, d1, d2


class Likelihood:
    def log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        """Closed-form E_{N(q_mean, q_var)}[log p(y|f)] or None."""
        return None

    def log_prob_d1_d2(self, f: torch.Tensor, y):
        """(sum of log_prob, dll/df per point, d2ll/df2 per point), by
        autograd where the class has no closed form."""
        return _autograd_d1_d2(self, f, y)

    def conditional_sample(self, generator: torch.Generator, f: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def fisher_information(self, f: torch.Tensor, y):
        """Per-point Fisher information E_{y~p(·|f)}[−∂²/∂f² log p(y|f)] (≥ 0),
        or None where no closed form is implemented."""
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianLikelihood(Likelihood):
    """y | f ~ N(f, σ²)."""

    obs_variance: torch.Tensor | float = 1.0

    def log_prob(self, f, y):
        s2 = _param(self.obs_variance, f)
        return -0.5 * (_LOG2PI + torch.log(s2) + (y - f) ** 2 / s2)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        s2 = _param(self.obs_variance, q_mean)
        return -0.5 * (_LOG2PI + torch.log(s2) + ((y - q_mean) ** 2 + q_var) / s2)

    def log_prob_d1_d2(self, f, y):
        s2 = _param(self.obs_variance, f)
        ll = torch.sum(self.log_prob(f, y))
        return ll, (y - f) / s2, torch.zeros_like(f) - 1.0 / s2

    def fisher_information(self, f, y):
        return torch.zeros_like(f) + 1.0 / _param(self.obs_variance, f)

    def conditional_sample(self, generator, f):
        s = torch.sqrt(_param(self.obs_variance, f))
        return f + s * torch.randn(f.shape, generator=generator, dtype=f.dtype, device=f.device)


@dataclasses.dataclass(frozen=True, eq=False)
class BernoulliLikelihood(Likelihood):
    """y | f ~ Bernoulli(invlink(f)): the logistic link by default,
    ``link="probit"`` the normal CDF."""

    link: str = "logit"

    def log_prob(self, f, y):
        y = _obs(y, f)
        if self.link == "logit":
            return y * f - _softplus(f)
        if self.link == "probit":
            return torch.special.log_ndtr((2.0 * y - 1.0) * f)
        raise ValueError(f"unknown Bernoulli link: {self.link}")

    def log_prob_d1_d2(self, f, y):
        if self.link != "logit":
            return super().log_prob_d1_d2(f, y)
        y = _obs(y, f)
        p = torch.sigmoid(f)
        return torch.sum(self.log_prob(f, y)), y - p, -p * (1.0 - p)

    def conditional_sample(self, generator, f):
        p = torch.sigmoid(f) if self.link == "logit" else torch.special.ndtr(f)
        return torch.bernoulli(p, generator=generator).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class PoissonLikelihood(Likelihood):
    """y | f ~ Poisson(invlink(f)): the exp link by default, or
    ``link="softplus"``."""

    link: str = "exp"

    def _log_rate(self, f):
        if self.link == "exp":
            return f
        if self.link == "softplus":
            return torch.log(_softplus(f))
        raise ValueError(f"unknown Poisson link: {self.link}")

    def log_prob(self, f, y):
        y = _obs(y, f)
        log_rate = self._log_rate(f)
        return y * log_rate - torch.exp(log_rate) - torch.lgamma(y + 1.0)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        if self.link != "exp":
            return None
        y = _obs(y, q_mean)
        # E[y f − e^f − log y!] = y μ − e^{μ + v/2} − log y!
        return y * q_mean - torch.exp(q_mean + 0.5 * q_var) - torch.lgamma(y + 1.0)

    def log_prob_d1_d2(self, f, y):
        if self.link != "exp":
            return super().log_prob_d1_d2(f, y)
        y = _obs(y, f)
        rate = torch.exp(f)
        return torch.sum(self.log_prob(f, y)), y - rate, -rate

    def conditional_sample(self, generator, f):
        return torch.poisson(torch.exp(self._log_rate(f)), generator=generator)


@dataclasses.dataclass(frozen=True, eq=False)
class ExponentialLikelihood(Likelihood):
    """y | f ~ Exponential(scale = invlink(f)), exp link."""

    link: str = "exp"

    def log_prob(self, f, y):
        if self.link != "exp":
            raise ValueError("only exp link implemented")
        # scale θ = e^f: ll = −f − y e^{−f}
        return -f - _obs(y, f) * torch.exp(-f)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        if self.link != "exp":
            return None
        return -q_mean - _obs(y, q_mean) * torch.exp(-q_mean + 0.5 * q_var)

    def conditional_sample(self, generator, f):
        return torch.empty_like(f).exponential_(generator=generator) * torch.exp(f)


def _standard_gamma(a: torch.Tensor, like: torch.Tensor, generator) -> torch.Tensor:
    """Gamma(a, 1) draws of ``like``'s shape."""
    conc = torch.zeros_like(like) + a.to(like.device)
    return torch._standard_gamma(conc, generator=generator)


@dataclasses.dataclass(frozen=True, eq=False)
class GammaLikelihood(Likelihood):
    """y | f ~ Gamma(shape = α, scale = invlink(f)), exp link."""

    shape_param: torch.Tensor | float = 1.0
    link: str = "exp"

    def log_prob(self, f, y):
        if self.link != "exp":
            raise ValueError("only exp link implemented")
        y = _obs(y, f)
        a = _param(self.shape_param, f)
        return (a - 1.0) * torch.log(y) - y * torch.exp(-f) - a * f - torch.lgamma(a)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        if self.link != "exp":
            return None
        y = _obs(y, q_mean)
        a = _param(self.shape_param, q_mean)
        return ((a - 1.0) * torch.log(y) - y * torch.exp(-q_mean + 0.5 * q_var)
                - a * q_mean - torch.lgamma(a))

    def conditional_sample(self, generator, f):
        a = _param(self.shape_param, f)
        return _standard_gamma(a, f, generator) * torch.exp(f)


@dataclasses.dataclass(frozen=True, eq=False)
class NegativeBinomialLikelihood(Likelihood):
    """y | f ~ NegativeBinomial(r, p) with a logistic link (GPLikelihoods'
    ``NBParamSuccess`` / ``NBParamFailure``):

    - ``param="success"`` (default): ``r`` successes, success probability
      p = σ(f); y counts the failures before the r-th success;
    - ``param="failure"``: ``r`` failures, failure probability σ(f), the
      same as "success" with f → −f.

    log p(y|f) = log C(y+r−1, y) − r·softplus(−f) − y·softplus(f) is
    log-concave in f; the Fisher information is r·σ(−f)."""

    successes: torch.Tensor | float = 1.0
    param: str = "success"

    def _signed_f(self, f):
        if self.param == "success":
            return f
        if self.param == "failure":
            return -f
        raise ValueError(f"unknown NegativeBinomial param: {self.param!r}")

    def log_prob(self, f, y):
        y = _obs(y, f)
        r = _param(self.successes, f)
        g = self._signed_f(f)
        # log σ(g) = −softplus(−g), log σ(−g) = −softplus(g)
        return (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
                - r * _softplus(-g) - y * _softplus(g))

    def log_prob_d1_d2(self, f, y):
        y = _obs(y, f)
        r = _param(self.successes, f)
        sgn = 1.0 if self.param == "success" else -1.0
        g = self._signed_f(f)
        p, q = torch.sigmoid(g), torch.sigmoid(-g)
        return torch.sum(self.log_prob(f, y)), sgn * (r * q - y * p), -(r + y) * p * q

    def fisher_information(self, f, y):
        return _param(self.successes, f) * torch.sigmoid(-self._signed_f(f))

    def conditional_sample(self, generator, f):
        # Gamma–Poisson mixture: λ ~ Gamma(r, scale = (1 − p)/p), y ~ Poisson(λ)
        r = _param(self.successes, f)
        lam = _standard_gamma(r, f, generator) * torch.exp(-self._signed_f(f))
        return torch.poisson(lam, generator=generator)


@dataclasses.dataclass(frozen=True, eq=False)
class StudentTLikelihood(Likelihood):
    """y | f ~ StudentT(ν, loc = f, scale = σ)."""

    df: torch.Tensor | float = 3.0
    scale: torch.Tensor | float = 1.0

    def log_prob(self, f, y):
        y = _obs(y, f)
        nu = _param(self.df, f)
        s = _param(self.scale, f)
        z = (y - f) / s
        return (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
                - 0.5 * torch.log(nu * math.pi) - torch.log(s)
                - 0.5 * (nu + 1.0) * torch.log1p(z * z / nu))

    def conditional_sample(self, generator, f):
        # t = N(0, 1) / sqrt(χ²_ν / ν), χ²_ν = 2·Gamma(ν/2)
        nu = _param(self.df, f)
        z = torch.randn(f.shape, generator=generator, dtype=f.dtype, device=f.device)
        chi2 = 2.0 * _standard_gamma(0.5 * nu, f, generator)
        return f + _param(self.scale, f) * z / torch.sqrt(chi2 / nu)

    def fisher_information(self, f, y):
        # the location Fisher information of Student-t: (ν+1)/((ν+3)σ²)
        nu = _param(self.df, f)
        s2 = _param(self.scale, f) ** 2
        return torch.zeros_like(f) + (nu + 1.0) / ((nu + 3.0) * s2)


@dataclasses.dataclass(frozen=True, eq=False)
class GaussNewtonLikelihood(Likelihood):
    """PSD-curvature surrogate for likelihoods that are not log-concave.

    ``log_prob`` and the first derivative are the inner likelihood's; the
    second derivative is replaced by a PSD surrogate so that the Laplace
    Newton iteration's W = −∂²ll ≥ 0:

    - ``mode="clamp"``: W = max(−∂²ll, floor), the observed curvature
      floored;
    - ``mode="fisher"``: W = the inner likelihood's Fisher information (the
      Gauss–Newton / Fisher-scoring choice).

    The Newton fixed point is unchanged (any PSD W preconditions the same
    stationarity condition); the Laplace lml, covariance and gradients use
    the surrogate curvature consistently."""

    inner: Likelihood
    mode: str = "clamp"
    floor: float = 1e-6

    def log_prob(self, f, y):
        return self.inner.log_prob(f, y)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        return self.inner.expected_log_prob_analytic(q_mean, q_var, y)

    def conditional_sample(self, generator, f):
        return self.inner.conditional_sample(generator, f)

    def fisher_information(self, f, y):
        return self.inner.fisher_information(f, y)

    def log_prob_d1_d2(self, f, y):
        ll, d1, d2 = self.inner.log_prob_d1_d2(f, y)
        if self.mode == "fisher":
            fi = self.inner.fisher_information(f, y)
            if fi is None:
                raise NotImplementedError(
                    f"{type(self.inner).__name__} has no closed-form "
                    "fisher_information; use mode='clamp'"
                )
            return ll, d1, -fi
        if self.mode != "clamp":
            raise ValueError(f"unknown GaussNewton mode: {self.mode!r}")
        return ll, d1, torch.clamp(d2, max=-self.floor)


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionLikelihood(Likelihood):
    """A user-supplied pointwise ``logpdf(f, y)`` (and optionally
    ``sampler(generator, f)``)."""

    logpdf: Callable
    sampler: Callable | None = None

    def log_prob(self, f, y):
        return self.logpdf(f, y)

    def conditional_sample(self, generator, f):
        if self.sampler is None:
            raise NotImplementedError("FunctionLikelihood has no sampler")
        return self.sampler(generator, f)


def as_likelihood(obj) -> Likelihood:
    if isinstance(obj, Likelihood):
        return obj
    if callable(obj):
        return FunctionLikelihood(logpdf=obj)
    raise TypeError(f"cannot interpret {obj!r} as a likelihood")
