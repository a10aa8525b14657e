"""Hyperpriors and MAP objectives (port of
``approximategps_tpu/utils/priors.py``): scalar log-densities over
constrained hyperparameter values, composed with the bijector that produced
them (softplus's log|det Jacobian| included, so that the MAP objective is a
proper density over the unconstrained optimization space)."""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from .bijectors import softplus

__all__ = [
    "normal_prior",
    "lognormal_prior",
    "gamma_prior",
    "halfnormal_prior",
    "log_prior",
    "map_objective",
]

_LOG2PI = math.log(2.0 * math.pi)


def _like(v, theta: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=theta.dtype, device=theta.device)


def normal_prior(loc=0.0, scale=1.0) -> Callable:
    """log N(theta; loc, scale²)."""

    def logpdf(theta):
        theta = torch.as_tensor(theta)
        s = _like(scale, theta)
        z = (theta - loc) / s
        return torch.sum(-0.5 * (z * z + _LOG2PI) - torch.log(s))

    return logpdf


def lognormal_prior(loc=0.0, scale=1.0) -> Callable:
    """log LogNormal(theta; loc, scale²) for theta > 0."""

    def logpdf(theta):
        theta = torch.as_tensor(theta)
        s = _like(scale, theta)
        lt = torch.log(theta)
        z = (lt - loc) / s
        return torch.sum(-0.5 * (z * z + _LOG2PI) - torch.log(s) - lt)

    return logpdf


def gamma_prior(concentration=1.0, rate=1.0) -> Callable:
    """log Gamma(theta; α, rate) for theta > 0."""

    def logpdf(theta):
        theta = torch.as_tensor(theta)
        a = _like(concentration, theta)
        b = _like(rate, theta)
        return torch.sum(a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(theta)
                         - b * theta)

    return logpdf


def halfnormal_prior(scale=1.0) -> Callable:
    """log HalfNormal(theta; scale) for theta > 0."""

    def logpdf(theta):
        theta = torch.as_tensor(theta)
        s = _like(scale, theta)
        z = theta / s
        return torch.sum(-0.5 * (z * z + _LOG2PI) - torch.log(s) + math.log(2.0))

    return logpdf


def _softplus_logdet(raw: torch.Tensor) -> torch.Tensor:
    """log|d softplus(raw)/d raw| = log sigmoid(raw)."""
    return torch.sum(torch.nn.functional.logsigmoid(raw))


def log_prior(raw_params: Mapping[str, torch.Tensor], priors: Mapping[str, Callable],
              transform=softplus) -> torch.Tensor:
    """Σ log p(transform(raw_k)) + log|J_transform| over the keys in
    ``priors``: the unconstrained-space density for MAP.  ``transform``
    applies to every prior-carrying leaf (softplus by default; None puts
    the priors on the raw values)."""
    total = None
    for k, prior in priors.items():
        raw = torch.as_tensor(raw_params[k])
        term = prior(raw) if transform is None else prior(transform(raw)) + _softplus_logdet(raw)
        total = term if total is None else total + term
    return torch.zeros((), dtype=torch.float64) if total is None else total


def map_objective(neg_lml: Callable, priors: Mapping[str, Callable],
                  transform=softplus) -> Callable:
    """Wrap ``neg_lml(raw_params) -> scalar`` into the MAP objective
    ``neg_lml(raw) − log p(constrained(raw))`` (still a minimisation)."""

    def objective(raw_params, *args, **kwargs):
        return neg_lml(raw_params, *args, **kwargs) - log_prior(raw_params, priors, transform)

    return objective
