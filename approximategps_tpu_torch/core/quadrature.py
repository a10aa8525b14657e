"""Expectation quadrature (port of ``approximategps_tpu/core/quadrature.py``:
``Analytic``, ``GaussHermite``, ``MonteCarlo``, ``DefaultExpectationMethod``
and ``expected_loglikelihood``)."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

__all__ = [
    "GaussHermite",
    "MonteCarlo",
    "Analytic",
    "DefaultExpectationMethod",
    "expected_loglikelihood",
    "gauss_hermite_points",
]


@functools.lru_cache(maxsize=32)
def _hermgauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    return np.polynomial.hermite.hermgauss(n)


def _safe_sqrt(var: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at zero with a finite gradient everywhere (a variance
    from a cancellation can dip below zero in f32)."""
    tiny = torch.finfo(var.dtype).tiny
    return torch.where(var > 0, torch.sqrt(torch.clamp(var, min=tiny)), 0.0)


def gauss_hermite_points(n: int, mean: torch.Tensor, var: torch.Tensor):
    """Gauss–Hermite abscissae (n,) + mean.shape and weights (n,), summing
    to 1, for E_{N(mean, var)}[g(f)]."""
    xs, ws = _hermgauss(n)
    like = dict(dtype=mean.dtype, device=mean.device)
    xs = torch.as_tensor(xs, **like)
    ws = torch.as_tensor(ws / math.sqrt(math.pi), **like)
    sigma = _safe_sqrt(var)
    f_nodes = mean[None, ...] + math.sqrt(2.0) * sigma[None, ...] * xs.reshape(
        (n,) + (1,) * mean.ndim
    )
    return f_nodes, ws


@dataclasses.dataclass(frozen=True)
class GaussHermite:
    """Fixed-order Gauss–Hermite quadrature."""

    n_points: int = 20

    def expected_loglik(self, lik, q_mean, q_var, y):
        f_nodes, ws = gauss_hermite_points(self.n_points, q_mean, q_var)
        lls = lik.log_prob(f_nodes, y[None, ...])  # (n_points, N)
        return torch.tensordot(ws, lls, dims=1)


@dataclasses.dataclass(frozen=True, eq=False)
class MonteCarlo:
    """Monte-Carlo expectation over ``n_samples`` draws of q(f) from an
    explicit ``torch.Generator`` on the inputs' device."""

    n_samples: int = 20
    generator: torch.Generator | None = None

    def expected_loglik(self, lik, q_mean, q_var, y):
        if self.generator is None:
            raise ValueError(
                "MonteCarlo requires an explicit generator: MonteCarlo(n, generator=...)."
                " A fixed default seed would silently reuse identical samples every step."
            )
        eps = torch.randn((self.n_samples,) + tuple(q_mean.shape), generator=self.generator,
                          dtype=q_mean.dtype, device=q_mean.device)
        f_samples = q_mean[None, ...] + _safe_sqrt(q_var)[None, ...] * eps
        return torch.mean(lik.log_prob(f_samples, y[None, ...]), dim=0)


@dataclasses.dataclass(frozen=True)
class Analytic:
    """The closed-form expectation; raises where the likelihood has none."""

    def expected_loglik(self, lik, q_mean, q_var, y):
        out = lik.expected_log_prob_analytic(q_mean, q_var, y)
        if out is None:
            raise ValueError(f"{type(lik).__name__} has no analytic expected log-likelihood")
        return out


@dataclasses.dataclass(frozen=True)
class DefaultExpectationMethod:
    """Analytic where the likelihood has it, else Gauss–Hermite."""

    n_points: int = 20

    def expected_loglik(self, lik, q_mean, q_var, y):
        out = lik.expected_log_prob_analytic(q_mean, q_var, y)
        if out is not None:
            return out
        return GaussHermite(self.n_points).expected_loglik(lik, q_mean, q_var, y)


def expected_loglikelihood(quadrature, lik, q_mean, q_var, y) -> torch.Tensor:
    """Per-point E_{q(f_i)}[log p(y_i | f_i)], shape (N,)."""
    return quadrature.expected_loglik(lik, q_mean, q_var, y)
