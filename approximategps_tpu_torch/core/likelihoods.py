"""Observation likelihoods (port of ``approximategps_tpu/core/likelihoods.py``:
the ``Likelihood`` base and ``GaussianLikelihood``)."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Likelihood", "GaussianLikelihood", "as_likelihood"]

_LOG2PI = math.log(2.0 * math.pi)


class Likelihood:
    """``log_prob(f, y)``: pointwise log p(y|f), broadcastable;
    ``expected_log_prob_analytic``: the closed-form E_{N(q_mean, q_var)}
    [log p(y|f)], or None where there is none."""

    def log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        return None


def _variance(v, like: torch.Tensor) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=like.dtype)
    return v if v.ndim == 0 else v.to(like.device)


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianLikelihood(Likelihood):
    """y | f ~ N(f, σ²)."""

    obs_variance: torch.Tensor | float = 1.0

    def log_prob(self, f, y):
        s2 = _variance(self.obs_variance, f)
        return -0.5 * (_LOG2PI + torch.log(s2) + (y - f) ** 2 / s2)

    def expected_log_prob_analytic(self, q_mean, q_var, y):
        s2 = _variance(self.obs_variance, q_mean)
        return -0.5 * (_LOG2PI + torch.log(s2) + ((y - q_mean) ** 2 + q_var) / s2)


def as_likelihood(obj) -> Likelihood:
    if isinstance(obj, Likelihood):
        return obj
    raise TypeError(f"cannot interpret {obj!r} as a likelihood")
