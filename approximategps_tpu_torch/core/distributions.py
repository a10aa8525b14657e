"""Gaussian distributions (port of ``approximategps_tpu/core/distributions.py``:
``MultivariateNormal``, ``DiagNormal``, ``mvnormal_from_cov`` and the
closed-form ``kl_divergence``).  Samples draw their standard normals from a
``torch.Generator``."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import linalg

__all__ = ["MultivariateNormal", "DiagNormal", "mvnormal_from_cov", "kl_divergence"]

_LOG2PI = math.log(2.0 * math.pi)


def standard_normals(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` from ``generator`` (on its own device), in
    ``like``'s dtype and on ``like``'s device."""
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


@dataclasses.dataclass(frozen=True, eq=False)
class MultivariateNormal:
    """N(mean, scale_tril @ scale_tril^T)."""

    mean: torch.Tensor
    scale_tril: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def cov(self) -> torch.Tensor:
        L = self.scale_tril
        return L @ L.transpose(-1, -2)

    def var(self) -> torch.Tensor:
        return torch.sum(self.scale_tril**2, dim=-1)

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.var())

    def marginals(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean, self.var()

    def sample(self, generator: torch.Generator, sample_shape: tuple[int, ...] = ()):
        """mean + ε Lᵀ, ε ~ N(0, I) from ``generator``."""
        eps = standard_normals(generator, tuple(sample_shape) + tuple(self.mean.shape), self.mean)
        return self.mean + eps @ self.scale_tril.transpose(-1, -2)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        delta = (x - self.mean)[..., None]
        alpha = torch.linalg.solve_triangular(self.scale_tril, delta, upper=False)[..., 0]
        quad = torch.sum(alpha * alpha, dim=-1)
        return -0.5 * (self.dim * _LOG2PI + quad) - linalg.tril_logdet(
            self.scale_tril)


@dataclasses.dataclass(frozen=True, eq=False)
class DiagNormal:
    """Independent N(mean_i, var_i): the product distribution of
    ``marginals``."""

    mean: torch.Tensor
    var: torch.Tensor

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.var)

    def marginals(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean, self.var

    def sample(self, generator: torch.Generator, sample_shape: tuple[int, ...] = ()):
        eps = standard_normals(generator, tuple(sample_shape) + tuple(self.mean.shape), self.mean)
        return self.mean + eps * torch.sqrt(self.var)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(
            -0.5 * (_LOG2PI + torch.log(self.var) + (x - self.mean) ** 2 / self.var), dim=-1)


def mvnormal_from_cov(mean: torch.Tensor, cov: torch.Tensor,
                      jitter: float | None = None) -> MultivariateNormal:
    """N(mean, cov) through the Cholesky factor of the symmetrized cov (plus
    ``jitter``·I where given)."""
    return MultivariateNormal(mean, linalg.safe_cholesky(
        cov if jitter is None else linalg.add_jitter(cov, jitter)))


def kl_divergence(q: MultivariateNormal, p: MultivariateNormal) -> torch.Tensor:
    """KL(q ‖ p) for multivariate Gaussians, closed form."""
    Lq, Lp = q.scale_tril, p.scale_tril
    # tr(Σp⁻¹ Σq) = ‖Lp⁻¹ Lq‖_F²
    Mt = torch.linalg.solve_triangular(Lp, Lq, upper=False)
    trace_term = torch.sum(Mt * Mt, dim=(-1, -2))
    alpha = torch.linalg.solve_triangular(Lp, (p.mean - q.mean)[..., None], upper=False)[..., 0]
    quad = torch.sum(alpha * alpha, dim=-1)
    logdet_term = linalg.chol_logdet(Lp) - linalg.chol_logdet(Lq)
    return 0.5 * (trace_term + quad - q.dim + logdet_term)
