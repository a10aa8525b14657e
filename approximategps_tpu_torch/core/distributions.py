"""Gaussian distributions (port of ``approximategps_tpu/core/distributions.py``:
``MultivariateNormal``, ``mvnormal_from_cov`` and the closed-form
``kl_divergence``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import linalg

__all__ = ["MultivariateNormal", "mvnormal_from_cov", "kl_divergence"]


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

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        delta = (x - self.mean)[..., None]
        alpha = torch.linalg.solve_triangular(self.scale_tril, delta, upper=False)[..., 0]
        quad = torch.sum(alpha * alpha, dim=-1)
        return -0.5 * (self.dim * math.log(2.0 * math.pi) + quad) - linalg.tril_logdet(
            self.scale_tril)


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
