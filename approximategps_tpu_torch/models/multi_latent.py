"""Multi-latent SVGP: likelihoods driven by several independent latent GPs
(port of ``approximategps_tpu/models/multi_latent.py``).

- heteroscedastic regression, ``y ~ N(f¹, exp(f²))``: a mean GP and a
  log-variance GP (:class:`HeteroscedasticGaussianLikelihood`);
- multi-class classification, ``y ~ Categorical(softmax(f¹..f^C))``
  (:class:`SoftmaxLikelihood`).

One :class:`~approximategps_tpu_torch.models.svgp.SparseVariationalApproximation`
a latent (independent priors and variational posteriors); the data term
integrates the joint likelihood over the product of the per-latent marginals
with a tensor-product Gauss–Hermite grid (n^L nodes) or by Monte Carlo with
normals from a ``torch.Generator``; the KL is the sum of the latents'.  Each
latent's posterior is its own build (``posterior(sva)``: row 1 on the card
for a NonCentered latent at M ≥ 512), so a step of an L-latent model runs
L builds.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from ..core.distributions import standard_normals
from ..core.gp import FiniteGP
from .api import approx_lml, posterior
from .svgp import prior_kl

__all__ = [
    "MultiLatentLikelihood",
    "HeteroscedasticGaussianLikelihood",
    "SoftmaxLikelihood",
    "MultiLatentSVGP",
    "expected_loglik_multi",
    "multi_latent_elbo",
]

_LOG2PI = math.log(2.0 * math.pi)


class MultiLatentLikelihood:
    """Base: log p(y | f) with f a vector of L latent values a point."""

    n_latent: int

    def log_prob(self, F: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """F: (..., L); y: (...) → log-density (...)."""
        raise NotImplementedError

    def conditional_sample(self, generator: torch.Generator, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class HeteroscedasticGaussianLikelihood(MultiLatentLikelihood):
    """y ~ N(f¹, exp(f²)): a latent mean and a latent log-variance (2
    latents)."""

    n_latent = 2

    def log_prob(self, F, y):
        mu = F[..., 0]
        log_var = F[..., 1]
        return -0.5 * (_LOG2PI + log_var + (y - mu) ** 2 * torch.exp(-log_var))

    def conditional_sample(self, generator, F):
        mu = F[..., 0]
        return mu + torch.exp(0.5 * F[..., 1]) * standard_normals(generator, mu.shape, mu)


@dataclasses.dataclass(frozen=True, eq=False)
class SoftmaxLikelihood(MultiLatentLikelihood):
    """y ∈ {0..C−1} ~ Categorical(softmax(f¹..f^C)): C latents."""

    n_classes: int

    @property
    def n_latent(self):
        return self.n_classes

    def log_prob(self, F, y):
        fy = torch.take_along_dim(F, y[..., None].long(), dim=-1)[..., 0]
        return fy - torch.logsumexp(F, dim=-1)

    def conditional_sample(self, generator, F):
        # Gumbel-max: argmax(F + G), G = −log(−log U)
        u = torch.rand(F.shape, generator=generator, dtype=F.dtype, device=generator.device)
        tiny = torch.finfo(F.dtype).tiny
        return torch.argmax(F - torch.log(-torch.log(u.to(F.device).clamp(min=tiny))), dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class MultiLatentSVGP:
    """A tuple of per-latent SVGPs and a multi-latent likelihood."""

    svas: tuple
    lik: MultiLatentLikelihood


@lru_cache(maxsize=16)
def _gh_grid(n: int, L: int):
    """Tensor-product Gauss–Hermite grid: nodes (n^L, L), weights (n^L,),
    normalized for E over L independent standard normals (numpy)."""
    xs, ws = np.polynomial.hermite.hermgauss(n)
    xs = xs * math.sqrt(2.0)
    ws = ws / math.sqrt(math.pi)
    grids = np.meshgrid(*([xs] * L), indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=-1)  # (n^L, L)
    weights = np.ones(n**L)
    for g in np.meshgrid(*([ws] * L), indexing="ij"):
        weights = weights * g.ravel()
    return nodes, weights


def _mc_expectation(lik: MultiLatentLikelihood, q_means, sigma, y, eps):
    """Mean over the draws of log p(y | μ + σ∘ε), ε (S, N, L)."""
    return torch.mean(lik.log_prob(q_means[None] + sigma[None] * eps, y[None]), dim=0)


def expected_loglik_multi(
    lik: MultiLatentLikelihood,
    q_means: torch.Tensor,
    q_vars: torch.Tensor,
    y: torch.Tensor,
    n_points: int = 20,
    mc_generator: torch.Generator | None = None,
    n_samples: int = 128,
) -> torch.Tensor:
    """Per-point E_{∏_l N(μ_l, σ_l²)}[log p(y | f₁..f_L)], shape (N,).

    Tensor-product Gauss–Hermite (``n_points``^L nodes); with
    ``mc_generator``, Monte Carlo over ``n_samples`` draws from it
    instead (for large L)."""
    L = q_means.shape[-1]
    sigma = torch.sqrt(torch.clamp(q_vars, min=0.0))
    if mc_generator is not None:
        eps = standard_normals(mc_generator, (n_samples,) + tuple(q_means.shape), q_means)
        return _mc_expectation(lik, q_means, sigma, y, eps)
    nodes, weights = _gh_grid(n_points, L)
    nodes = torch.as_tensor(nodes, dtype=q_means.dtype, device=q_means.device)  # (Q, L)
    weights = torch.as_tensor(weights, dtype=q_means.dtype, device=q_means.device)
    F = q_means[None, :, :] + sigma[None, :, :] * nodes[:, None, :]  # (Q, N, L)
    return weights @ lik.log_prob(F, y[None])


def multi_latent_elbo(
    ml: MultiLatentSVGP,
    x: torch.Tensor,
    y: torch.Tensor,
    num_data: int | None = None,
    n_gh: int = 20,
    mc_generator: torch.Generator | None = None,
) -> torch.Tensor:
    """ELBO = Σᵢ E_{∏ q(fᵢ^l)}[log p(yᵢ | fᵢ)]·scale − Σ_l KL_l, scale =
    ``num_data`` / batch size for a minibatch."""
    means, variances = [], []
    for sva in ml.svas:
        mu_l, var_l = posterior(sva).mean_and_var(x)
        means.append(mu_l)
        variances.append(var_l)
    ell = expected_loglik_multi(ml.lik, torch.stack(means, dim=-1), torch.stack(variances, dim=-1),
                                y, n_points=n_gh, mc_generator=mc_generator)
    scale = 1.0 if num_data is None else num_data / y.shape[0]
    kl = sum(prior_kl(sva) for sva in ml.svas)
    return torch.sum(ell) * scale - kl


@posterior.register(MultiLatentSVGP)
def _posterior_multi(ml: MultiLatentSVGP, *_, **__):
    """The latents' (independent) posteriors, as a tuple."""
    return tuple(posterior(sva) for sva in ml.svas)


@approx_lml.register(MultiLatentSVGP)
def _approx_lml_multi(ml: MultiLatentSVGP, lfx, ys, **kwargs):
    x = lfx.x if isinstance(lfx, FiniteGP) else lfx.fx.x
    return multi_latent_elbo(ml, x, ys, **kwargs)
