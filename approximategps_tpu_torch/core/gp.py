"""GP abstractions (port of ``approximategps_tpu/core/gp.py``: ``AbstractGP``,
``GP``, ``FiniteGP``, ``LatentGP``, ``LatentFiniteGP`` and the exact posterior:
``CholeskyRep``, ``PosteriorGP``, ``posterior``, ``logpdf`` and
``predict_in_blocks``, the dense oracle of the matrix-free tier).

Noise convention for ``FiniteGP`` (AbstractGPs' ``f(x, Σy)``): a scalar σ²
is isotropic σ²·I, an (N,) vector is diagonal, an (N, N) matrix is full.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import linalg
from .distributions import DiagNormal, MultivariateNormal
from .kernels import Kernel, as_points
from .likelihoods import Likelihood, as_likelihood
from .means import ZeroMean

__all__ = [
    "AbstractGP",
    "GP",
    "FiniteGP",
    "LatentGP",
    "LatentFiniteGP",
    "CholeskyRep",
    "PosteriorGP",
    "posterior",
    "logpdf",
    "predict_in_blocks",
]


class AbstractGP:
    """AbstractGPs-style API: mean/cov/var/mean_and_var."""

    def mean(self, x) -> torch.Tensor:
        raise NotImplementedError

    def cov(self, x, z=None) -> torch.Tensor:
        raise NotImplementedError

    def var(self, x) -> torch.Tensor:
        return torch.diagonal(self.cov(x))

    def mean_and_cov(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=0.0) -> "FiniteGP":
        return FiniteGP(self, torch.as_tensor(x), noise)


@dataclasses.dataclass(frozen=True, eq=False)
class GP(AbstractGP):
    """GP prior f ~ GP(mean_fn, kernel); ``GP(kernel)`` has zero mean."""

    kernel: Kernel
    mean_fn: Any = None

    def __post_init__(self):
        if self.mean_fn is None:
            object.__setattr__(self, "mean_fn", ZeroMean())

    def mean(self, x):
        return self.mean_fn(as_points(x))

    def cov(self, x, z=None):
        return self.kernel.gram(x, z)

    def var(self, x):
        return self.kernel.diag(x)


def _noise_tensor(noise, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(noise, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True, eq=False)
class FiniteGP:
    """The multivariate-normal restriction of ``f`` to ``x`` with observation
    covariance given by ``noise``."""

    f: AbstractGP
    x: torch.Tensor
    noise: Any = 0.0

    def __len__(self) -> int:
        return as_points(self.x).shape[0]

    @property
    def is_isotropic_noise(self) -> bool:
        return torch.as_tensor(self.noise).ndim == 0

    def mean(self) -> torch.Tensor:
        return self.f.mean(self.x)

    def cov(self) -> torch.Tensor:
        K = self.f.cov(self.x)
        noise = _noise_tensor(self.noise, K)
        if noise.ndim == 0:
            return K + noise * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        if noise.ndim == 1:
            return K + torch.diag(noise)
        return K + noise

    def var(self) -> torch.Tensor:
        v = self.f.var(self.x)
        noise = _noise_tensor(self.noise, v)
        return v + (torch.diagonal(noise) if noise.ndim == 2 else noise)

    def mean_and_cov(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean(), self.cov()

    def mean_and_var(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mean(), self.var()

    def scale_tril(self) -> torch.Tensor:
        return linalg.safe_cholesky(self.cov())

    def to_mvn(self) -> MultivariateNormal:
        return MultivariateNormal(self.mean(), self.scale_tril())

    def marginals(self) -> DiagNormal:
        """Per-point N(μ_i, σ_i²), AbstractGPs' ``marginals``."""
        return DiagNormal(*self.mean_and_var())

    def sample(self, generator: torch.Generator, sample_shape: tuple[int, ...] = ()):
        """A draw of N(mean, cov) with its normals from ``generator``."""
        return self.to_mvn().sample(generator, sample_shape)

    rand = sample  # AbstractGPs' name

    def logpdf(self, y: torch.Tensor) -> torch.Tensor:
        return self.to_mvn().log_prob(y)


@dataclasses.dataclass(frozen=True, eq=False)
class LatentGP:
    """Prior plus likelihood: ``LatentGP(f, lik, jitter)(x)`` is the
    ``LatentFiniteGP`` of ``f(x, jitter)``."""

    f: AbstractGP
    lik: Any
    jitter: Any = 1e-8

    def __call__(self, x) -> "LatentFiniteGP":
        return LatentFiniteGP(self.f(x, self.jitter), as_likelihood(self.lik))


@dataclasses.dataclass(frozen=True, eq=False)
class LatentFiniteGP:
    """A latent FiniteGP and its observation likelihood."""

    fx: FiniteGP
    lik: Likelihood

    def __len__(self) -> int:
        return len(self.fx)


# ---------------------------------------------------------------------------
# Exact posterior
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CholeskyRep:
    """The precision of C = K(x, x) + Σy through its Cholesky factor L."""

    L: torch.Tensor

    def whiten(self, X: torch.Tensor) -> torch.Tensor:
        """V = L⁻¹X, so that VᵀV = XᵀC⁻¹X."""
        return linalg.solve_lower_triangular(self.L, X)

    def logdet(self) -> torch.Tensor:
        return linalg.chol_logdet(self.L)


@dataclasses.dataclass(frozen=True, eq=False)
class PosteriorGP(AbstractGP):
    """Exact posterior GP with its data cache (α, rep, x, δ)."""

    prior: AbstractGP
    x: torch.Tensor
    alpha: torch.Tensor
    rep: Any
    delta: torch.Tensor | None = None

    def mean(self, xs):
        return self.prior.mean(xs) + self.prior.cov(self.x, xs).T @ self.alpha

    def cov(self, xs, zs=None):
        Vx = self.rep.whiten(self.prior.cov(self.x, xs))
        if zs is None:
            return self.prior.cov(xs) - Vx.T @ Vx
        Vz = self.rep.whiten(self.prior.cov(self.x, zs))
        return self.prior.cov(xs, zs) - Vx.T @ Vz

    def var(self, xs):
        Vx = self.rep.whiten(self.prior.cov(self.x, xs))
        # a variance is never negative; cancellation can make it so
        return torch.clamp(self.prior.var(xs) - torch.sum(Vx * Vx, dim=0), min=0.0)

    def mean_and_cov(self, xs):
        Kxs = self.prior.cov(self.x, xs)
        Vx = self.rep.whiten(Kxs)
        return self.prior.mean(xs) + Kxs.T @ self.alpha, self.prior.cov(xs) - Vx.T @ Vx

    def mean_and_var(self, xs):
        Kxs = self.prior.cov(self.x, xs)
        Vx = self.rep.whiten(Kxs)
        mu = self.prior.mean(xs) + Kxs.T @ self.alpha
        return mu, torch.clamp(self.prior.var(xs) - torch.sum(Vx * Vx, dim=0), min=0.0)


def posterior(fx: FiniteGP, y: torch.Tensor) -> PosteriorGP:
    """Exact GP regression posterior (AbstractGPs' ``posterior(fx, y)``)."""
    L = fx.scale_tril()
    delta = y - fx.mean()
    alpha = torch.cholesky_solve(delta[:, None], L, upper=False)[:, 0]
    return PosteriorGP(prior=fx.f, x=as_points(fx.x), alpha=alpha, rep=CholeskyRep(L),
                       delta=delta)


def logpdf(fx: FiniteGP, y: torch.Tensor) -> torch.Tensor:
    """Exact log marginal likelihood (AbstractGPs' ``logpdf(fx, y)``)."""
    return fx.logpdf(y)


def predict_in_blocks(post: AbstractGP, xs, block_size: int = 8192):
    """(mean, var) of ``post`` over a large test set, ``block_size`` points
    at a time, so that the cross-covariance stays O(train size · block)."""
    X = as_points(xs)
    parts = [post.mean_and_var(X[i:i + block_size]) for i in range(0, X.shape[0], block_size)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
