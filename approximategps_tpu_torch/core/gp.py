"""GP abstractions (port of ``approximategps_tpu/core/gp.py``: ``AbstractGP``,
``GP``, ``FiniteGP``, ``LatentGP`` and ``LatentFiniteGP``).

Noise convention for ``FiniteGP`` (AbstractGPs' ``f(x, Σy)``): a scalar σ²
is isotropic σ²·I, an (N,) vector is diagonal, an (N, N) matrix is full.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import linalg
from .distributions import MultivariateNormal
from .kernels import Kernel, as_points
from .likelihoods import Likelihood, as_likelihood
from .means import ZeroMean

__all__ = ["AbstractGP", "GP", "FiniteGP", "LatentGP", "LatentFiniteGP"]


class AbstractGP:
    """AbstractGPs-style API: mean/cov/var/mean_and_var."""

    def mean(self, x) -> torch.Tensor:
        raise NotImplementedError

    def cov(self, x, z=None) -> torch.Tensor:
        raise NotImplementedError

    def var(self, x) -> torch.Tensor:
        return torch.diagonal(self.cov(x))

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

    def scale_tril(self) -> torch.Tensor:
        return linalg.safe_cholesky(self.cov())

    def to_mvn(self) -> MultivariateNormal:
        return MultivariateNormal(self.mean(), self.scale_tril())


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
