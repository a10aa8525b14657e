"""Gaussian distributions (port of ``approximategps_tpu/core/distributions.py``:
``MultivariateNormal`` only)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MultivariateNormal"]


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
