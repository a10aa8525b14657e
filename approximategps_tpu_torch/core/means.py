"""Mean functions for GP priors (port of ``approximategps_tpu/core/means.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .kernels import as_points

__all__ = ["ZeroMean", "ConstMean", "FunctionMean"]


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroMean:
    def __call__(self, X) -> torch.Tensor:
        X = as_points(X)
        return torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True, eq=False)
class ConstMean:
    value: torch.Tensor | float = 0.0

    def __call__(self, X) -> torch.Tensor:
        X = as_points(X)
        v = torch.as_tensor(self.value, dtype=X.dtype, device=X.device)
        return v.expand(X.shape[0]).clone()


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionMean:
    """``fn`` maps one point (D,) to a scalar; applied over the rows."""

    fn: Callable

    def __call__(self, X) -> torch.Tensor:
        X = as_points(X)
        return torch.vmap(self.fn)(X).reshape(X.shape[0])
