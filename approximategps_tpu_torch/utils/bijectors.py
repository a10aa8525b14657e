"""Constrained-parameter transforms (port of
``approximategps_tpu/utils/bijectors.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "softplus",
    "invsoftplus",
    "positive",
    "fill_triangular",
    "fill_triangular_inverse",
    "tril_from_flat",
    "flat_from_tril",
    "cholesky_parameter",
]


def softplus(x) -> torch.Tensor:
    """log(1 + exp(x)) without the linear cut-off of
    ``torch.nn.functional.softplus``, as ``jax.nn.softplus`` computes it."""
    x = torch.as_tensor(x)
    return torch.logaddexp(x, torch.zeros_like(x))


def invsoftplus(y) -> torch.Tensor:
    """Inverse of softplus: log(exp(y) - 1), numerically stable."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


positive = softplus


def fill_triangular(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Pack a length n(n+1)/2 vector into a lower-triangular (n, n) matrix,
    row-major over the lower triangle."""
    rows, cols = torch.tril_indices(n, n, device=flat.device)
    L = torch.zeros((n, n), dtype=flat.dtype, device=flat.device)
    L[rows, cols] = flat
    return L


def fill_triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """The lower triangle of L as a length n(n+1)/2 vector, row-major: the
    inverse of :func:`fill_triangular`."""
    n = L.shape[-1]
    rows, cols = torch.tril_indices(n, n, device=L.device)
    return L[rows, cols]


tril_from_flat = fill_triangular
flat_from_tril = fill_triangular_inverse


def cholesky_parameter(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Unconstrained vector → lower-triangular factor with a
    softplus-positive diagonal."""
    L = fill_triangular(flat, n)
    return torch.tril(L, -1) + torch.diag(softplus(torch.diagonal(L)))
