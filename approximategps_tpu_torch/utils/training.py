"""SVGP parameters and training (port of the parts of
``approximategps_tpu/utils/training.py`` the serving and training paths
read: ``SVGPParams``, ``init_svgp_params``, ``build_svgp`` and
``adam_fit``).  The natural-gradient step is not ported yet."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.distributions import MultivariateNormal
from ..core.gp import GP
from ..core.kernels import SqExponentialKernel, with_lengthscale
from ..models.svgp import NonCentered, SparseVariationalApproximation
from .bijectors import cholesky_parameter, flat_from_tril, invsoftplus, softplus

__all__ = ["SVGPParams", "init_svgp_params", "build_svgp", "adam_fit"]


class SVGPParams(NamedTuple):
    """Unconstrained kernel hyperparameters, inducing inputs, variational
    mean and flattened Cholesky factor."""

    raw_variance: torch.Tensor
    raw_lengthscale: torch.Tensor
    z: torch.Tensor
    m: torch.Tensor
    L_flat: torch.Tensor


def init_svgp_params(z, variance=1.0, lengthscale=1.0) -> SVGPParams:
    z = torch.as_tensor(z)
    M = z.shape[0]
    like = dict(dtype=z.dtype, device=z.device)
    eye_flat = flat_from_tril(torch.eye(M, **like))
    # softplus-diagonal parameterization: invsoftplus(1) on the diagonal
    diag_idx = torch.cumsum(torch.arange(1, M + 1, device=z.device), 0) - 1
    eye_flat[diag_idx] = invsoftplus(torch.tensor(1.0, **like))
    return SVGPParams(
        raw_variance=invsoftplus(torch.as_tensor(variance, **like)),
        raw_lengthscale=invsoftplus(torch.as_tensor(lengthscale, **like)),
        z=z,
        m=torch.zeros(M, **like),
        L_flat=eye_flat,
    )


def build_svgp(params: SVGPParams, jitter: float = 1e-6, kernel_cls=SqExponentialKernel,
               parametrization=None):
    """Constrained SVGP model from the unconstrained parameter pack; returns
    ``(sva, f)``."""
    kernel = softplus(params.raw_variance) * with_lengthscale(
        kernel_cls(), softplus(params.raw_lengthscale)
    )
    f = GP(kernel)
    fz = f(params.z, jitter)
    M = params.m.shape[0]
    q = MultivariateNormal(params.m, cholesky_parameter(params.L_flat, M))
    parametrization = parametrization if parametrization is not None else NonCentered()
    return SparseVariationalApproximation(fz, q, parametrization), f


def _leaves(params) -> list[torch.Tensor]:
    return list(params.values()) if isinstance(params, dict) else list(params)


def adam_fit(loss_fn: Callable, params, data_iter, learning_rate: float = 1e-2,
             num_steps: int | None = None, optimizer: Callable | None = None):
    """Minimise ``loss_fn(params, *batch)`` over the batches of ``data_iter``
    (an iterable of tuples) with Adam.

    ``params`` is a dict or an :class:`SVGPParams` of leaf tensors, updated
    in place (the JAX package returns new arrays; here the leaves are the
    optimiser's own).  ``torch.optim.Adam``'s defaults (β = 0.9, 0.999;
    ε = 1e-8 outside the square root) are ``optax.adam``'s.  ``optimizer``,
    if given, maps the list of leaves to another ``torch.optim`` optimiser.
    Returns ``(params, losses)``, the losses as 0-dim tensors."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = optimizer(leaves) if optimizer is not None else torch.optim.Adam(leaves, lr=learning_rate)
    losses = []
    for i, batch in enumerate(data_iter):
        if num_steps is not None and i >= num_steps:
            break
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *batch)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return params, losses
