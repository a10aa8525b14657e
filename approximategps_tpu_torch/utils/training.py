"""SVGP parameters and training (port of the parts of
``approximategps_tpu/utils/training.py`` the serving and training paths
read: ``SVGPParams``, ``init_svgp_params``, ``build_svgp`` and
``adam_fit``; and ``make_slq_hyperopt_step`` of the matrix-free exact GP).
The natural-gradient step is not ported yet."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.distributions import MultivariateNormal
from ..core.gp import GP
from ..core.kernels import SqExponentialKernel, with_lengthscale
from ..models.svgp import NonCentered, SparseVariationalApproximation
from .bijectors import cholesky_parameter, flat_from_tril, invsoftplus, softplus

__all__ = ["SVGPParams", "init_svgp_params", "build_svgp", "adam_fit", "make_slq_hyperopt_step"]


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


def make_slq_hyperopt_step(
    build_fx: Callable,
    y: torch.Tensor,
    generator,
    optimizer: Callable | None = None,
    learning_rate: float = 1e-2,
    precond_rank: int = 0,
    refresh_every: int = 25,
    probes: torch.Tensor | None = None,
    **slq_kwargs,
):
    """Exact-GP hyperparameter optimisation at matrix-free scale: Adam on
    −``logpdf_slq``, with the pivoted-Cholesky CG preconditioner carried
    across steps and refreshed every ``refresh_every`` steps.

    ``build_fx(params) -> FiniteGP`` over the fixed training inputs; the
    probes are drawn once from ``generator`` (a ``torch.Generator`` or an
    int seed), or given, and every step uses them, as the JAX package uses
    one key.  Returns ``(step, init)``: ``init(params)`` builds the carry
    ``(params, optimizer, Lk, t)`` with the factor of the initial
    hyperparameters; ``step(carry) -> (carry, loss)`` updates ``params`` (a
    tensor, or a dict or sequence of tensors) in place.  At t = 0 the
    refresh is skipped (init built the factor from the same
    hyperparameters).  ``optimizer``, if given, maps the list of leaves to
    a ``torch.optim`` optimiser; the default is Adam at ``learning_rate``,
    whose defaults are ``optax.adam``'s."""
    from ..core.kernels import as_points
    from ..models.iterative import logpdf_slq, pivoted_cholesky, rademacher_probes

    if probes is None:
        probes = rademacher_probes(generator, slq_kwargs.pop("num_probes", 16), y.shape[0],
                                   torch.promote_types(y.dtype, torch.float32), y.device)
    slq_kwargs.pop("num_probes", None)

    def _factor(params):
        fx = build_fx(params)
        return pivoted_cholesky(fx.f.kernel, as_points(fx.x), precond_rank)

    def _params_leaves(params):
        return [params] if isinstance(params, torch.Tensor) else _leaves(params)

    def init(params):
        leaves = _params_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = (optimizer(leaves) if optimizer is not None
               else torch.optim.Adam(leaves, lr=learning_rate))
        Lk = _factor(params) if precond_rank > 0 else None
        return (params, opt, Lk, 0)

    def step(carry):
        params, opt, Lk, t = carry
        if precond_rank > 0 and t > 0 and t % refresh_every == 0:
            Lk = _factor(params)
        opt.zero_grad(set_to_none=True)
        loss = -logpdf_slq(build_fx(params), y, probes=probes, precond_Lk=Lk, **slq_kwargs)
        loss.backward()
        opt.step()
        return (params, opt, Lk, t + 1), loss.detach()

    return step, init
