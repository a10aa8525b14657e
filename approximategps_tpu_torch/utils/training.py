"""SVGP parameters and training (port of
``approximategps_tpu/utils/training.py``): ``SVGPParams``,
``init_svgp_params``, ``build_svgp``, ``adam_fit`` and ``lbfgs_fit``; the
natural-gradient updates of the variational (m, S) and the hybrid step
``make_natgrad_adam_step`` (Adam on the hyperparameters, one natural
gradient step on q); and ``make_slq_hyperopt_step`` of the matrix-free exact
GP."""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

from ..core.distributions import MultivariateNormal
from ..core.gp import GP
from ..core.kernels import SqExponentialKernel, with_lengthscale
from ..core.linalg import _chol_bwd_from_inv, blocked_tril_inv, chol_with_inv, symmetrize
from ..models.svgp import NonCentered, SparseVariationalApproximation
from .bijectors import cholesky_parameter, flat_from_tril, invsoftplus, softplus
from .profiling import named_scope

__all__ = [
    "SVGPParams",
    "init_svgp_params",
    "build_svgp",
    "adam_fit",
    "lbfgs_fit",
    "natgrad_update",
    "natgrad_update_tril",
    "make_natgrad_adam_step",
    "make_slq_hyperopt_step",
]


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
    """The leaf tensors of a tensor, or of a dict or sequence of tensors."""
    if isinstance(params, torch.Tensor):
        return [params]
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
    Returns ``(params, losses)``, the losses as 0-dim tensors.

    Under a profiler session each step is an ``adam_fit.step`` span: the
    gradients' reset (no launch), then ``adam_fit.forward`` (``loss_fn``),
    ``adam_fit.backward`` and ``adam_fit.update`` (the optimiser's step and
    the loss kept); fetching the next batch lies outside them."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = optimizer(leaves) if optimizer is not None else torch.optim.Adam(leaves, lr=learning_rate)
    losses = []
    for i, batch in enumerate(data_iter):
        if num_steps is not None and i >= num_steps:
            break
        with named_scope("adam_fit.step"):
            opt.zero_grad(set_to_none=True)
            with named_scope("adam_fit.forward"):
                loss = loss_fn(params, *batch)
            with named_scope("adam_fit.backward"):
                loss.backward()
            with named_scope("adam_fit.update"):
                opt.step()
                losses.append(loss.detach())
    return params, losses


@contextlib.contextmanager
def _tf32(allow: bool | None):
    """``torch.backends.cuda.matmul.allow_tf32`` set to ``allow`` inside,
    the caller's value restored after; None leaves it as it is."""
    if allow is None:
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# gradient_precision of make_natgrad_adam_step -> allow_tf32 in its gradient pass
_GRADIENT_TF32 = {"default": True, "high": False, "highest": False, None: None}


def _natgrad_core(m, Sinv, grad_m, grad_S, lr):
    """The (m, S) natural-gradient step given the current precision S⁻¹ and
    ascent gradients of the ELBO w.r.t. (m, S).  Its O(M³) work is two
    ``chol_with_inv`` factorizations (the (L, L⁻¹) kernel on the card) and
    matmuls.

    With natural parameters θ₁ = S⁻¹m, θ₂ = −½S⁻¹ and expectation
    parameters η₁ = m, η₂ = S + mmᵀ, the natural gradient w.r.t. θ is the
    plain gradient w.r.t. η; with dL/dη₁ = dL/dm − 2 (dL/dS) m and
    dL/dη₂ = dL/dS:
        θ₂ ← θ₂ + lr·(dL/dS)        ⇒ S⁻¹ ← S⁻¹ − 2·lr·(dL/dS)
        θ₁ ← θ₁ + lr·(dL/dη₁)
    Returns (m_new, L_new, Linv_new) with L_new = chol(S_new).  Its
    matmuls run without TF32: the update adds the gradient into a
    precision matrix that must stay positive definite."""
    with _tf32(False):
        theta1 = Sinv @ m + lr * (grad_m - 2.0 * (grad_S @ m))
        Li, Li_inv = chol_with_inv(symmetrize(Sinv - 2.0 * lr * grad_S))
        # S_new = (Li Liᵀ)⁻¹ = Li⁻ᵀ Li⁻¹, one matmul from the factor's inverse
        S_new = symmetrize(Li_inv.T @ Li_inv)
        m_new = S_new @ theta1
        L_new, Linv_new = chol_with_inv(S_new)
    return m_new, L_new, Linv_new


def natgrad_update(m, S_L, grad_m, grad_S, lr: float = 0.1):
    """One natural-gradient step on the variational (m, S) of an SVGP in
    expectation-parameter space (see :func:`_natgrad_core`).  ``grad_m`` and
    ``grad_S`` are ascent gradients of the ELBO w.r.t. m and the dense
    symmetric S.  Returns the updated (m, S_L)."""
    with _tf32(False):
        Linv = blocked_tril_inv(S_L)
        Sinv = Linv.T @ Linv
    m_new, L_new, _ = _natgrad_core(m, Sinv, grad_m, grad_S, lr)
    return m_new, L_new


def natgrad_update_tril(m, L, grad_m, grad_L, lr: float = 0.1, Linv=None):
    """The step of :func:`natgrad_update` from the gradient w.r.t. q's
    Cholesky factor L (what autograd gives for an ELBO written in terms of
    ``MultivariateNormal(m, L)``).  The L̄ → S̄ conversion is the Cholesky
    pullback evaluated from L⁻¹ by matmuls (Murray 2016, eq. 8):
    S̄ = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹).  Pass ``Linv`` (the previous step's) to skip
    the triangular inversion.  Returns ``(m_new, L_new, Linv_new)``, the
    carried triple of :func:`make_natgrad_adam_step`."""
    with _tf32(False):
        if Linv is None:
            Linv = blocked_tril_inv(L)
        grad_S = _chol_bwd_from_inv(L, Linv, torch.tril(grad_L))
        Sinv = Linv.T @ Linv
    return _natgrad_core(m, Sinv, grad_m, grad_S, lr)


def make_natgrad_adam_step(
    elbo_fn: Callable,
    optimizer: Callable | None = None,
    nat_lr: float = 0.1,
    learning_rate: float = 1e-3,
    gradient_precision: str | None = "high",
):
    """The hybrid SVGP step: Adam on the hyperparameters and one
    natural-gradient step on the variational (m, S), from one gradient pass.

    ``elbo_fn(hyper, m, L, *batch)`` returns the ELBO (to maximise) of a
    model whose variational distribution is ``MultivariateNormal(m, L)``
    (Centered for the exact conjugate natural gradient, NonCentered for the
    whitened one; the update is the same).  ``hyper`` is a tensor, or a
    dict or sequence of tensors, updated in place by the optimiser:
    ``optimizer``, if given, maps the list of leaves to a ``torch.optim``
    optimiser; the default is Adam at ``learning_rate``, whose defaults are
    ``optax.adam``'s.

    Returns ``(step, init)``: ``init(hyper, m, L)`` builds the carry
    ``(hyper, optimizer, m, L, Linv)``; ``step(carry, *batch)`` returns
    ``(carry, elbo)``, the ELBO at the carry it was given.  The carried
    L⁻¹ feeds the L̄ → S̄ Cholesky pullback, so that the update's only
    O(M³) factorizations are the two ``chol_with_inv`` calls of
    :func:`_natgrad_core`.  The update runs under ``torch.no_grad()``.

    ``gradient_precision`` sets TF32 for the gradient pass's matmuls:
    "high" and "highest" (the default "high") turn it off, "default" turns
    it on, and None leaves the caller's setting; the caller's value is
    restored after.  The natural gradient adds the gradient into a
    precision matrix that must stay positive definite: on the TPU,
    single-pass bf16 products left ~1e-3 relative noise on S̄ and drove
    S⁻¹ − 2·lr·S̄ indefinite.  The update's own matmuls never use TF32."""
    if gradient_precision not in _GRADIENT_TF32:
        raise ValueError(f"unknown gradient_precision: {gradient_precision!r}")
    allow_tf32 = _GRADIENT_TF32[gradient_precision]

    def init(hyper, m, L):
        leaves = _leaves(hyper)
        for p in leaves:
            p.requires_grad_(True)
        opt = (optimizer(leaves) if optimizer is not None
               else torch.optim.Adam(leaves, lr=learning_rate))
        with torch.no_grad(), _tf32(False):
            Linv = blocked_tril_inv(L)
        return (hyper, opt, m.detach(), L.detach(), Linv)

    def step(carry, *batch):
        hyper, opt, m, L, Linv = carry
        leaves = _leaves(hyper)
        m_in = m.detach().requires_grad_(True)
        L_in = L.detach().requires_grad_(True)
        with _tf32(allow_tf32):
            e = elbo_fn(hyper, m_in, L_in, *batch)
            grads = torch.autograd.grad(e, leaves + [m_in, L_in], materialize_grads=True)
        g_h, g_m, g_L = grads[:-2], grads[-2], grads[-1]
        # torch.optim minimises: hand it the gradients of −elbo
        for p, g in zip(leaves, g_h):
            p.grad = -g
        opt.step()
        with torch.no_grad():
            m, L, Linv = natgrad_update_tril(m, L, g_m, g_L, lr=nat_lr, Linv=Linv)
        return (hyper, opt, m, L, Linv), e.detach()

    return step, init


def lbfgs_fit(loss_fn: Callable, params, max_iters: int = 200, tol: float = 1e-8,
              optimizer: Callable | None = None):
    """L-BFGS minimisation of ``loss_fn(params)``, on ``params``' device.

    ``params`` is a tensor, or a dict or sequence of tensors, updated in
    place.  The default optimiser is ``torch.optim.LBFGS`` with the strong
    Wolfe line search, one iteration a call (its history carries over);
    ``optimizer``, if given, maps the list of leaves to another.  Stops
    after ``max_iters`` iterations or the first whose starting gradient has
    ‖g‖₂ ≤ ``tol``, as the JAX package's loop does, or the first that
    leaves the parameters unchanged (the line search found no decrease the
    dtype can resolve; every later iteration would repeat it).  Its line
    search is not optax's, so the iterates differ from the JAX package's;
    the minimiser is the same.  Returns ``(params, final_loss, n_iters)``."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = (optimizer(leaves) if optimizer is not None else torch.optim.LBFGS(
        leaves, lr=1.0, max_iter=1, tolerance_grad=0.0, tolerance_change=0.0,
        line_search_fn="strong_wolfe"))
    start_gnorm = []

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        if not start_gnorm:  # the first evaluation of an iteration is at its start
            gsq = sum(torch.sum(p.grad * p.grad) for p in leaves if p.grad is not None)
            start_gnorm.append(float(torch.sqrt(torch.as_tensor(gsq))))
        return loss

    n = 0
    while n < max_iters:
        start_gnorm.clear()
        before = [p.detach().clone() for p in leaves]
        opt.step(closure)
        n += 1
        if start_gnorm[0] <= tol or all(torch.equal(a, p) for a, p in zip(before, leaves)):
            break
    with torch.no_grad():
        final_loss = loss_fn(params)
    return params, final_loss, n


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

    def init(params):
        leaves = _leaves(params)
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
