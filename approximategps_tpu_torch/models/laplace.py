"""The Laplace approximation for likelihoods that are not Gaussian (port of
``approximategps_tpu/models/laplace.py``; Rasmussen & Williams Algorithms
3.1 and 5.1).

- Newton's method finds the mode f̂ of p(f | y) in a Python loop, one host
  sync an iteration (the convergence test ``isapprox(f, fnew)``);
- the gradients of f̂ in K, the likelihood's parameters and the targets come
  from the implicit-function theorem, through the autograd Function
  :class:`_NewtonSolve`: the loop is never unrolled;
- the log marginal likelihood and the posterior are evaluated on a cache
  recomputed, differentiably, at the fixed point, never on the loop's
  internals.

Differences from the JAX package: with no jit, its two callback modes are
one loop, which returns the while-loop's result (the last iterate) and
carries the IFT rule in both (the JAX eager mode returns the iterate before
the converged step); the Cholesky factor of B is NaN where the
factorization fails, as in JAX, through ``cholesky_ex`` (no host check);
``newton_multistart`` runs its starts one after another; and
:class:`LaplaceObjective` has no ``use_jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..core import linalg
from ..core.distributions import MultivariateNormal, mvnormal_from_cov
from ..core.gp import AbstractGP, FiniteGP, LatentFiniteGP
from ..core.likelihoods import Likelihood, as_likelihood
from ..core.means import ZeroMean
from .api import approx_lml, posterior
from .iterative import _tree

__all__ = [
    "LaplaceApproximation",
    "LaplaceCache",
    "LaplacePosterior",
    "newton_inner_loop",
    "newton_inner_loop_jvp",
    "newton_multistart",
    "laplace_lml",
    "laplace_f_and_lml",
    "laplace_f_cov",
    "laplace_steps",
    "laplace_steps_scan",
    "build_laplace_objective",
    "LaplaceObjective",
    "LaplaceResult",
]


@dataclasses.dataclass(frozen=True, eq=False)
class LaplaceApproximation:
    """``LaplaceApproximation(; newton_kwargs...)``: the Newton options of
    ``posterior`` and ``approx_lml``."""

    f_init: torch.Tensor | None = None
    maxiter: int = 100
    tol: float | None = None
    callback: Callable | None = None
    damping: float = 1.0


@dataclasses.dataclass(frozen=True, eq=False)
class LaplaceCache:
    """The training intermediates at an iterate f."""

    K: torch.Tensor  # the kernel matrix
    f: torch.Tensor
    W: torch.Tensor  # −∂²/∂f² log p(y | f), per point
    Wsqrt: torch.Tensor
    loglik: torch.Tensor  # Σᵢ log p(yᵢ | fᵢ)
    d_loglik: torch.Tensor
    B_L: torch.Tensor  # chol(I + √W K √W), lower
    a: torch.Tensor  # K⁻¹ f at the mode


def _laplace_train_intermediates(lik: Likelihood, ys, K, f) -> LaplaceCache:
    """One Newton linear-algebra block (RW Alg. 3.1, lines 4-7)."""
    ll, d_ll, d2_ll = lik.log_prob_d1_d2(f, ys)
    W = -d2_ll
    Wsqrt = torch.sqrt(W)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    B = eye + (Wsqrt[:, None] * K) * Wsqrt[None, :]
    B_L = linalg.cholesky_or_nan(linalg.symmetrize(B))
    b = W * f + d_ll
    a = b - Wsqrt * linalg.cholesky_solve(B_L, Wsqrt * (K @ b))
    return LaplaceCache(K=K, f=f, W=W, Wsqrt=Wsqrt, loglik=ll, d_loglik=d_ll, B_L=B_L, a=a)


def _newton_step(lik, ys, K, f, damping: float = 1.0):
    """RW Alg. 3.1, line 8.  ``damping`` < 1 takes the partial step
    f + η(f_newton − f): the same fixed point, a steadier iteration for
    likelihoods that are not log-concave."""
    cache = _laplace_train_intermediates(lik, ys, K, f)
    fnew = K @ cache.a
    if damping != 1.0:
        fnew = f + damping * (fnew - f)
    return fnew, cache


def _laplace_lml_from_cache(f, cache: LaplaceCache):
    """RW Alg. 3.1, line 10."""
    return -0.5 * (cache.a @ f) + cache.loglik - torch.sum(torch.log(torch.diagonal(cache.B_L)))


def _default_tol(dtype) -> float:
    # Julia's isapprox default: rtol = sqrt(eps(T))
    return float(math.sqrt(torch.finfo(dtype).eps))


def _isapprox(f, fnew, rtol):
    nf = torch.linalg.vector_norm(f - fnew)
    return nf <= rtol * torch.maximum(torch.linalg.vector_norm(f), torch.linalg.vector_norm(fnew))


def _newton_inner_loop(lik, ys, K, f_init, maxiter: int, tol: float,
                       callback: Callable | None = None, damping: float = 1.0):
    """Newton to convergence: (f_opt, n_iter), the JAX while-loop's result
    (the last iterate).  ``callback(fnew, cache)`` sees every iterate.  Not
    differentiable: gradients go through :class:`_NewtonSolve`."""
    f = f_init.to(dtype=K.dtype, device=K.device)
    n = 0
    with torch.no_grad():
        while n < maxiter:
            fnew, cache = _newton_step(lik, ys, K, f, damping)
            n += 1
            if callback is not None:
                callback(fnew, cache)
            done = bool(_isapprox(f, fnew, tol))  # the loop's one host sync
            f = fnew
            if done:
                break
    return f, n


@dataclasses.dataclass(frozen=True)
class _NewtonOptions:
    maxiter: int
    tol: float
    damping: float
    callback: Callable | None


@dataclasses.dataclass(frozen=True, eq=False)
class _Observed:
    lik: Likelihood
    ys: Any


class _NewtonSolve(torch.autograd.Function):
    """f̂ = Newton(K, θ_lik, y) with the IFT pullback.  At the fixed point
    f̂ = K ∇ll(f̂), so for the cotangent Δf, with λ = (I + W K)⁻¹ Δf =
    √W B⁻¹ √W⁻¹ Δf,

        K̄ = λ ∇llᵀ,   (θ̄_lik, ȳ) = the pullback of (θ, y) ↦ K ∇ll(f̂; θ, y)
        at λ,

    the second by autograd.  The forward keeps K, f̂, √W, B_L and ∇ll from
    the cache at f̂.  ``info`` receives the iteration count."""

    @staticmethod
    def forward(ctx, opts, build, info, K, f_init, *leaves):
        lik_obs = build(leaves)
        lik, ys = lik_obs.lik, lik_obs.ys
        f_opt, n_iter = _newton_inner_loop(lik, ys, K, f_init, opts.maxiter, opts.tol,
                                           opts.callback, opts.damping)
        info["n_iter"] = n_iter
        cache = _laplace_train_intermediates(lik, ys, K, f_opt)
        ctx.build = build
        ctx.save_for_backward(K, f_opt, cache.Wsqrt, cache.B_L, cache.d_loglik, *leaves)
        return f_opt

    @staticmethod
    def backward(ctx, ct_f):
        K, f_opt, Wsqrt, B_L, d_ll, *leaves = ctx.saved_tensors
        lam = Wsqrt * linalg.cholesky_solve(B_L, ct_f / Wsqrt)
        dK = torch.outer(lam, d_ll) if ctx.needs_input_grad[3] else None
        needs = ctx.needs_input_grad[5:]
        out = [None] * len(leaves)
        if any(needs):
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(leaves, needs)]
                lik_obs = ctx.build(ins)
                _, d1, _ = lik_obs.lik.log_prob_d1_d2(f_opt, lik_obs.ys)
                wanted = [t for t in ins if t.requires_grad]
                grads = iter(torch.autograd.grad(K @ d1, wanted, lam, allow_unused=True))
            out = [next(grads) if t.requires_grad else None for t in ins]
        return (None, None, None, dK, None, *out)


def newton_inner_loop(
    lik,
    ys,
    K,
    f_init=None,
    maxiter: int = 100,
    tol: float | None = None,
    callback: Callable | None = None,
    callback_mode: str = "eager",
    return_niter: bool = False,
    damping: float = 1.0,
):
    """A mode of p(f | y) by Newton's method, differentiable in K, the
    likelihood's parameters and float observations through the
    implicit-function theorem (the loop is never unrolled).

    ``callback(fnew, cache)`` sees every Newton iterate.  ``callback_mode``
    ("eager" or "io") is kept for the JAX package's signature: without jit
    both are the one loop, which returns the last iterate, as the JAX "io"
    mode and the loop without a callback do.  ``damping`` < 1 takes partial
    steps (see :class:`~approximategps_tpu_torch.core.likelihoods.
    GaussNewtonLikelihood`)."""
    if callback is not None and callback_mode not in ("eager", "io"):
        raise ValueError(f"unknown callback_mode: {callback_mode!r}")
    lik = as_likelihood(lik)
    K = torch.as_tensor(K)
    if f_init is None:
        f_init = K.new_zeros(K.shape[-1])
    if tol is None:
        tol = _default_tol(K.dtype)
    leaves, build = _tree(_Observed(lik, ys))
    info = {}
    opts = _NewtonOptions(int(maxiter), float(tol), float(damping), callback)
    f_opt = _NewtonSolve.apply(opts, build, info, K, torch.as_tensor(f_init), *leaves)
    return (f_opt, info["n_iter"]) if return_niter else f_opt


def newton_multistart(lik, ys, K, f_inits, maxiter: int = 100, tol=None,
                      damping: float = 1.0):
    """Newton from each of the (S, N) ``f_inits`` to its own convergence;
    returns ``(f_best, lmls)``: the mode with the highest Laplace lml
    (detached: feed it as ``f_init`` to the differentiable solve) and each
    start's lml.  For likelihoods that are not log-concave, whose posterior
    may have several modes."""
    lik = as_likelihood(lik)
    K = torch.as_tensor(K)
    if tol is None:
        tol = _default_tol(K.dtype)
    f_opts, lmls = [], []
    for f0 in torch.as_tensor(f_inits, dtype=K.dtype, device=K.device):
        f_opt, _ = _newton_inner_loop(lik, ys, K, f0, int(maxiter), float(tol),
                                      damping=float(damping))
        f_opts.append(f_opt)
        lmls.append(_laplace_lml_from_cache(f_opt, _laplace_train_intermediates(lik, ys, K, f_opt)))
    lmls = torch.stack(lmls)
    return f_opts[int(torch.argmax(lmls))].detach(), lmls


def newton_inner_loop_jvp(lik, ys, K, dK, **newton_kwargs):
    """The forward-mode tangent of the fixed point for a kernel-matrix
    tangent ``dK``: (f_opt, ∂f_opt) with ∂f = √W⁻¹ B⁻¹ √W (ΔK ∇ll)."""
    lik = as_likelihood(lik)
    f_opt = newton_inner_loop(lik, ys, K, **newton_kwargs)
    cache = _laplace_train_intermediates(lik, ys, K, f_opt)
    df = linalg.cholesky_solve(cache.B_L, cache.Wsqrt * (dK @ cache.d_loglik)) / cache.Wsqrt
    return f_opt, df


# -- the lml and the posterior -------------------------------------------------


def _validate_laplace_inputs(lfx: LatentFiniteGP, ys):
    """The checks of ``_check_laplace_inputs`` without its Gram (the matrix-
    free tier calls this): a zero prior mean.  Returns the likelihood."""
    mean_fn = getattr(lfx.fx.f, "mean_fn", None)
    if mean_fn is not None and not isinstance(mean_fn, ZeroMean):
        raise ValueError(
            "LaplaceApproximation requires a zero prior mean (non-zero means "
            "are untested in the reference as well)"
        )
    return as_likelihood(lfx.lik)


def _check_laplace_inputs(lfx: LatentFiniteGP, ys):
    """(likelihood, K): K includes the LatentGP jitter."""
    return _validate_laplace_inputs(lfx, ys), lfx.fx.cov()


def laplace_lml(lik, ys, K, f_opt=None, **newton_kwargs):
    """The Laplace approximation to the log marginal likelihood given the
    kernel matrix; runs Newton first when ``f_opt`` is None."""
    lik = as_likelihood(lik)
    if f_opt is None:
        f_opt = newton_inner_loop(lik, ys, K, **newton_kwargs)
    return _laplace_lml_from_cache(f_opt, _laplace_train_intermediates(lik, ys, K, f_opt))


def laplace_f_and_lml(lfx: LatentFiniteGP, ys, **newton_kwargs):
    """(mode, lml, Newton iterations)."""
    lik, K = _check_laplace_inputs(lfx, ys)
    f_opt, n_iter = newton_inner_loop(lik, ys, K, return_niter=True, **newton_kwargs)
    return f_opt, laplace_lml(lik, ys, K, f_opt), n_iter


@dataclasses.dataclass(frozen=True, eq=False)
class LaplacePosterior(AbstractGP):
    """The Laplace posterior GP (RW 3.21 and 3.29).

    Its mean takes the Newton-solved representer weight ``cache.a`` (K a = f̂
    by construction of the last iterate), not ∇ll recomputed at the mode:
    that amplifies the Newton stopping error by λmax(K)/σ² for sharp
    likelihoods."""

    approx: LaplaceApproximation
    prior_fx: FiniteGP
    cache: LaplaceCache

    @property
    def prior(self):
        return self.prior_fx.f

    def _predict_v(self, x):
        k_x_xnew = self.prior.cov(self.prior_fx.x, x)
        v = linalg.solve_lower_triangular(self.cache.B_L, self.cache.Wsqrt[:, None] * k_x_xnew)
        return k_x_xnew, v

    def mean(self, x):
        return self.prior.mean(x) + self.prior.cov(self.prior_fx.x, x).T @ self.cache.a

    def cov(self, x, z=None):
        _, vx = self._predict_v(x)
        if z is None:
            return self.prior.cov(x) - vx.T @ vx
        _, vz = self._predict_v(z)
        return self.prior.cov(x, z) - vx.T @ vz

    def var(self, x):
        _, v = self._predict_v(x)
        return self.prior.var(x) - torch.sum(v * v, dim=0)

    def mean_and_var(self, x):
        k_x_xnew, v = self._predict_v(x)
        return (self.prior.mean(x) + k_x_xnew.T @ self.cache.a,
                self.prior.var(x) - torch.sum(v * v, dim=0))

    def mean_and_cov(self, x):
        k_x_xnew, v = self._predict_v(x)
        return self.prior.mean(x) + k_x_xnew.T @ self.cache.a, self.prior.cov(x) - v.T @ v


@posterior.register(LaplaceApproximation)
def _posterior_laplace(la: LaplaceApproximation, lfx: LatentFiniteGP, ys, **_):
    """Newton's mode, then a differentiable cache recomputed there."""
    lik, K = _check_laplace_inputs(lfx, ys)
    f_opt = newton_inner_loop(lik, ys, K, f_init=la.f_init, maxiter=la.maxiter, tol=la.tol,
                              callback=la.callback, damping=la.damping)
    return LaplacePosterior(approx=la, prior_fx=lfx.fx,
                            cache=_laplace_train_intermediates(lik, ys, K, f_opt))


@approx_lml.register(LaplaceApproximation)
def _approx_lml_laplace(la: LaplaceApproximation, lfx: LatentFiniteGP, ys, **_):
    lik, K = _check_laplace_inputs(lfx, ys)
    return laplace_lml(lik, ys, K, f_init=la.f_init, maxiter=la.maxiter, tol=la.tol,
                       damping=la.damping)


# -- diagnostics ---------------------------------------------------------------


def laplace_f_cov(cache: LaplaceCache):
    """The covariance of q(f) at the mode: √W⁻¹ (I − B⁻¹) √W⁻¹."""
    n = cache.B_L.shape[-1]
    eye = torch.eye(n, dtype=cache.B_L.dtype, device=cache.B_L.device)
    B_inv = linalg.cholesky_solve(cache.B_L, eye)
    Wsqrt_inv = 1.0 / cache.Wsqrt
    return (Wsqrt_inv[:, None] * (eye - B_inv)) * Wsqrt_inv[None, :]


class LaplaceResult(NamedTuple):
    fnew: torch.Tensor
    f_cov: torch.Tensor
    q: MultivariateNormal
    lml_approx: torch.Tensor
    cache: LaplaceCache


def _laplace_result(fnew, cache) -> LaplaceResult:
    f_cov = laplace_f_cov(cache)
    return LaplaceResult(fnew, f_cov, mvnormal_from_cov(cache.f, f_cov),
                         _laplace_lml_from_cache(cache.f, cache), cache)


def laplace_steps(lfx: LatentFiniteGP, ys, **newton_kwargs):
    """Every Newton iterate as a :class:`LaplaceResult`, for diagnostics."""
    lik, K = _check_laplace_inputs(lfx, ys)
    res = []
    newton_kwargs.setdefault("f_init", lfx.fx.mean())
    newton_inner_loop(lik, ys, K, callback=lambda fnew, cache: res.append(
        _laplace_result(fnew, cache)), **newton_kwargs)
    return res


def laplace_steps_scan(lfx: LatentFiniteGP, ys, n_steps: int = 100, f_init=None,
                       tol: float | None = None):
    """The Newton trajectory in exactly ``n_steps`` steps with no host sync:
    a dict with ``f`` (n_steps, N), ``lml`` (n_steps,), ``valid``
    (n_steps,), ``n_iter`` and ``f_opt``.  Once converged the carry freezes,
    and later entries (``valid`` False) are copies of the converged state.
    Not differentiable."""
    lik, K = _check_laplace_inputs(lfx, ys)
    f = lfx.fx.mean() if f_init is None else f_init
    f = torch.as_tensor(f).to(dtype=K.dtype, device=K.device)
    if tol is None:
        tol = _default_tol(K.dtype)
    done = torch.zeros((), dtype=torch.bool, device=K.device)
    n_iter = torch.zeros((), dtype=torch.int64, device=K.device)
    fs, lmls, valid = [], [], []
    with torch.no_grad():
        for _ in range(int(n_steps)):
            fnew, cache = _newton_step(lik, ys, K, f)
            ok = ~done
            lmls.append(_laplace_lml_from_cache(cache.f, cache))
            newly_done = _isapprox(f, fnew, tol)
            f = torch.where(done, f, fnew)
            done = done | newly_done
            n_iter = n_iter + ok.to(n_iter.dtype)
            fs.append(f)
            valid.append(ok)
    return {"f": torch.stack(fs), "lml": torch.stack(lmls), "valid": torch.stack(valid),
            "n_iter": n_iter, "f_opt": f}


# -- the hyperparameter objective, warm-started ------------------------------------


class LaplaceObjective:
    """−approx_lml(θ) with Newton warm-started from the previous call's mode.

    ``objective(*args)`` is the value; ``objective.value_and_grad(*args)``
    the value and the gradient in each argument (tensors), through
    ``torch.autograd.grad``.  ``newton_steps`` counts the Newton iterations
    over all calls; ``newton_callback(fnew, cache)`` sees every one."""

    def __init__(self, build_latent_gp, xs, ys, newton_warmstart=True, newton_callback=None,
                 newton_maxiter=100, newton_tol=None, f_init=None):
        self.build_latent_gp = build_latent_gp
        self.xs = xs
        self.ys = ys
        self.newton_warmstart = newton_warmstart
        self.newton_callback = newton_callback
        self.newton_maxiter = newton_maxiter
        self.newton_tol = newton_tol
        # the warm-start cache, seeded by f_init where given
        self.f = None if f_init is None else torch.as_tensor(f_init)
        self.newton_steps = 0

    def _value(self, args):
        lfx = self.build_latent_gp(*args)(self.xs)
        f_init = lfx.fx.mean() if self.f is None else self.f
        lik, K = _check_laplace_inputs(lfx, self.ys)
        f_opt, n_iter = newton_inner_loop(lik, self.ys, K, f_init=f_init,
                                          maxiter=self.newton_maxiter, tol=self.newton_tol,
                                          callback=self.newton_callback, return_niter=True)
        self.newton_steps += n_iter
        if self.newton_warmstart:
            self.f = f_opt.detach()
        return -laplace_lml(lik, self.ys, K, f_opt)

    @property
    def cache(self) -> "LaplaceObjective":
        """The warm-start cache (the JAX package's ``objective.cache``):
        ``cache.f`` is the mode of the last call, the ``f_init`` of the next,
        and seeds a posterior at the optimum
        (``LaplaceApproximation(f_init=objective.cache.f)``)."""
        return self

    def __call__(self, *args):
        with torch.no_grad():
            return self._value(args)

    def value_and_grad(self, *args):
        ins = [torch.as_tensor(a).detach().requires_grad_() for a in args]
        value = self._value(ins)
        grads = torch.autograd.grad(value, ins, allow_unused=True) if ins else ()
        grads = tuple(torch.zeros_like(t) if g is None else g for t, g in zip(ins, grads))
        return value.detach(), (grads[0] if len(grads) == 1 else grads)


def build_laplace_objective(build_latent_gp, xs, ys, **kwargs) -> LaplaceObjective:
    """The warm-started objective of ``build_latent_gp(*args)(xs)`` on ``ys``."""
    return LaplaceObjective(build_latent_gp, xs, ys, **kwargs)
