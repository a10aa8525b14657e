"""The matrix-free Laplace approximation: Newton steps by CG, the log
determinant by stochastic Lanczos quadrature (port of the single-device
path of ``approximategps_tpu/models/laplace_cg.py``).

Every product with K(x, x) is one :func:`_k_matvec`: the port's
``kernel_matvec``, which takes the fused ``gram_matvec`` kernel (row 5) on
the card; where that kernel does not run, a Gram built once a solve below
``config.cg_dense_threshold`` points.  Each Newton step solves B = I + √W K √W by
preconditioned CG (SPD for log-concave likelihoods; wrap others in
:class:`~approximategps_tpu_torch.core.likelihoods.GaussNewtonLikelihood`).

- :func:`newton_inner_loop_cg`: the mode, IFT-differentiable through
  :class:`_NewtonSolveCG`, whose backward runs one CG solve and the
  pullback of λᵀ K(θ, x) ∇ll(f̂; θ, y) (row 5's self-Gram pullback at R = 1);
- :func:`laplace_lml_cg`: the lml, with ½ logdet B from block Lanczos over
  the probes and the stochastic-trace gradient of :class:`_LogdetBSLQ`
  (one block CG and the surrogate's pullback, R = the probe count);
- :class:`LaplaceCGPosterior`: predictions through batched CG.

Differences from the JAX package: the loops are Python loops (CG one host
sync an iteration, Newton one); the probes come from a ``torch.Generator``
(or an int seed) or are given.

``mesh=`` (a :class:`~approximategps_tpu_torch.parallel.DataMesh`) splits
every product with K over the ranks by row bands: the chunked storage
through ``kernel_matvec(mesh=)`` (row 5's cross pass on the card), the
resident one with only this rank's (ceil(N / size), N) band of K stored.
The bands are all-gathered, so every rank holds the same vectors and takes
the same branches, and the IFT and SLQ pullbacks give every rank the same
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import config
from ..core.gp import AbstractGP, LatentFiniteGP
from ..core.kernels import as_points
from ..core.likelihoods import as_likelihood
from ..ops.gram_matvec import fused_stationary_matvec
from ..parallel import _comm
from .api import approx_lml, posterior
from .iterative import (
    _band,
    _lanczos_block,
    _slq_quadrature,
    _tree,
    cg_solve,
    kernel_matvec,
    pivoted_cholesky,
    rademacher_probes,
    woodbury_preconditioner,
)
from .laplace import _default_tol, _validate_laplace_inputs

__all__ = [
    "LaplaceCG",
    "LaplaceCGPosterior",
    "newton_inner_loop_cg",
    "laplace_lml_cg",
]

_STORAGE = ("auto", "chunked", "dense")


def _k_matvec(kern, x, block_size, noise=0.0, storage: str = "auto", mesh=None):
    """``mv(V) = (K(x, x) + noise·I)·V`` (noise: the LatentGP jitter, which
    the dense path's K = fx.cov() holds too).  "chunked" returns
    ``kernel_matvec`` (O(N·block) memory; row 5 on the card), "dense"
    builds the Gram once and multiplies with it.  "auto" takes
    ``kernel_matvec`` wherever the fused kernel runs (a product through it
    costs less than one with a stored Gram; blocks wider than
    ``config.matvec_fused_max_rhs`` take its Gram blocks), and elsewhere
    the Gram for N ≤ ``config.cg_dense_threshold`` (a Newton solve runs
    hundreds of products).  With ``mesh`` each rank stores (dense) or
    computes (chunked) its row band of K, and the bands are all-gathered."""
    if storage not in _STORAGE:
        raise ValueError(f"unknown storage {storage!r}; expected one of {_STORAGE}")
    X = as_points(x)
    if storage == "auto":
        small = X.shape[0] <= config.cg_dense_threshold
        storage = "dense" if small and fused_stationary_matvec(kern, X) is None else "chunked"
    if storage == "dense" and mesh is not None:
        return _dp_dense_matvec(kern, X, noise, mesh)
    if storage == "dense":
        K = kern.gram(X)
        nz = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
        return lambda v: K @ v + nz * v
    return kernel_matvec(kern, X, noise, block_size, mesh=mesh)


def _dp_dense_matvec(kern, X, noise, mesh):
    """The resident Gram's rows split over the ranks: this rank keeps its
    (ceil(N / size), N) band of K, multiplies it and all-gathers."""
    N = X.shape[0]
    Xr = _comm.replicate(mesh, X)
    Kb = _comm.replicate_tree(mesh, kern).gram(_band(mesh, Xr), Xr)
    nz = torch.as_tensor(noise, dtype=Kb.dtype, device=Kb.device)

    def mv(v):
        vec = v.ndim == 1
        V = v[:, None] if vec else v
        out = _comm.gather_rows(mesh, Kb @ _comm.replicate(mesh, V))[:N] + nz * V
        return out[:, 0] if vec else out

    return mv


def _b_precond(kern, x, rank: int):
    """The rank-``rank`` pivoted-Cholesky factor L_r of K (None for rank
    0): B ≈ I + (√W∘L_r)(√W∘L_r)ᵀ, a Woodbury form refreshed for each W."""
    if rank <= 0:
        return None
    X = as_points(x)
    return pivoted_cholesky(kern, X, min(rank, X.shape[0]))


def _b_minv(Lr, Wsqrt):
    """The preconditioner for the current W, or None."""
    return None if Lr is None else woodbury_preconditioner(Wsqrt[:, None] * Lr, 1.0)


def _b_matvec(kmv, Wsqrt):
    """``mv(V) = (I + √W K √W)·V`` for V (N,) or (N, R)."""

    def mv(v):
        w = Wsqrt[:, None] if v.ndim == 2 else Wsqrt
        return v + w * kmv(w * v)

    return mv


def _newton_body_cg(lik, ys, kmv, f, cg_tol, cg_maxiter, damping, Lr=None, s0=None):
    """One matrix-free Newton step: a = b − √W B⁻¹ √W (K b), fnew = K a;
    the inner solve preconditioned by ``Lr`` and started from ``s0``."""
    _ll, d_ll, d2_ll = lik.log_prob_d1_d2(f, ys)
    W = -d2_ll
    Wsqrt = torch.sqrt(W)
    b = W * f + d_ll
    s = cg_solve(_b_matvec(kmv, Wsqrt), Wsqrt * kmv(b), tol=cg_tol, maxiter=cg_maxiter,
                 M_inv=_b_minv(Lr, Wsqrt), x0=s0)
    a = b - Wsqrt * s
    fnew = kmv(a)
    if damping != 1.0:
        fnew = f + damping * (fnew - f)
    return fnew, a, s


def _newton_loop_cg(lik, ys, kmv, f_init, maxiter, tol, cg_tol, cg_maxiter, damping, Lr=None):
    """Newton by CG steps to a relative step of ``tol``, or until the step
    stops shrinking: from the 4th iteration on, a step above 0.9× the one
    before it ends the loop (in f32 at large N the step reaches a floor set
    by the products' rounding, amplified by λmax(K), which no tolerance
    crosses; Newton contracts faster than that while it makes progress, and
    damped steps by 1 − damping).  Each step's CG starts from the previous
    step's solution, the first from zeros.  Returns (f_opt, iterations)."""
    fnew = f_init
    s = torch.zeros_like(f_init)
    rel = rel_prev = float("inf")
    tiny = torch.finfo(f_init.dtype).tiny
    it = 0
    while it < maxiter and not (it > 0 and rel <= tol) and not (it >= 4 and rel > 0.9 * rel_prev):
        f = fnew
        fnew, _a, s = _newton_body_cg(lik, ys, kmv, f, cg_tol, cg_maxiter, damping, Lr=Lr, s0=s)
        denom = torch.clamp(torch.maximum(torch.linalg.vector_norm(f),
                                          torch.linalg.vector_norm(fnew)), min=tiny)
        # the loop's one host sync an iteration
        rel_prev, rel = rel, float(torch.linalg.vector_norm(f - fnew) / denom)
        it += 1
    return fnew, it


@dataclasses.dataclass(frozen=True)
class _CGOptions:
    maxiter: int
    tol: float
    cg_tol: float
    cg_maxiter: int
    damping: float
    block_size: int | None
    precond_rank: int
    storage: str
    mesh: object = None


@dataclasses.dataclass(frozen=True, eq=False)
class _Problem:
    """What the Newton fixed point depends on."""

    lik: Any
    ys: Any
    kern: Any
    x: torch.Tensor
    noise: torch.Tensor


class _NewtonSolveCG(torch.autograd.Function):
    """f̂ by CG-Newton with the IFT pullback, matrix-free: for the
    cotangent Δf,

        λ = √W B⁻¹ √W⁻¹ Δf  (one preconditioned CG solve),
        (θ̄, x̄, θ̄_lik, ȳ) = the pullback of λᵀ K(θ, x) ∇ll(f̂; θ, y),

    K̄ = λ∇llᵀ pushed through the matvec instead of formed (row 5's
    self-Gram pullback at R = 1 on the card).  The forward keeps its
    inputs and f̂; the backward rebuilds the factor and the operator."""

    @staticmethod
    def forward(ctx, opts, build, info, f_init, *leaves):
        p = build(leaves)
        kmv = _k_matvec(p.kern, p.x, opts.block_size, p.noise, opts.storage, opts.mesh)
        Lr = _b_precond(p.kern, p.x, opts.precond_rank)
        f_opt, info["n_iter"] = _newton_loop_cg(p.lik, p.ys, kmv, f_init, opts.maxiter,
                                                opts.tol, opts.cg_tol, opts.cg_maxiter,
                                                opts.damping, Lr=Lr)
        ctx.opts, ctx.build = opts, build
        ctx.save_for_backward(f_opt, *leaves)
        return f_opt

    @staticmethod
    def backward(ctx, ct_f):
        f_opt, *leaves = ctx.saved_tensors
        opts, build = ctx.opts, ctx.build
        needs = ctx.needs_input_grad[4:]
        if not any(needs):
            return (None,) * (4 + len(leaves))
        with torch.no_grad():
            p = build(leaves)
            kmv = _k_matvec(p.kern, p.x, opts.block_size, p.noise, opts.storage, opts.mesh)
            Lr = _b_precond(p.kern, p.x, opts.precond_rank)
            _ll, _d_ll, d2_ll = p.lik.log_prob_d1_d2(f_opt, p.ys)
            Wsqrt = torch.sqrt(-d2_ll)
            lam = Wsqrt * cg_solve(_b_matvec(kmv, Wsqrt), ct_f / Wsqrt, tol=opts.cg_tol,
                                   maxiter=opts.cg_maxiter, M_inv=_b_minv(Lr, Wsqrt))
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(leaves, needs)]
            q = build(ins)
            # f̂ held fixed (detached: the saved output would carry this
            # Function's graph, and the product would form a V̄ nobody reads)
            _, d1, _ = q.lik.log_prob_d1_d2(f_opt.detach(), q.ys)
            s = lam @ _k_matvec(q.kern, q.x, opts.block_size, q.noise, opts.storage,
                                opts.mesh)(d1)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(s, wanted, allow_unused=True))
        return (None, None, None, None, *(next(grads) if t.requires_grad else None for t in ins))


def newton_inner_loop_cg(
    lik,
    ys,
    kern,
    x,
    f_init=None,
    maxiter: int = 100,
    tol=None,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 1000,
    damping: float = 1.0,
    block_size: int | None = None,
    noise=0.0,
    precond_rank: int = 128,
    storage: str = "auto",
    return_niter: bool = False,
    mesh=None,
):
    """The mode f̂ with K(x, x) reached only through products,
    IFT-differentiable in the kernel's hyperparameters, the inputs, the
    likelihood's parameters and float targets (the pullback runs one more CG
    solve).  ``noise`` is the LatentGP jitter.

    Solution-invariant knobs (they change iteration counts, not the
    answer): ``precond_rank``, the rank of the pivoted-Cholesky Woodbury
    preconditioner (0: none); ``storage`` ("auto", "chunked" or "dense", see
    :func:`_k_matvec`); and each Newton step's CG starts from the previous
    step's solution.  ``mesh`` splits every product over its ranks."""
    lik = as_likelihood(lik)
    X = as_points(x)
    if f_init is None:
        f_init = X.new_zeros(X.shape[0])
    f_init = torch.as_tensor(f_init).to(dtype=X.dtype, device=X.device)
    if tol is None:
        tol = _default_tol(f_init.dtype)
    noise = torch.as_tensor(noise, dtype=X.dtype, device=X.device)
    leaves, build = _tree(_Problem(lik, ys, kern, X, noise))
    opts = _CGOptions(int(maxiter), float(tol), float(cg_tol), int(cg_maxiter), float(damping),
                      block_size, int(precond_rank), storage, mesh)
    info = {}
    f_opt = _NewtonSolveCG.apply(opts, build, info, f_init, *leaves)
    return (f_opt, info["n_iter"]) if return_niter else f_opt


@dataclasses.dataclass(frozen=True)
class _SLQOptions:
    lanczos_iters: int
    cg_tol: float
    cg_maxiter: int
    block_size: int | None
    precond_rank: int
    storage: str
    mesh: object = None


@dataclasses.dataclass(frozen=True, eq=False)
class _LogdetInputs:
    Wsqrt: torch.Tensor
    kern: Any
    x: torch.Tensor
    noise: torch.Tensor
    probes: torch.Tensor


class _LogdetBSLQ(torch.autograd.Function):
    """logdet(I + √W K √W) by block Lanczos over the (n, P) probe block,
    with the stochastic-trace gradient

        ∂ logdet B = tr(B⁻¹ ∂B) ≈ (1/P) Σ_p (B⁻¹z_p)ᵀ (∂B) z_p:

    the backward solves B⁻¹Z by one preconditioned block CG and pulls the
    surrogate mean_p (B⁻¹z_p)ᵀ B(√W, θ, x) z_p back by autograd (row 5's
    self-Gram pullback at R = P on the card).  Differentiable in √W (and
    through it f̂), the kernel's hyperparameters, the inputs, the jitter
    and the probes."""

    @staticmethod
    def forward(ctx, opts, build, *leaves):
        p = build(leaves)
        bmv = _b_matvec(_k_matvec(p.kern, p.x, opts.block_size, p.noise, opts.storage,
                                  opts.mesh), p.Wsqrt)
        alphas, betas = _lanczos_block(bmv, p.probes.T, opts.lanczos_iters)
        ctx.opts, ctx.build = opts, build
        ctx.save_for_backward(*leaves)
        return _slq_quadrature(alphas, betas, p.Wsqrt.shape[0], 1e-30)

    @staticmethod
    def backward(ctx, ct):
        leaves = ctx.saved_tensors
        opts, build = ctx.opts, ctx.build
        needs = ctx.needs_input_grad[2:]
        if not any(needs):
            return (None,) * (2 + len(leaves))
        with torch.no_grad():
            p = build(leaves)
            bmv = _b_matvec(_k_matvec(p.kern, p.x, opts.block_size, p.noise, opts.storage,
                                      opts.mesh), p.Wsqrt)
            Lr = _b_precond(p.kern, p.x, opts.precond_rank)
            W_solves = cg_solve(bmv, p.probes.T, tol=opts.cg_tol, maxiter=opts.cg_maxiter,
                                M_inv=_b_minv(Lr, p.Wsqrt))  # (n, P)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(leaves, needs)]
            q = build(ins)
            mv = _k_matvec(q.kern, q.x, opts.block_size, q.noise, opts.storage, opts.mesh)
            w = q.Wsqrt[:, None]
            bz = q.probes.T + w * mv(w * q.probes.T)
            sur = torch.mean(torch.sum(W_solves * bz, dim=0))
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(sur, wanted, ct, allow_unused=True))
        return (None, None, *(next(grads) if t.requires_grad else None for t in ins))


def laplace_lml_cg(
    lik,
    ys,
    kern,
    x,
    generator=None,
    f_opt=None,
    num_probes: int = 16,
    lanczos_iters: int = 30,
    block_size: int | None = None,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 1000,
    noise=0.0,
    precond_rank: int = 128,
    storage: str = "auto",
    probes: torch.Tensor | None = None,
    mesh=None,
    **newton_kwargs,
):
    """The Laplace lml with ½ logdet(B), B = I + √W K √W, by stochastic
    Lanczos quadrature: no N × N matrix and no Cholesky.

    Differentiable: the mode through the CG-Newton IFT, the explicit terms
    through the cache recomputed at the fixed point (which carries RW 5.23's
    implicit terms, as in the dense module), the log determinant through
    :class:`_LogdetBSLQ`.  The Rademacher probes come from ``generator``
    (a ``torch.Generator`` or an int seed) or are given as ``probes``
    (num_probes, N); fixed probes give a deterministic objective.  ``mesh``
    splits every product over its ranks; probes drawn here are rank 0's on
    every rank."""
    lik = as_likelihood(lik)
    X = as_points(x)
    noise = torch.as_tensor(noise, dtype=X.dtype, device=X.device)
    if f_opt is None:
        f_opt = newton_inner_loop_cg(lik, ys, kern, X, block_size=block_size, cg_tol=cg_tol,
                                     cg_maxiter=cg_maxiter, noise=noise,
                                     precond_rank=precond_rank, storage=storage, mesh=mesh,
                                     **newton_kwargs)
    ll, d_ll, d2_ll = lik.log_prob_d1_d2(f_opt, ys)
    Wsqrt = torch.sqrt(-d2_ll)
    n = f_opt.shape[0]
    if probes is None:
        if generator is None:
            raise ValueError("laplace_lml_cg needs a generator (or seed) or the probes")
        probes = rademacher_probes(generator, num_probes, n, f_opt.dtype, f_opt.device)
        if mesh is not None:
            probes = _comm.broadcast(mesh, probes)
    probes = probes.to(dtype=f_opt.dtype, device=f_opt.device)
    leaves, build = _tree(_LogdetInputs(Wsqrt, kern, X, noise, probes))
    opts = _SLQOptions(int(lanczos_iters), float(cg_tol), int(cg_maxiter), block_size,
                       int(precond_rank), storage, mesh)
    logdet_B = _LogdetBSLQ.apply(opts, build, *leaves)
    # a = K⁻¹f̂ = ∇ll at the fixed point (f̂ = K ∇ll)
    return -0.5 * (d_ll @ f_opt) + ll - 0.5 * logdet_B


@dataclasses.dataclass(frozen=True, eq=False)
class LaplaceCG:
    """The matrix-free Laplace approximation's options (the counterpart of
    :class:`~approximategps_tpu_torch.models.laplace.LaplaceApproximation`).
    ``approx_lml`` needs a ``generator`` or the ``probes``; ``posterior`` is
    deterministic given the CG tolerances."""

    f_init: torch.Tensor | None = None
    maxiter: int = 100
    tol: float | None = None
    cg_tol: float = 1e-6
    cg_maxiter: int = 1000
    damping: float = 1.0
    block_size: int | None = None
    num_probes: int = 16
    lanczos_iters: int = 30
    # solution-invariant: the preconditioner's rank and the Gram's storage
    precond_rank: int = 128
    storage: str = "auto"
    # a parallel.DataMesh: every product with K split over its ranks
    mesh: Any = None


@dataclasses.dataclass(frozen=True, eq=False)
class LaplaceCGPosterior(AbstractGP):
    """The Laplace posterior with matrix-free predictions (RW 3.21, 3.29):

        μ* = m(x*) + K*fᵀ a,    Σ* = K** − K*fᵀ √W B⁻¹ √W K*f (batched CG).

    ``a`` is the Newton-solved representer weight of one more step at the
    mode (K a = f̂ to the CG tolerance), not ∇ll recomputed at f̂, which
    amplifies the Newton stopping error by λmax(K)·max W."""

    lfx: LatentFiniteGP
    f_opt: torch.Tensor
    a: torch.Tensor
    Wsqrt: torch.Tensor
    approx: LaplaceCG = dataclasses.field(default_factory=LaplaceCG)

    @property
    def prior(self):
        return self.lfx.fx.f

    def _train_x(self):
        return as_points(self.lfx.fx.x)

    def _solved(self, x):
        """(K(x_train, x), √W B⁻¹ √W K(x_train, x)); the training operator
        holds the LatentGP jitter, the cross-covariances do not."""
        xt = self._train_x()
        la = self.approx
        Kxs = self.prior.cov(xt, x)  # (N, N*)
        kmv = _k_matvec(self.prior.kernel, xt, la.block_size, self.lfx.fx.noise, la.storage,
                        la.mesh)
        Lr = _b_precond(self.prior.kernel, xt, la.precond_rank)
        V = cg_solve(_b_matvec(kmv, self.Wsqrt), self.Wsqrt[:, None] * Kxs, tol=la.cg_tol,
                     maxiter=la.cg_maxiter, M_inv=_b_minv(Lr, self.Wsqrt))
        return Kxs, self.Wsqrt[:, None] * V

    def mean(self, x):
        return self.prior.mean(x) + self.prior.cov(self._train_x(), x).T @ self.a

    def cov(self, x, z=None):
        Kxs, U = self._solved(x)
        if z is None:
            return self.prior.cov(x) - Kxs.T @ U
        return self.prior.cov(x, z) - U.T @ self.prior.cov(self._train_x(), z)

    def var(self, x):
        Kxs, U = self._solved(x)
        return self.prior.var(x) - torch.sum(Kxs * U, dim=0)

    def mean_and_var(self, x):
        Kxs, U = self._solved(x)
        return self.prior.mean(x) + Kxs.T @ self.a, self.prior.var(x) - torch.sum(Kxs * U, dim=0)

    def mean_and_cov(self, x):
        Kxs, U = self._solved(x)
        return self.prior.mean(x) + Kxs.T @ self.a, self.prior.cov(x) - Kxs.T @ U


@posterior.register(LaplaceCG)
def _posterior_laplace_cg(la: LaplaceCG, lfx: LatentFiniteGP, ys, **_):
    lik = _validate_laplace_inputs(lfx, ys)  # builds no N × N Gram
    kern, x, noise = lfx.fx.f.kernel, as_points(lfx.fx.x), lfx.fx.noise
    f_opt = newton_inner_loop_cg(lik, ys, kern, x, f_init=la.f_init, maxiter=la.maxiter,
                                 tol=la.tol, cg_tol=la.cg_tol, cg_maxiter=la.cg_maxiter,
                                 damping=la.damping, block_size=la.block_size, noise=noise,
                                 precond_rank=la.precond_rank, storage=la.storage,
                                 mesh=la.mesh)
    # one more Newton step at the mode, for the solved representer weight
    kmv = _k_matvec(kern, x, la.block_size, noise, la.storage, la.mesh)
    _fnew, a, _s = _newton_body_cg(lik, ys, kmv, f_opt, la.cg_tol, la.cg_maxiter, 1.0,
                                   Lr=_b_precond(kern, x, la.precond_rank))
    _ll, _d_ll, d2_ll = lik.log_prob_d1_d2(f_opt, ys)
    return LaplaceCGPosterior(lfx=lfx, f_opt=f_opt, a=a, Wsqrt=torch.sqrt(-d2_ll), approx=la)


@approx_lml.register(LaplaceCG)
def _approx_lml_laplace_cg(la: LaplaceCG, lfx: LatentFiniteGP, ys, *, generator=None,
                           probes=None, **_):
    if generator is None and probes is None:
        raise ValueError(
            "approx_lml(LaplaceCG(...), lfx, ys, generator=...) needs a generator (or seed) "
            "or the probes for the SLQ logdet"
        )
    lik = _validate_laplace_inputs(lfx, ys)  # builds no N × N Gram
    return laplace_lml_cg(
        lik, ys, lfx.fx.f.kernel, lfx.fx.x, generator, probes=probes,
        num_probes=la.num_probes, lanczos_iters=la.lanczos_iters, block_size=la.block_size,
        f_init=la.f_init, maxiter=la.maxiter, tol=la.tol, cg_tol=la.cg_tol,
        cg_maxiter=la.cg_maxiter, damping=la.damping, noise=lfx.fx.noise,
        precond_rank=la.precond_rank, storage=la.storage, mesh=la.mesh,
    )
