"""Matrix-free exact GP inference: CG solves and stochastic Lanczos
quadrature log-determinants (port of the single-device path of
``approximategps_tpu/models/iterative.py``).

The BBMM approach of Gardner et al. (2018): the only access to K is a
product K·V, which :func:`kernel_matvec` computes without storing K, through
the fused ``gram_matvec`` kernel (``ops/gram_matvec.py``) where it serves and
Gram row blocks elsewhere.

- :func:`cg_solve`: block conjugate gradients with per-column freezing;
- :func:`pivoted_cholesky`, :func:`woodbury_preconditioner`: the
  preconditioner P = Lk Lkᵀ + σ²I;
- :func:`posterior_cg`: the exact posterior through CG solves;
- :func:`logpdf_slq`: the log marginal likelihood, quad term by CG, logdet by
  SLQ, with the stochastic-trace gradient;
- :func:`msqrt_matvec`, :func:`sample_prior_msqrt`,
  :func:`sample_posterior_msqrt`: A^{1/2}b by Lanczos and the samplers on it.

Differences from the JAX package: ``lax.while_loop`` and ``scan`` are Python
loops; CG tests its residuals on the host once an iteration (one sync,
counted in ``stats``); CG runs without autograd (the JAX loop is not
reverse-differentiable either), and :func:`logpdf_slq` brings its own
gradient; random draws come from a ``torch.Generator`` (or an int seed).

``mesh=`` (a :class:`~approximategps_tpu_torch.parallel.DataMesh`) splits
every product's rows over the ranks: each rank computes its band
K(X_band, X)·V (row 5's cross pass on the card, or Gram row blocks where it
declines) and the bands are all-gathered, so the vectors of CG and Lanczos
stay bitwise equal on every rank and every rank takes the same branch.
Gradients through the bands are summed over the ranks once
(``parallel/_comm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core.distributions import standard_normals
from ..core.gp import FiniteGP
from ..core.kernels import as_points
from ..ops.gram_matvec import fused_stationary_matvec
from ..parallel import _comm
from ..parallel.data_parallel import shard_batch
from ..utils.profiling import named_scope

__all__ = [
    "cg_solve",
    "kernel_matvec",
    "posterior_cg",
    "logpdf_slq",
    "CGPosterior",
    "pivoted_cholesky",
    "woodbury_preconditioner",
    "rademacher_probes",
    "msqrt_matvec",
    "sample_prior_msqrt",
    "sample_posterior_msqrt",
    "stats",
    "reset_stats",
]

# what a run of this module did: K·V applications by route, CG solves,
# iterations and the host syncs of their residual tests
stats = {"matvec_fused": 0, "matvec_plain": 0, "cg_solves": 0, "cg_iterations": 0,
         "cg_host_syncs": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    tol: float = 1e-6,
    maxiter: int = 1000,
    M_inv: Callable[[torch.Tensor], torch.Tensor] | None = None,
    return_info: bool = False,
    x0: torch.Tensor | None = None,
):
    """Solve A X = B for SPD A given only ``matvec(V) = A·V``.

    B: (N,) or (N, R); all columns iterate together, each frozen (α = β = 0,
    an exact no-op) once its relative residual is at ``tol``: without the
    freeze, f32 block CG diverged in the JAX package.  ``M_inv`` applies a
    preconditioner, ``x0`` warm-starts.  Not differentiable (runs without
    autograd).  ``return_info`` adds the iteration count."""
    with torch.no_grad():
        vec = B.ndim == 1
        if vec:
            B = B[:, None]
        if M_inv is None:
            M_inv = lambda r: r  # noqa: E731
        if x0 is None:
            X = torch.zeros_like(B)
            R = B
        else:
            X = x0[:, None] if (vec and x0.ndim == 1) else x0
            R = B - matvec(X)
        Z = M_inv(R)
        P = Z
        rz = torch.sum(R * Z, dim=0)
        b_norm = torch.clamp(torch.linalg.vector_norm(B, dim=0), min=1e-30)
        stats["cg_solves"] += 1
        i = 0
        while i < maxiter:
            res = torch.linalg.vector_norm(R, dim=0) / b_norm
            stats["cg_host_syncs"] += 1
            if not bool(torch.max(res) > tol):
                break
            active = (res > tol).to(R.dtype)
            AP = matvec(P)
            denom = torch.sum(P * AP, dim=0)
            # denom <= 0 only by rounding on a frozen or stagnated column
            alpha = active * rz / torch.where(denom <= 0, 1.0, denom)
            X = X + alpha * P
            R = R - alpha * AP
            Z = M_inv(R)
            rz_new = torch.sum(R * Z, dim=0)
            beta = active * rz_new / torch.where(rz == 0, 1.0, rz)
            P = torch.where(active > 0, Z + beta * P, P)
            rz = torch.where(active > 0, rz_new, rz)
            i += 1
        stats["cg_iterations"] += i
    X = X[:, 0] if vec else X
    return (X, i) if return_info else X


def pivoted_cholesky(kernel, x, rank: int) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky of K(x, x): L (N, rank) with LLᵀ ≈ K,
    pivoting on the largest residual diagonal (Harbrecht et al. 2012); only
    ``rank`` kernel rows are evaluated.  A column whose pivot is below the
    relative floor max(N, 100)·eps·max(diag K) is left zero.  Returns a
    constant (no autograd graph); its loop never syncs the host.  Its work
    is one span, "pivoted_cholesky" (``utils.profiling.named_scope``)."""
    with torch.no_grad(), named_scope("pivoted_cholesky"):
        X = as_points(x)
        N = X.shape[0]
        d = kernel.diag(X)
        dtype = d.dtype
        floor = max(float(N), 100.0) * torch.finfo(dtype).eps * torch.max(d)
        tiny = torch.finfo(dtype).tiny
        L = torch.zeros((N, rank), dtype=dtype, device=d.device)
        for j in range(rank):
            idx = torch.argmax(d).view(1)  # the first of equal maxima
            di = d.index_select(0, idx)
            row = kernel.gram(X, X.index_select(0, idx))[:, 0]  # K[:, i]
            corr = L @ L.index_select(0, idx)[0]
            col = torch.where(di > floor, (row - corr) / torch.sqrt(torch.clamp(di, min=tiny)),
                              0.0)
            L[:, j] = col
            d = torch.clamp(d - col * col, min=0.0)
            d.index_fill_(0, idx, 0.0)
    return L


def _sigma2(noise, like: torch.Tensor) -> torch.Tensor:
    s2 = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    if s2.ndim != 0:
        raise ValueError("the Woodbury preconditioner requires isotropic noise")
    return s2


def woodbury_preconditioner(Lk: torch.Tensor, noise) -> Callable:
    """P⁻¹ for P = Lk Lkᵀ + σ²I by Woodbury:
    P⁻¹ = σ⁻²(I − Lk (σ²I_r + LkᵀLk)⁻¹ Lkᵀ), two (N, r) products an apply
    after one r × r Cholesky.  Isotropic noise only."""
    s2 = _sigma2(noise, Lk)
    r = Lk.shape[1]
    cap = s2 * torch.eye(r, dtype=Lk.dtype, device=Lk.device) + Lk.T @ Lk
    cap_L = torch.linalg.cholesky(cap)

    def apply(Rv):
        vec = Rv.ndim == 1
        R2 = Rv[:, None] if vec else Rv
        s = torch.cholesky_solve(Lk.T @ R2, cap_L)
        out = (R2 - Lk @ s) / s2
        return out[:, 0] if vec else out

    return apply


def kernel_matvec(kernel, x, noise, block_size: int | None = None, mesh=None):
    """``matvec(V) = (K(x, x) + Σ)·V`` for V (N,) or (N, R), without storing
    K: the fused ``gram_matvec`` where :func:`~approximategps_tpu_torch.ops.
    gram_matvec.fused_stationary_matvec` qualifies (R ≤
    ``config.matvec_fused_max_rhs``), else Gram row blocks of ``block_size``
    (all of K when None).  Σ is scalar, (N,) or (N, N) noise.

    ``mesh``: a :class:`~approximategps_tpu_torch.parallel.DataMesh`; each
    rank then computes the band of ceil(N / size) rows K(X_band, X)·V (the
    fused cross pass, or Gram row blocks of ``block_size`` for that call
    where it declines) and the bands are all-gathered."""
    X = as_points(x)
    N = X.shape[0]
    nz = torch.as_tensor(noise, dtype=X.dtype, device=X.device)

    def noise_apply(V2):
        if nz.ndim == 0:
            return nz * V2
        if nz.ndim == 1:
            return nz[:, None] * V2
        return nz @ V2

    if mesh is not None:
        return _dp_kernel_matvec(kernel, X, noise_apply, block_size, mesh)

    fused = fused_stationary_matvec(kernel, X)
    bs = N if block_size is None else block_size

    def block(xb, V2):
        return kernel.gram(xb, X) @ V2

    def matvec(V):
        vec = V.ndim == 1
        V2 = V[:, None] if vec else V
        out = fused(V) if fused is not None else None
        if out is not None:
            stats["matvec_fused"] += 1
            out = out[:, None] if vec else out
        else:
            stats["matvec_plain"] += 1
            if bs >= N:
                out = kernel.gram(X) @ V2
            elif torch.is_grad_enabled():
                # under autograd each (bs, N) Gram block is rebuilt in the
                # backward instead of kept: at N = 1e5 the kept blocks of
                # one product would not fit device memory
                out = torch.cat([checkpoint(block, X[i:i + bs], V2, use_reentrant=False)
                                 for i in range(0, N, bs)])
            else:
                out = torch.cat([block(X[i:i + bs], V2) for i in range(0, N, bs)])
        out = out + noise_apply(V2)
        return out[:, 0] if vec else out

    return matvec


def _band(mesh, X: torch.Tensor) -> torch.Tensor:
    """This rank's ceil(N / size) rows of X (``shard_batch``), padded with
    zero rows (their products are computed and dropped)."""
    N = X.shape[0]
    sl = shard_batch(mesh, N)
    Xb = X[sl]
    rows = sl.stop - sl.start
    if Xb.shape[0] < rows:
        Xb = torch.cat([Xb, Xb.new_zeros((rows - Xb.shape[0], X.shape[1]))])
    return Xb


def _dp_kernel_matvec(kernel, X, noise_apply, block_size, mesh):
    """(K + Σ)·V by row bands over the ranks of ``mesh``: the band
    K(X_band, X)·V on each rank, all-gathered; Σ·V on every rank.  The
    kernel's tensors, X and V enter the band through ``replicate``, so their
    gradients are the sum of the ranks' bands."""
    N = X.shape[0]
    kern = _comm.replicate_tree(mesh, kernel)
    Xr = _comm.replicate(mesh, X)
    Xb = _band(mesh, Xr)
    fused = fused_stationary_matvec(kern, Xr, Xb)
    rows = Xb.shape[0]
    bs = rows if block_size is None else block_size

    def block(xb, V2):
        return kern.gram(xb, Xr) @ V2

    def matvec(V):
        vec = V.ndim == 1
        V2 = V[:, None] if vec else V
        Vr = _comm.replicate(mesh, V2)
        band = fused(Vr) if fused is not None else None
        if band is not None:
            stats["matvec_fused"] += 1
        else:
            stats["matvec_plain"] += 1
            if torch.is_grad_enabled() and bs < rows:
                band = torch.cat([checkpoint(block, Xb[i:i + bs], Vr, use_reentrant=False)
                                  for i in range(0, rows, bs)])
            else:
                band = torch.cat([block(Xb[i:i + bs], Vr) for i in range(0, rows, bs)])
        out = _comm.gather_rows(mesh, band)[:N] + noise_apply(V2)
        return out[:, 0] if vec else out

    return matvec


class CGPosterior:
    """Exact posterior through CG solves: α = (K + Σ)⁻¹(y − m) at build,
    and one block solve against K(x, x*) for each variance or covariance.

    With more than ``config.matvec_fused_max_rhs`` test points a solve takes
    the Gram block path even on the card (the JAX package's design: there
    one Gram serves every column); 32 test points or fewer go through the
    fused kernel.  ``mesh`` splits every solve's products over its ranks
    (:func:`kernel_matvec`)."""

    def __init__(self, fx: FiniteGP, y, tol=1e-6, maxiter=1000, block_size=None,
                 precond_rank: int = 0, mesh=None):
        self.fx = fx
        self.prior = fx.f
        self.x = as_points(fx.x)
        self._matvec = kernel_matvec(fx.f.kernel, fx.x, fx.noise, block_size, mesh=mesh)
        self._tol = tol
        self._maxiter = maxiter
        if precond_rank > 0:
            Lk = pivoted_cholesky(fx.f.kernel, fx.x, precond_rank)
            self._M_inv = woodbury_preconditioner(Lk, fx.noise)
        else:
            self._M_inv = None
        delta = y - fx.mean()
        self.alpha = cg_solve(self._matvec, delta, tol, maxiter, M_inv=self._M_inv)
        self.delta = delta

    def mean(self, xs):
        return self.prior.mean(xs) + self.prior.cov(self.x, xs).T @ self.alpha

    def _solved_cross(self, xs):
        Kxs = self.prior.cov(self.x, xs)  # (N, N*)
        return Kxs, cg_solve(self._matvec, Kxs, self._tol, self._maxiter, M_inv=self._M_inv)

    def cov(self, xs, zs=None):
        Kxs, V = self._solved_cross(xs)
        if zs is None:
            return self.prior.cov(xs) - Kxs.T @ V
        return self.prior.cov(xs, zs) - V.T @ self.prior.cov(self.x, zs)

    def var(self, xs):
        Kxs, V = self._solved_cross(xs)
        return self.prior.var(xs) - torch.sum(Kxs * V, dim=0)

    def mean_and_var(self, xs):
        Kxs, V = self._solved_cross(xs)
        mu = self.prior.mean(xs) + Kxs.T @ self.alpha
        return mu, self.prior.var(xs) - torch.sum(Kxs * V, dim=0)

    def mean_and_cov(self, xs):
        Kxs, V = self._solved_cross(xs)
        mu = self.prior.mean(xs) + Kxs.T @ self.alpha
        return mu, self.prior.cov(xs) - Kxs.T @ V


def posterior_cg(fx: FiniteGP, y, tol=1e-8, maxiter=1000, block_size=None,
                 precond_rank: int = 0, mesh=None) -> CGPosterior:
    """Exact GP regression posterior through conjugate gradients;
    ``precond_rank > 0`` preconditions every solve with the
    pivoted-Cholesky/Woodbury P (Gardner et al. 2018 §3.2); ``mesh`` splits
    every product's rows over its ranks (:func:`kernel_matvec`)."""
    return CGPosterior(fx, y, tol=tol, maxiter=maxiter, block_size=block_size,
                       precond_rank=precond_rank, mesh=mesh)


def _lanczos_block(matvec, V0, num_iters):
    """R independent one-step Lanczos recurrences, column-blocked: V0 (n, R)
    → (alphas (m, R), betas (m−1, R)).  The matvec sees a real (n, R)
    block, so the probes ride the fused kernel together."""
    norms = torch.linalg.vector_norm(V0, dim=0)
    V = V0 / torch.where(norms == 0, 1.0, norms)
    V_prev = torch.zeros_like(V)
    beta_prev = V.new_zeros((V.shape[1],))
    alphas, betas = [], []
    for _ in range(num_iters):
        W = matvec(V) - beta_prev * V_prev
        alpha = torch.sum(W * V, dim=0)
        W = W - alpha * V
        beta = torch.linalg.vector_norm(W, dim=0)
        V_prev, V = V, W / torch.where(beta == 0, 1.0, beta)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def _slq_quadrature(alphas, betas, n, ritz_floor):
    """Mean Gauss quadrature over probe columns: alphas (m, R), betas
    (m−1, R) → the mean of the per-probe n·e₁ᵀ log(T) e₁."""
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1)
         + torch.diag_embed(betas.T, -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=ritz_floor)
    tau = evecs[:, 0, :] ** 2
    return torch.mean(torch.sum(tau * torch.log(evals), dim=-1) * n)


def _lanczos_basis(matvec, v0, num_iters):
    """Fully reorthogonalized Lanczos keeping the basis: (Q (n, m), alphas
    (m,), betas (m−1,)) with QᵀAQ = T and Q[:, 0] = v0/‖v0‖; two
    Gram-Schmidt passes against the stored basis a step.

    A block v0 (n, S) runs S independent recurrences, each column against
    its own basis, with one (n, S) product a step: (Q (S, n, m), alphas
    (m, S), betas (m−1, S))."""
    vec = v0.ndim == 1
    V = v0[:, None] if vec else v0
    n, S = V.shape
    m = num_iters
    V = V / torch.linalg.vector_norm(V, dim=0)
    Q = V.new_zeros((S, n, m))
    Q[:, :, 0] = V.T
    V_prev = torch.zeros_like(V)
    beta_prev = V.new_zeros((S,))
    alphas, betas = [], []
    for i in range(m):
        Wb = (matvec(V[:, 0])[:, None] if vec else matvec(V)) - beta_prev * V_prev
        alpha = torch.sum(Wb * V, dim=0)
        Wb = Wb - alpha * V
        # columns past i are zero, so the products over all of Q are exact
        for _ in range(2):
            Wb = Wb - torch.einsum("snm,sm->ns", Q, torch.einsum("snm,ns->sm", Q, Wb))
        beta = torch.linalg.vector_norm(Wb, dim=0)
        V_prev, V = V, Wb / torch.where(beta == 0, 1.0, beta)
        beta_prev = beta
        if i + 1 < m:
            Q[:, :, i + 1] = V.T
        alphas.append(alpha)
        betas.append(beta)
    alphas, betas = torch.stack(alphas), torch.stack(betas)[:-1]
    if vec:
        return Q[0], alphas[:, 0], betas[:, 0]
    return Q, alphas, betas


def msqrt_matvec(matvec, b, num_iters: int = 30):
    """A^{1/2} b by the Lanczos matrix function (Pleiss et al. 2020, arXiv
    2006.11267): with T = QᵀAQ = VΛVᵀ,

        A^{1/2} b ≈ ‖b‖ · Q V Λ^{1/2} Vᵀ e₁,

    ``num_iters`` products and no factorization.  A block b (n, S) takes
    each column's own recurrence, the S columns in one (n, S) product a
    step."""
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    Q, alphas, betas = _lanczos_basis(matvec, B, num_iters)  # Q (S, n, m)
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1)
         + torch.diag_embed(betas.T, -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=0.0)
    w = torch.einsum("smk,sk->sm", evecs, torch.sqrt(evals) * evecs[:, 0, :])
    out = torch.linalg.vector_norm(B, dim=0) * torch.einsum("snm,sm->ns", Q, w)
    return out[:, 0] if vec else out


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a new one on ``device`` seeded by the int."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device or "cpu").manual_seed(int(generator))


def sample_prior_msqrt(generator, kernel, x, noise, num_samples: int, lanczos_iters: int = 30,
                       block_size: int | None = None) -> torch.Tensor:
    """``num_samples`` draws (num_samples, N) from N(0, K(x, x) + Σ) by the
    Lanczos square root: the prior's covariance exactly (no feature
    truncation), K never factored.  The standard normals Z (num_samples, N)
    come from ``generator`` (a ``torch.Generator`` or an int seed for a new
    one on x's device); the samples' recurrences run as one (N, S) block,
    so each Lanczos step is one product (row 5 at R = S on the card)."""
    X = as_points(x)
    Z = standard_normals(_generator(generator, X.device), (num_samples, X.shape[0]), X)
    return msqrt_matvec(kernel_matvec(kernel, X, noise, block_size), Z.T, lanczos_iters).T


def sample_posterior_msqrt(generator, fx: FiniteGP, y: torch.Tensor, xs, num_samples: int,
                           lanczos_iters: int = 30, tol: float = 1e-8, maxiter: int = 1000,
                           block_size: int | None = None,
                           precond_rank: int = 0) -> torch.Tensor:
    """Posterior samples (num_samples, N*) at ``xs`` by Matheron's rule,
    the prior path drawn jointly over [train; test] by the Lanczos square
    root:

        f* = f_prior(x*) + K(x*, X)(K + σ²I)⁻¹(y − f_prior(X) − ε),
        ε ~ N(0, σ²I),

    every sample's solve in one (preconditioned) block CG.  From
    ``generator``: the joint prior's normals (num_samples, N + N*), then
    ε's (num_samples, N).  Isotropic noise only."""
    prior = fx.f
    X = as_points(fx.x)
    Xs = as_points(xs)
    N = X.shape[0]
    noise = torch.as_tensor(fx.noise, dtype=X.dtype, device=X.device)
    if noise.ndim != 0:
        raise ValueError("sample_posterior_msqrt requires isotropic noise")
    gen = _generator(generator, X.device)
    # the joint prior sample over train and test points, a tiny jitter for PSD-ness
    eps_j = 1e-6 if X.dtype == torch.float32 else 1e-12
    joint = sample_prior_msqrt(gen, prior.kernel, torch.cat([X, Xs]), eps_j, num_samples,
                               lanczos_iters, block_size)
    fX, fS = joint[:, :N], joint[:, N:]
    eps = torch.sqrt(noise) * standard_normals(gen, fX.shape, X)
    resid = y[None, :] - fX - eps  # (S, N)
    mv = kernel_matvec(prior.kernel, X, noise, block_size)
    M_inv = None
    if precond_rank > 0:
        M_inv = woodbury_preconditioner(pivoted_cholesky(prior.kernel, X, precond_rank), noise)
    V = cg_solve(mv, resid.T, tol=tol, maxiter=maxiter, M_inv=M_inv)  # (N, S)
    return fS + V.T @ prior.cov(X, Xs)


def _precond_sqrt_ops(Lk: torch.Tensor, sigma2):
    """``P^{±1/2}`` applications and the exact ``logdet P`` for
    P = σ²I + Lk Lkᵀ, by the r × r Gram: LkᵀLk = V D Vᵀ gives orthonormal
    U = Lk V D^{−1/2}, P = σ²I + U D Uᵀ, so

        P^{±1/2} = σ^{±1} I + U diag((σ² + D)^{±1/2} − σ^{±1}) Uᵀ,
        logdet P = N log σ² + Σ_live log1p(D_i / σ²).

    Directions with D at rounding level are exact identity directions."""
    N, r = Lk.shape
    D, V = torch.linalg.eigh(Lk.T @ Lk)
    D = torch.clamp(D, min=0.0)
    live = D > r * torch.finfo(Lk.dtype).eps * torch.clamp(torch.max(D), min=1.0)
    U = (Lk @ V) / torch.sqrt(torch.where(live, D, 1.0)) * live.to(Lk.dtype)
    s2 = torch.as_tensor(sigma2, dtype=Lk.dtype, device=Lk.device)
    lam = s2 + torch.where(live, D, 0.0)  # P's eigenvalues on span(U)

    def apply_half(v, sign):
        scale = lam ** (0.5 * sign) - s2 ** (0.5 * sign)
        w = U.T @ v
        return s2 ** (0.5 * sign) * v + U @ (scale * w if v.ndim == 1 else scale[:, None] * w)

    logdetP = N * torch.log(s2) + torch.sum(torch.where(live, torch.log1p(D / s2), 0.0))
    return apply_half, logdetP


def _slq_minv(Lk, noise):
    return None if Lk is None else woodbury_preconditioner(Lk, noise)


def rademacher_probes(generator, num_probes: int, n: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(num_probes, n) Rademacher signs from ``generator`` (a
    ``torch.Generator`` or an int seed for a new one on ``device``).  The
    JAX package's ``jax.random.rademacher`` bits cannot be reproduced: tests
    make probes with numpy and pass them in."""
    generator = _generator(generator, device)
    bits = torch.randint(0, 2, (num_probes, n), generator=generator, device=generator.device)
    return (2 * bits - 1).to(dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class _SLQOptions:
    lanczos_iters: int
    cg_tol: float
    cg_maxiter: int
    block_size: int | None
    reorth: bool
    precond_logdet: bool
    precond_fresh: bool
    mesh: object = None


def _tree(obj):
    """The floating tensors in a tree of dataclasses, and a function that
    rebuilds the tree with other tensors in their places."""
    leaves = []
    _comm.map_tensors(lambda t: leaves.append(t) if t.is_floating_point() else None, obj)

    def build(new):
        it = iter(new)
        return _comm.map_tensors(lambda t: next(it) if t.is_floating_point() else t, obj)

    return leaves, build


def _slq_value(opts: _SLQOptions, fx, y, probes, Lk):
    n = len(fx)
    matvec = kernel_matvec(fx.f.kernel, fx.x, fx.noise, opts.block_size, opts.mesh)
    delta = y - fx.mean()
    alpha = cg_solve(matvec, delta, opts.cg_tol, opts.cg_maxiter, M_inv=_slq_minv(Lk, fx.noise))
    quad = delta @ alpha

    # preconditioned quadrature: SLQ on C = P^{−1/2} K̂ P^{−1/2}, plus the
    # exact logdet P
    logdet0 = probes.new_zeros(())
    quad_mv = matvec
    ritz_floor = 1e-30  # raw operator: Ritz values are garbage only below 0
    if opts.precond_logdet and Lk is not None:
        apply_half, logdet0 = _precond_sqrt_ops(Lk, fx.noise)
        quad_mv = lambda v: apply_half(matvec(apply_half(v, -1)), -1)  # noqa: E731
        # a fresh factor makes C ⪰ I exactly (K − LLᵀ is PSD), so a Ritz
        # value below 1 is rounding; a carried factor may be stale, and then
        # C's sub-1 eigenvalues are real, and only sub-eps ones are noise
        ritz_floor = 1.0 if opts.precond_fresh else torch.finfo(probes.dtype).eps

    if opts.reorth:
        _, alphas, betas = _lanczos_basis(quad_mv, probes.T, opts.lanczos_iters)
    else:
        alphas, betas = _lanczos_block(quad_mv, probes.T, opts.lanczos_iters)
    logdet = logdet0 + _slq_quadrature(alphas, betas, n, ritz_floor)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def _surrogate(opts: _SLQOptions, fx, y, probes, alpha, W):
    """Equal to the log marginal likelihood in value at the evaluation
    point, with the stochastic-trace gradient (α and W = K̂⁻¹Z frozen):
    2αᵀδ(θ) − αᵀK̂(θ)α and mean_p w_pᵀK̂(θ)z_p."""
    mv = kernel_matvec(fx.f.kernel, fx.x, fx.noise, opts.block_size, opts.mesh)
    delta = y - fx.mean()
    quad_sur = 2.0 * (alpha @ delta) - alpha @ mv(alpha)
    trace_sur = torch.mean(torch.sum(W * mv(probes.T), dim=0))
    return -0.5 * (quad_sur + trace_sur + delta.shape[0] * math.log(2.0 * math.pi))


class _LogpdfSLQ(torch.autograd.Function):
    """Value by CG and SLQ; gradient by the surrogate.  The forward keeps
    only its inputs: the backward solves for α and W again and reaches the
    hyperparameters inside the kernel objects through the rebuilt FiniteGP.
    The preconditioner factor gets a zero cotangent."""

    @staticmethod
    def forward(ctx, opts, build, y, probes, Lk, *leaves):
        ctx.opts, ctx.build, ctx.Lk = opts, build, Lk
        ctx.save_for_backward(y, probes, *leaves)
        return _slq_value(opts, build(leaves), y, probes, Lk)

    @staticmethod
    def backward(ctx, ct):
        y, probes, *leaves = ctx.saved_tensors
        opts, build, Lk = ctx.opts, ctx.build, ctx.Lk
        need_y, need_p, need_Lk = ctx.needs_input_grad[2:5]
        with torch.no_grad():
            fx = build(leaves)
            matvec = kernel_matvec(fx.f.kernel, fx.x, fx.noise, opts.block_size, opts.mesh)
            M_inv = _slq_minv(Lk, fx.noise)
            alpha = cg_solve(matvec, y - fx.mean(), opts.cg_tol, opts.cg_maxiter, M_inv=M_inv)
            W = cg_solve(matvec, probes.T, opts.cg_tol, opts.cg_maxiter, M_inv=M_inv)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(bool(need))
                   for t, need in zip((y, probes, *leaves), (need_y, need_p,
                                                             *ctx.needs_input_grad[5:]))]
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(())
            if wanted:
                sur = _surrogate(opts, build(ins[2:]), ins[0], ins[1], alpha, W)
                grads = iter(torch.autograd.grad(sur, wanted, ct, allow_unused=True))
        out = [next(grads) if t.requires_grad else None for t in ins]
        dLk = torch.zeros_like(Lk) if need_Lk else None
        return (None, None, out[0], out[1], dLk, *out[2:])


def logpdf_slq(
    fx: FiniteGP,
    y: torch.Tensor,
    generator=None,
    num_probes: int = 16,
    lanczos_iters: int = 30,
    cg_tol: float = 1e-8,
    cg_maxiter: int = 1000,
    block_size: int | None = None,
    reorth: bool = False,
    precond_rank: int = 0,
    precond_Lk: torch.Tensor | None = None,
    precond_logdet: bool = True,
    probes: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Exact log marginal likelihood with the logdet by stochastic Lanczos
    quadrature over Rademacher probes, differentiable in the kernel's
    hyperparameters, the inputs, the noise and the targets through the
    stochastic-trace estimator (Gardner et al. 2018 §2.2), with the same
    probes as the value.

    The probes come from ``generator`` (a ``torch.Generator`` or an int
    seed) or are given as ``probes`` (num_probes, n).  ``precond_rank > 0``
    preconditions the CG solves with a fresh pivoted-Cholesky/Woodbury P
    and, with ``precond_logdet``, runs SLQ on P^{−1/2} K̂ P^{−1/2} and adds
    logdet P in closed form; ``precond_Lk`` passes a carried factor
    instead, whose Ritz floor is eps rather than 1 (it may be stale).

    ``mesh`` splits every product's rows over its ranks
    (:func:`kernel_matvec`); probes drawn here are rank 0's on every rank,
    and the gradient is the same on every rank."""
    n = len(fx)
    dtype = torch.promote_types(y.dtype, torch.float32)
    if probes is None:
        if generator is None:
            raise ValueError("logpdf_slq needs a generator (or seed) or the probes")
        probes = rademacher_probes(generator, num_probes, n, dtype, y.device)
        if mesh is not None:
            probes = _comm.broadcast(mesh, probes)
    probes = probes.to(dtype=dtype, device=y.device)
    Lk = precond_Lk
    precond_fresh = precond_Lk is None
    if Lk is None and precond_rank > 0:
        Lk = pivoted_cholesky(fx.f.kernel, as_points(fx.x), precond_rank)
    if Lk is not None:
        Lk = Lk.detach()
    opts = _SLQOptions(lanczos_iters, cg_tol, cg_maxiter, block_size, bool(reorth),
                       bool(precond_logdet), precond_fresh, mesh)
    leaves, build = _tree(fx)
    return _LogpdfSLQ.apply(opts, build, y, probes, Lk, *leaves)
