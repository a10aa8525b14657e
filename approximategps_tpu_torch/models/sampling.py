"""Pathwise (decoupled) posterior function sampling (port of
``approximategps_tpu/models/sampling.py``; Wilson et al. 2020, "Efficiently
Sampling Functions from Gaussian Process Posteriors"):

    f_post(·) = f_prior(·) + K(·, Z) Kuu⁻¹ (u − f_prior(Z)),   u ~ q(u),

the prior path by random Fourier features, f_prior(x) ≈ Σᵢ wᵢ φᵢ(x) with
φᵢ(x) = √(2σ²/F) cos(ωᵢᵀx̃ + bᵢ), ω drawn from the kernel's spectral
density and x̃ the lengthscale-scaled input.  SE and Matérn-1/2, 3/2, 5/2
bases, in variance and lengthscale wrappers (``core.kernels.unwrap_spectral``).

Each sampler is two steps: a draw step that takes a ``torch.Generator`` (or
an int seed) and returns tensors (:func:`draw_rff`, :func:`draw_svgp`,
:func:`draw_cg`), and a deterministic pathwise part that takes the draws
(:func:`rff_map`, :func:`svgp_pathwise`, :func:`cg_pathwise`), so that the
same numbers can go through both packages.  The draws' order from the
generator: ω's normals, for a Matérn the χ²_ν normals (ν of them a feature:
χ²_ν is the sum of ν squared normals, the law of JAX's 2·gamma(ν/2)), b's
uniforms, then w, then u's normals or ε's.

On the card the CG sampler's block solve goes through ``kernel_matvec``
(row 5's wide pass at R = S) and so does its update K(x, X)·V (row 5, the
cross product, in place of the JAX package's N × N_x Gram and matmul); the
SVGP sampler's cross-Gram K(x, Z) takes row 11 under ``gram_mode="fused"``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core import linalg
from ..core.distributions import standard_normals
from ..core.gp import FiniteGP
from ..core.kernels import _param, as_points, unwrap_spectral
from ..ops.gram_matvec import fused_stationary_matvec
from .iterative import _generator, cg_solve, kernel_matvec, pivoted_cholesky, \
    woodbury_preconditioner
from .svgp import Centered, SVGPPosterior

__all__ = [
    "RFFDraws",
    "draw_rff",
    "rff_map",
    "rff_features",
    "draw_svgp",
    "svgp_pathwise",
    "sample_svgp_functions",
    "draw_cg",
    "cg_pathwise",
    "sample_posterior_functions_cg",
]


class RFFDraws(NamedTuple):
    """The random numbers of a feature map: ω (F, D), already divided by
    √(g/ν) for a Matérn, and the phases b (F,)."""

    omega: torch.Tensor
    b: torch.Tensor


def draw_rff(generator, kernel, D: int, num_features: int, dtype=torch.float32,
             device=None) -> RFFDraws:
    """ω from the kernel's spectral density (a standard normal for SE; for a
    Matérn-ν/2, z·√(ν/g) with z normal and g ~ χ²_ν) and b ~ U[0, 2π), from
    ``generator`` (a ``torch.Generator``, or an int seed for a new one on
    ``device``, the card by default), returned on ``device`` (the
    generator's by default)."""
    if not isinstance(generator, torch.Generator) and device is None:
        device = "cuda"
    gen = _generator(generator, device)
    device = gen.device if device is None else torch.device(device)
    df, _, _ = unwrap_spectral(kernel)
    like = torch.empty((), dtype=dtype, device=device)
    omega = standard_normals(gen, (num_features, D), like)
    if df is not None:
        g = torch.sum(standard_normals(gen, (num_features, df), like) ** 2, dim=1, keepdim=True)
        omega = omega * torch.sqrt(df / g)
    u = torch.rand((num_features,), generator=gen, dtype=dtype, device=gen.device)
    return RFFDraws(omega, (2.0 * math.pi * u).to(device))


def rff_map(kernel, draws: RFFDraws) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic feature map of ``draws``: ``phi(x) -> (N, F)`` with
    E[φφᵀ] ≈ K, φ(x) = √(2σ²/F) cos((s·x) ωᵀ + b)."""
    _, scale, variance = unwrap_spectral(kernel)
    omega, b = draws
    F = omega.shape[0]

    def phi(x: torch.Tensor) -> torch.Tensor:
        X = as_points(x)
        proj = (X * _param(scale, X)) @ omega.T + b[None, :]
        return torch.sqrt(2.0 * _param(variance, X) / F) * torch.cos(proj)

    return phi


def rff_features(generator, kernel, D: int, num_features: int, dtype=torch.float32,
                 device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Random Fourier feature map φ for a (wrapped) stationary kernel:
    ``phi(x) -> (N, num_features)`` with E[φφᵀ] ≈ K (:func:`draw_rff`, then
    :func:`rff_map`)."""
    return rff_map(kernel, draw_rff(generator, kernel, D, num_features, dtype, device))


def draw_svgp(generator, post: SVGPPosterior, num_samples: int, num_features: int = 1024):
    """The draws of :func:`sample_svgp_functions`: (ω and b, w (S, F), the
    normals of u (S, M)), in the inducing points' dtype and on their
    device."""
    Z = as_points(post.approx.fz.x)
    M, D = Z.shape
    gen = _generator(generator, Z.device)
    rff = draw_rff(gen, post.prior.kernel, D, num_features, Z.dtype, Z.device)
    w = standard_normals(gen, (num_samples, num_features), Z)
    eps = standard_normals(gen, (num_samples, M), Z)
    return rff, w, eps


def svgp_pathwise(post: SVGPPosterior, rff: RFFDraws, w: torch.Tensor,
                  eps: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic part of :func:`sample_svgp_functions`: with
    u = m + Lq ε (Centered) or u = μ(z) + Lk (m + Lq ε) (NonCentered, q
    over the whitened ε), α = Kuu⁻¹(u − μ(z) − w φ(Z)ᵀ) and

        fs(x) = μ(x) + w φ(x)ᵀ + α K(x, Z)ᵀ,   (S, N)."""
    sva = post.approx
    fz = sva.fz
    prior = fz.f
    Z = as_points(fz.x)
    phi = rff_map(prior.kernel, rff)
    Lk = post.cache.Kuu_L
    v = sva.q.mean[None, :] + eps @ torch.tril(sva.q.scale_tril).T
    mz = fz.mean()
    u = v if isinstance(sva.parametrization, Centered) else mz[None, :] + v @ Lk.T
    # the RFF prior paths are zero-mean; the GP prior mean enters additively
    resid = u - mz[None, :] - w @ phi(Z).T  # (S, M)
    alpha = linalg.cholesky_solve(Lk, resid.T).T  # (S, M)

    def fs(x: torch.Tensor) -> torch.Tensor:
        X = as_points(x)
        return prior.mean(X)[None, :] + w @ phi(X).T + alpha @ prior.cov(X, Z).T

    return fs


def sample_svgp_functions(generator, post: SVGPPosterior, num_samples: int,
                          num_features: int = 1024) -> Callable[[torch.Tensor], torch.Tensor]:
    """Draw ``num_samples`` posterior functions from an SVGP posterior:
    ``fs(x) -> (num_samples, N)`` at any inputs, O(F + M) a point (Wilson et
    al. 2020, eq. 13).  ``generator``: a ``torch.Generator`` or an int seed
    (a new generator on the inducing points' device)."""
    return svgp_pathwise(post, *draw_svgp(generator, post, num_samples, num_features))


def draw_cg(generator, fx: FiniteGP, num_samples: int, num_features: int = 1024):
    """The draws of :func:`sample_posterior_functions_cg`: (ω and b, w
    (S, F), ε's unit normals (S, N)), in the data's dtype and on its
    device."""
    X = as_points(fx.x)
    N, D = X.shape
    gen = _generator(generator, X.device)
    rff = draw_rff(gen, fx.f.kernel, D, num_features, X.dtype, X.device)
    w = standard_normals(gen, (num_samples, num_features), X)
    eps = standard_normals(gen, (num_samples, N), X)
    return rff, w, eps


def _cross_update(kernel, X: torch.Tensor, Xq: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Vᵀ K(X, Xq) (S, N_x): row 5's cross product K(Xq, X)·V where the
    fused dispatch takes it, else the Gram and one matmul (the JAX
    package's route; TF32 stays off, so the product keeps full f32 — the
    update cancels the prior path almost exactly, and the JAX package found
    a reduced-precision product left prior-scale noise in the samples)."""
    fused = fused_stationary_matvec(kernel, X, Xq)
    out = None if fused is None else fused(V)
    if out is not None:
        return out.T
    return V.T @ kernel.gram(X, Xq)


def cg_pathwise(fx: FiniteGP, y: torch.Tensor, rff: RFFDraws, w: torch.Tensor,
                eps: torch.Tensor, tol: float = 1e-6, maxiter: int = 1000,
                block_size: int | None = None,
                precond_rank: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic part of :func:`sample_posterior_functions_cg`: with
    ε scaled to σ·ε, V = (K + σ²I)⁻¹(y − μ(X) − w φ(X)ᵀ − σε)ᵀ by one
    (preconditioned) block CG over the S columns, and

        fs(x) = μ(x) + w φ(x)ᵀ + Vᵀ K(X, x),   (S, N_x)."""
    prior = fx.f
    X = as_points(fx.x)
    noise = torch.as_tensor(fx.noise, dtype=X.dtype, device=X.device)
    if noise.ndim > 0:
        raise ValueError("sample_posterior_functions_cg requires isotropic noise")
    phi = rff_map(prior.kernel, rff)
    matvec = kernel_matvec(prior.kernel, X, noise, block_size)
    M_inv = None
    if precond_rank > 0:
        M_inv = woodbury_preconditioner(pivoted_cholesky(prior.kernel, X, precond_rank), noise)
    resid = y[None, :] - fx.mean()[None, :] - w @ phi(X).T - torch.sqrt(noise) * eps  # (S, N)
    V = cg_solve(matvec, resid.T, tol=tol, maxiter=maxiter, M_inv=M_inv)  # (N, S)

    def fs(x: torch.Tensor) -> torch.Tensor:
        Xq = as_points(x)
        return prior.mean(Xq)[None, :] + w @ phi(Xq).T + _cross_update(prior.kernel, X, Xq, V)

    return fs


def sample_posterior_functions_cg(
    generator,
    fx: FiniteGP,
    y: torch.Tensor,
    num_samples: int,
    num_features: int = 1024,
    tol: float = 1e-6,
    maxiter: int = 1000,
    block_size: int | None = None,
    precond_rank: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Matheron-rule pathwise samples from an exact GP posterior, the data
    update solved by (preconditioned) conjugate gradients (Wilson et al.
    2020, eq. 7):

        f_post(·) = f_prior(·) + K(·, X)(K + σ²I)⁻¹(y − f_prior(X) − ε),

    f_prior an RFF path, ε ~ N(0, σ²I), K reached only through
    ``kernel_matvec`` and every sample's solve in one block CG.  Returns
    ``fs(x) -> (num_samples, N_x)``.  Isotropic noise only."""
    return cg_pathwise(fx, y, *draw_cg(generator, fx, num_samples, num_features), tol=tol,
                       maxiter=maxiter, block_size=block_size, precond_rank=precond_rank)
