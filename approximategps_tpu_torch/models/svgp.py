"""Sparse variational GP (port of ``approximategps_tpu/models/svgp.py``, the
serving path: the posterior build and the mean/variance sweep).

Semantics are those of the JAX package: the posterior cache ``(Kuu_L, B, α)``
plus, under ``solve_mode="inv_matmul"``, ``Lk⁻¹`` and the S-correction
``S = Lk⁻ᵀ(BBᵀ−I)Lk⁻¹``.  Two hand-written kernels carry the NonCentered
path: ``ops.panel_chol.gram_chol_inv`` builds (L, L⁻¹) with the Kuu Gram
generated inside it, and ``ops.svgp_epilogue.svgp_data_epilogue`` serves
(mean, var) blocks without the (M, B) cross-covariance in device memory.

No autograd yet: the posterior build and the sweep run under
``torch.no_grad()``; the training step's custom-gradient composites come
with its port.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import config, kernel_device, kernels_take, resolve_solve_mode
from ..core import linalg
from ..core.distributions import MultivariateNormal
from ..core.gp import AbstractGP, FiniteGP
from ..core.kernels import as_points, unwrap_stationary
from ..ops.panel_chol import gram_chol_inv, gram_chol_inv_supported
from ..ops.svgp_epilogue import epilogue_block_b, svgp_data_epilogue
from .api import posterior

__all__ = [
    "Centered",
    "NonCentered",
    "SparseVariationalApproximation",
    "SVGPPosterior",
]


class _Parametrization:
    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return f"{type(self).__name__}()"


class Centered(_Parametrization):
    """Unwhitened: ``q`` is the approximate posterior over the pseudo-points."""


class NonCentered(_Parametrization):
    """Whitened: ``q`` is over ``cholesky(cov(u)).L \\ (u - mean(u))``."""


@dataclasses.dataclass(frozen=True, eq=False)
class SparseVariationalApproximation:
    """The inducing-point prior ``fz = f(z, jitter)`` and the variational
    distribution ``q``; NonCentered by default."""

    fz: FiniteGP
    q: MultivariateNormal
    parametrization: _Parametrization = dataclasses.field(default_factory=NonCentered)


@dataclasses.dataclass(frozen=True, eq=False)
class _SVGPCache:
    """Posterior data cache; ``Lk_inv`` and ``S_corr`` exist under
    ``solve_mode="inv_matmul"``."""

    Kuu_L: torch.Tensor
    B: torch.Tensor
    alpha: torch.Tensor
    Lk_inv: torch.Tensor | None = None
    S_corr: torch.Tensor | None = None


def _scaled(x: torch.Tensor, scale) -> torch.Tensor:
    if scale is None:
        return x
    s = scale.to(dtype=x.dtype)
    return x * (s if s.ndim == 0 else s.to(x.device))


@dataclasses.dataclass(frozen=True, eq=False)
class SVGPPosterior(AbstractGP):
    """The SVGP posterior GP with the prediction methods of the reference."""

    approx: SparseVariationalApproximation
    cache: _SVGPCache

    @property
    def prior(self) -> AbstractGP:
        return self.approx.fz.f

    def inducing_points(self) -> torch.Tensor:
        return self.approx.fz.x

    def _A_and_Kuf(self, x):
        """A = Lk⁻¹ Kuf, the projection, and Kuf."""
        Kuf = self.prior.cov(self.inducing_points(), x)
        if self.cache.Lk_inv is not None:
            A = self.cache.Lk_inv @ Kuf
        else:
            A = torch.linalg.solve_triangular(self.cache.Kuu_L, Kuf, upper=False)
        return A, Kuf

    def _BtA(self, A):
        return self.cache.B.T @ A

    def mean(self, x):
        Kuf = self.prior.cov(self.inducing_points(), x)
        return self.prior.mean(x) + Kuf.T @ self.cache.alpha

    def _var_via_S(self, x, Kuf=None):
        """prior.var + diag(Kufᵀ S Kuf): the single-projection variance."""
        if Kuf is None:
            Kuf = self.prior.cov(self.inducing_points(), x)
        return self.prior.var(x) + linalg.diag_quad_sym(self.cache.S_corr, Kuf), Kuf

    def _var_via_A(self, A):
        return torch.sum(self._BtA(A) ** 2, dim=0) - torch.sum(A * A, dim=0)

    def var(self, x):
        if self.cache.S_corr is not None:
            return self._var_via_S(x)[0]
        A, _ = self._A_and_Kuf(x)
        return self.prior.var(x) + self._var_via_A(A)

    def mean_and_var(self, x):
        if self.cache.S_corr is not None:
            v, Kuf = self._var_via_S(x)
        else:
            A, Kuf = self._A_and_Kuf(x)
            v = self.prior.var(x) + self._var_via_A(A)
        return self.prior.mean(x) + Kuf.T @ self.cache.alpha, v

    @torch.no_grad()
    def predict_blocks(self, xs, block_size: int = 16384):
        """(mean, var) over a large test set, ``block_size`` points at a
        time, each block through the fused epilogue kernel when it applies
        (the S-correction cache exists and the kernel unwraps) and through
        :meth:`mean_and_var` otherwise.  The last block may be ragged."""
        X = as_points(xs)
        operands = _epilogue_operands(
            self.prior, self.inducing_points(), self.cache.alpha, self.cache.S_corr
        )
        mus, variances = [], []
        for start in range(0, X.shape[0], block_size):
            block = X[start:start + block_size]
            if operands is not None:
                mu, var = _epilogue_mu_var(self.prior, block, operands)
            else:
                mu, var = self.mean_and_var(block)
            mus.append(mu)
            variances.append(var)
        return torch.cat(mus), torch.cat(variances)


def _s_corr(J, B):
    """S = Jᵀ(BBᵀ − I)J, symmetrized: the epilogue kernel reads only its
    upper triangle, the plain routes all of it, so both must see one
    exactly symmetric matrix."""
    C0 = B @ B.T - torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return linalg.symmetrize(J.T @ (C0 @ J))


def _cache_tail(J, Lq, m):
    """(α, S) from J = Lk⁻¹: α = Jᵀm, S = Jᵀ(LqLqᵀ − I)J."""
    return J.T @ m, _s_corr(J, Lq)


def _gram_chol_parts(fz: FiniteGP, like: torch.Tensor):
    """Dispatch test for the gram-fused posterior build: kernels allowed for
    ``like``'s device and dtype, isotropic jitter, a prior kernel that
    unwraps to ``σ²·g(r²(s·z))``, and a shape the kernel takes.  Returns
    ``((kmap, scale, variance), z_points)`` or None."""
    if (
        not kernels_take(like)
        or config.gram_chol == "off"
        or config.chol_mode == "plain"
        or torch.as_tensor(fz.noise).ndim != 0
    ):
        return None
    kernel = getattr(fz.f, "kernel", None)
    parts = None if kernel is None else unwrap_stationary(kernel)
    if parts is None:
        return None
    zp = as_points(fz.x)
    if not gram_chol_inv_supported(zp.shape[0], zp.shape[1], like.dtype):
        return None
    return parts, zp


@posterior.register(SparseVariationalApproximation)
@torch.no_grad()
def _posterior_svgp(sva: SparseVariationalApproximation) -> SVGPPosterior:
    """posterior(sva): the SVGP posterior cache (reference ``:115-136``
    Centered, ``:160-187`` NonCentered).  The three-argument consistency
    form is not ported yet."""
    q, fz = sva.q, sva.fz
    m = q.mean
    M = m.shape[-1]
    # only the lower triangle of scale_tril is read, on every path
    qL = torch.tril(q.scale_tril)
    solve_mode = resolve_solve_mode(m, size=M)
    use_s_corr = M <= config.s_corr_max_m
    centered = isinstance(sva.parametrization, Centered)
    if solve_mode == "inv_matmul" and use_s_corr and not centered:
        gparts = _gram_chol_parts(fz, m)
        if gparts is not None:
            # the Kuu Gram is generated inside the (L, L⁻¹) kernel
            (kmap, scale, variance), zp = gparts
            Zs = _scaled(zp, scale).to(m.dtype)
            v2 = 1.0 if variance is None else variance
            Kuu_L, Lk_inv = gram_chol_inv(Zs, v2, fz.noise, kmap)
        else:
            Kuu_L, Lk_inv = linalg.chol_with_inv(fz.cov())
        alpha, S_corr = _cache_tail(Lk_inv, qL, m)
        return SVGPPosterior(sva, _SVGPCache(Kuu_L, qL, alpha, Lk_inv, S_corr))
    if solve_mode == "inv_matmul":
        Kuu_L, Lk_inv = linalg.chol_with_inv(fz.cov())
    else:
        Kuu_L, Lk_inv = fz.scale_tril(), None
    if centered:
        # B = Lk⁻¹ Lq ; α = Kuu⁻¹ (m − mean(fz))
        delta = m - fz.mean()
        if Lk_inv is not None:
            B = Lk_inv @ qL
            alpha = Lk_inv.T @ (Lk_inv @ delta)
        else:
            B = torch.linalg.solve_triangular(Kuu_L, qL, upper=False)
            alpha = torch.cholesky_solve(delta[:, None], Kuu_L)[:, 0]
    else:
        # NonCentered: α = Lk⁻ᵀ m ; B = Lq
        if Lk_inv is not None:
            alpha = Lk_inv.T @ m
        else:
            alpha = torch.linalg.solve_triangular(Kuu_L.T, m[:, None], upper=True)[:, 0]
        B = qL
    S_corr = _s_corr(Lk_inv, B) if Lk_inv is not None and use_s_corr else None
    return SVGPPosterior(sva, _SVGPCache(Kuu_L, B, alpha, Lk_inv, S_corr))


def _epilogue_ready(prior, z, S_corr):
    """Dispatch test for the fused data-term epilogue: the
    ``unwrap_stationary`` parts if it will be used, else None.

    None means :meth:`SVGPPosterior.mean_and_var` serves the sweep: no
    S-correction cache, kernels off, ``data_term_mode="plain"``, or a CPU
    tensor the epilogue does not take.  On the kernel device a prior or a
    shape the kernel does not take raises instead."""
    if config.data_term_mode == "plain" or S_corr is None or not kernels_take(S_corr):
        return None
    on_device = kernel_device(S_corr)
    kernel = getattr(prior, "kernel", None)
    parts = None if kernel is None else unwrap_stationary(kernel)
    if parts is None:
        if on_device:
            raise NotImplementedError(
                "the fused SVGP epilogue takes only a stationary kernel that "
                "unwraps to σ²·g(r²(s·x)); set data_term_mode='plain' to serve "
                "this prior through mean_and_var"
            )
        return None
    zp = as_points(z)
    if epilogue_block_b(zp.shape[0], zp.shape[1], S_corr.dtype) is None:
        if on_device:
            raise NotImplementedError(
                f"the fused SVGP epilogue has no tiling over M yet (ROADMAP.md §2, "
                f"row 2): its (block_b, M) K0 tile does not fit shared memory at "
                f"M={zp.shape[0]}, D={zp.shape[1]}, {S_corr.dtype}, block_b <= "
                f"{config.epilogue_block_b}; set data_term_mode='plain'"
            )
        return None
    return parts


def _epilogue_operands(prior, z, alpha, S_corr):
    """``(kmap, scale, Zs, Se, ae)`` for :func:`_epilogue_mu_var`, or None.

    With K = σ²·K0: ``mu = m(x) + K0ᵀ(σ²α)`` and
    ``var = prior.var + diag(K0ᵀ (σ⁴S) K0)``, so the kernel takes
    ``ae = σ²α``, ``Se = σ⁴S`` and inputs scaled by ``s``.  Formed once per
    sweep."""
    parts = _epilogue_ready(prior, z, S_corr)
    if parts is None:
        return None
    kmap, scale, variance = parts
    Zs = _scaled(as_points(z), scale)
    if variance is None:
        Se, ae = S_corr, alpha
    else:
        v = variance.to(dtype=S_corr.dtype)
        Se, ae = S_corr * (v * v), alpha * v
    return kmap, scale, Zs, Se, ae


def _epilogue_mu_var(prior, x, operands):
    """(mu, var) of one block through the fused epilogue."""
    kmap, scale, Zs, Se, ae = operands
    Xs = _scaled(as_points(x), scale)
    mu_corr, var_corr = svgp_data_epilogue(Xs, Zs, Se, ae, kmap)
    return prior.mean(x) + mu_corr, prior.var(x) + var_corr
