"""Sparse variational GP (port of ``approximategps_tpu/models/svgp.py``: the
posterior build, the mean/variance sweep, the prior KL and the ELBO).

Semantics are those of the JAX package: the posterior cache ``(Kuu_L, B, α)``
plus, under ``solve_mode="inv_matmul"``, ``Lk⁻¹`` and the S-correction
``S = Lk⁻ᵀ(BBᵀ−I)Lk⁻¹``.  The NonCentered build runs as one of two
``torch.autograd.Function``s with the JAX package's hand-derived,
matmul-only pullback: :class:`_WhitenedCacheFusedGram`, whose forward is the
gram-fused (L, L⁻¹) kernel ``ops.panel_chol.gram_chol_inv``, and
:class:`_WhitenedCacheFused` for a given Kuu.  The fused data-term epilogue
``ops.svgp_epilogue.svgp_data_epilogue`` serves ``predict_blocks`` and the
streaming ELBO (``prefer=True``); the minibatch ``elbo`` declines it, as the
JAX package's ``"auto"`` does.  The plain projections follow the JAX
package's storage and large-M policy: bf16 storage of the (M, B)
intermediates under ``config.compute_dtype`` (:func:`_storage_dtype`) and
the triangular-aware block products at M >= ``config.tri_matmul_min_m``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import config, kernel_device, kernels_take, resolve_solve_mode
from ..core import linalg
from ..core.distributions import MultivariateNormal, kl_divergence
from ..core.gp import AbstractGP, FiniteGP, LatentFiniteGP
from ..core.kernels import (
    _resolve_gram_mode,
    as_points,
    dk_from_k_for,
    pairwise_sq_dist,
    unwrap_stationary,
)
from ..core.likelihoods import GaussianLikelihood
from ..core.quadrature import DefaultExpectationMethod, expected_loglikelihood
from ..ops.panel_chol import gram_chol_inv, gram_chol_inv_supported
from ..ops.svgp_epilogue import epilogue_part, svgp_data_epilogue
from ..utils.profiling import named_scope
from .api import approx_lml, posterior

__all__ = [
    "Centered",
    "NonCentered",
    "SparseVariationalApproximation",
    "SVGPPosterior",
    "SVGP",
    "inducing_points",
    "elbo",
    "prior_kl",
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


def SVGP(fz: FiniteGP, q: MultivariateNormal) -> SparseVariationalApproximation:
    """Deprecated alias (the reference's ``deprecations.jl``): a Centered
    SVGP."""
    import warnings

    warnings.warn("SVGP(fz, q) is deprecated; use SparseVariationalApproximation(fz, q, "
                  "Centered())", DeprecationWarning, stacklevel=2)
    return SparseVariationalApproximation(fz, q, Centered())


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


def _storage_dtype(like: torch.Tensor, M: int | None = None):
    """bf16 storage for the (M, B) projection intermediates, or None.

    ``config.compute_dtype``: "auto" stores f32 tensors on the kernel
    device at M >= ``config.bf16_storage_min_m`` in bf16 (where the JAX
    package says "on TPU"); "bfloat16" stores f32 tensors in bf16 at any M
    and on any device; "float32" never.  f64 is never downcast, nor is the
    CPU under "auto".  Products of bf16 operands accumulate in f32 and every
    reduction is taken in f32; the master parameters, factorizations and
    KL stay f32."""
    if like.dtype != torch.float32:
        return None
    mode = config.compute_dtype
    if mode == "bfloat16":
        return torch.bfloat16
    if mode == "auto" and kernel_device(like) and M is not None \
            and M >= config.bf16_storage_min_m:
        return torch.bfloat16
    return None


def _matvec_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in at least f32, for bf16-stored operands too."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return a.to(acc) @ b.to(acc)


def _quad_corr(S: torch.Tensor, Kuf: torch.Tensor) -> torch.Tensor:
    """diag(Kufᵀ S Kuf) in at least f32, S and Kuf stored in bf16 where
    :func:`_storage_dtype` says so."""
    dt = _storage_dtype(Kuf, Kuf.shape[0])
    return linalg.diag_quad_sym(S, Kuf) if dt is None else \
        linalg.diag_quad_sym(S.to(dt), Kuf.to(dt))


def _tri_proj(M: int) -> bool:
    """Whether the projections take the triangular-aware block products
    (``linalg.tri_project``): at M >= ``config.tri_matmul_min_m``, the
    gate the chol/inv pullback shares."""
    return M >= config.tri_matmul_min_m


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
        """A = Lk⁻¹ Kuf, the projection, and Kuf; both in bf16 under bf16
        storage (:func:`_storage_dtype`), A by the triangular-aware products
        at M >= ``tri_matmul_min_m``."""
        Kuf = self.prior.cov(self.inducing_points(), x)
        J = self.cache.Lk_inv
        if J is None:
            return torch.linalg.solve_triangular(self.cache.Kuu_L, Kuf, upper=False), Kuf
        M = Kuf.shape[0]
        dt = _storage_dtype(Kuf, M)
        if dt is not None:
            Kuf, J = Kuf.to(dt), J.to(dt)
        A = linalg.tri_project(J, Kuf) if _tri_proj(M) else J @ Kuf
        return A, Kuf

    def _BtA(self, A):
        """BᵀA, in A's dtype (cache.B is lower triangular: the build trils
        scale_tril, and the Centered B = Lk⁻¹·tril(Lq) is a product of lower
        factors)."""
        B = self.cache.B
        if _storage_dtype(B, B.shape[0]) == A.dtype:
            B = B.to(A.dtype)
        if _tri_proj(A.shape[0]):
            return linalg.tri_project(B, A, True)
        return B.T @ A

    def mean(self, x):
        Kuf = self.prior.cov(self.inducing_points(), x)
        return self.prior.mean(x) + _matvec_f32(Kuf.T, self.cache.alpha)

    def cov(self, x, z=None):
        Ax, _ = self._A_and_Kuf(x)
        if z is None:
            return self.prior.cov(x) - linalg.At_A(Ax) + linalg.At_A(self._BtA(Ax))
        Az, _ = self._A_and_Kuf(z)
        return self.prior.cov(x, z) - Ax.T @ Az + self._BtA(Ax).T @ self._BtA(Az)

    def _var_via_S(self, x, Kuf=None):
        """prior.var + diag(Kufᵀ S Kuf): the single-projection variance, S
        and Kuf in bf16 under bf16 storage (the sum in f32)."""
        if Kuf is None:
            Kuf = self.prior.cov(self.inducing_points(), x)
        return (self.prior.var(x) + _quad_corr(self.cache.S_corr, Kuf)).to(Kuf.dtype), Kuf

    def _var_via_A(self, x, A):
        return self.prior.var(x) - linalg.diag_At_A(A) + linalg.diag_At_A(self._BtA(A))

    def var(self, x):
        if self.cache.S_corr is not None:
            return self._var_via_S(x)[0]
        A, _ = self._A_and_Kuf(x)
        return self._var_via_A(x, A)

    def mean_and_var(self, x):
        if self.cache.S_corr is not None:
            v, Kuf = self._var_via_S(x)
        else:
            A, Kuf = self._A_and_Kuf(x)
            v = self._var_via_A(x, A)
        return self.prior.mean(x) + _matvec_f32(Kuf.T, self.cache.alpha), v

    @torch.no_grad()
    def predict_blocks(self, xs, block_size: int = 16384):
        """(mean, var) over a large test set, ``block_size`` points at a
        time, each block through the fused epilogue kernel when it applies
        (the S-correction cache exists and the kernel unwraps) and through
        :meth:`mean_and_var` otherwise.  The last block may be ragged.
        Under a profiler session the call is a ``predict_blocks`` span and
        each block a ``predict.block`` span inside it."""
        with named_scope("predict_blocks"):
            X = as_points(xs)
            operands = _epilogue_operands(
                self.prior, self.inducing_points(), self.cache.alpha, self.cache.S_corr,
                prefer=True
            )
            mus, variances = [], []
            for start in range(0, X.shape[0], block_size):
                with named_scope("predict.block"):
                    block = X[start:start + block_size]
                    if operands is not None:
                        mu, var = _epilogue_mu_var(self.prior, block, operands)
                    else:
                        mu, var = self.mean_and_var(block)
                    mus.append(mu)
                    variances.append(var)
            return torch.cat(mus), torch.cat(variances)


def inducing_points(f_post: SVGPPosterior) -> torch.Tensor:
    """The reference's ``inducing_points`` accessor."""
    return f_post.inducing_points()


def _s_corr(J, B):
    """S = Jᵀ(BBᵀ − I)J, symmetrized: the epilogue kernel reads only its
    upper triangle, the plain routes all of it, so both must see one
    exactly symmetric matrix."""
    C0 = B @ B.T - torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return linalg.symmetrize(J.T @ (C0 @ J))


def _cache_tail(J, Lq, m):
    """(α, C0, S) from J = Lk⁻¹: α = Jᵀm, C0 = LqLqᵀ − I, S = sym(Jᵀ C0 J)."""
    C0 = Lq @ Lq.T - torch.eye(Lq.shape[-1], dtype=Lq.dtype, device=Lq.device)
    return J.T @ m, C0, linalg.symmetrize(J.T @ (C0 @ J))


def _cache_tail_cotangents(J, C0, Lq, m, dJ, dalpha, dS):
    """(J̄-or-None, L̄q, m̄) from the cache tail's output cotangents (None
    for an absent one), reusing P = J·dSs across the C0-, Lq- and
    J-cotangents: dSs = dS + dSᵀ, L̄q = (P Jᵀ) Lq, J̄ = C0 P + m⊗dα + dJ,
    m̄ = J dα."""
    J_bar = None
    Lq_bar = torch.zeros_like(Lq)
    m_bar = torch.zeros_like(m)
    if dS is not None:
        P = J @ (dS + dS.T)
        Lq_bar = (P @ J.T) @ Lq
        J_bar = C0 @ P
    if dalpha is not None:
        r1 = m[:, None] * dalpha[None, :]
        J_bar = r1 if J_bar is None else J_bar + r1
        m_bar = J @ dalpha
    if dJ is not None:
        J_bar = dJ if J_bar is None else J_bar + dJ
    return J_bar, Lq_bar, m_bar


def _cache_chol_cotangents(Lk, J, C0, Lq, m, cts):
    """(K̄uu-or-None, L̄q, m̄) for the whitened-cache Functions: the cache
    tail's cotangents chained into the (L, J) → K̄uu Φ-sandwich, its
    products triangular-aware at M >= ``config.tri_matmul_min_m``.

    Fast path (the training step: only dα and dS live): the J̄ chain
    collapses, ``−J̄ Jᵀ = −C0 Q − m⊗m̄`` with ``Q = J dSs Jᵀ`` already needed
    for L̄q, so J̄ is never formed; 6 M³ matmuls instead of 7."""
    dLk, dJ, dalpha, dS = cts
    if dLk is None and dJ is None and dS is not None:
        Q = (J @ (dS + dS.T)) @ J.T  # symmetric
        Lq_bar = Q @ Lq
        inner = -(C0 @ Q)
        if dalpha is not None:
            m_bar = J @ dalpha
            inner = inner - m[:, None] * m_bar[None, :]
        else:
            m_bar = torch.zeros_like(m)
        return linalg._phi_sandwich(J, linalg._phi(inner)), Lq_bar, m_bar
    J_bar, Lq_bar, m_bar = _cache_tail_cotangents(J, C0, Lq, m, dJ, dalpha, dS)
    if dLk is None and J_bar is None:
        return None, Lq_bar, m_bar
    return linalg._inv_chol_bwd_fused(Lk, J, dLk, J_bar), Lq_bar, m_bar


class _WhitenedCacheFused(torch.autograd.Function):
    """NonCentered cache ``(Lk, J = Lk⁻¹, α = Jᵀm, S = Jᵀ(LqLqᵀ − I)J)`` from a
    given Kuu, with the minimal pullback of :func:`_cache_chol_cotangents`.
    The factorization is ``chol_with_inv``'s forward (the (L, L⁻¹) kernel on
    the card)."""

    @staticmethod
    def forward(ctx, Kuu, Lq, m):
        Lk, J = linalg._chol_with_inv_impl(Kuu)
        alpha, C0, S = _cache_tail(J, Lq, m)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(Lk, J, C0, Lq, m)
        return Lk, J, alpha, S

    @staticmethod
    def backward(ctx, dLk, dJ, dalpha, dS):
        Lk, J, C0, Lq, m = ctx.saved_tensors
        Kuu_bar, Lq_bar, m_bar = _cache_chol_cotangents(Lk, J, C0, Lq, m, (dLk, dJ, dalpha, dS))
        if Kuu_bar is None:
            Kuu_bar = torch.zeros_like(C0)
        return Kuu_bar, Lq_bar, m_bar


def _gram_pullback(Kuu_bar, Zs, v2, kmap):
    """K̄uu → (Z̄s, σ̄², jitter̄) for Kuu = σ²·g(r²(Zs, Zs)) + jitter·I.  Both
    slots carry Zs, so Z̄s = 2 Σ_j Ws_ij (Zs_i − Zs_j) with Ws = W + Wᵀ,
    W = K̄uu∘σ²g′(r²).

    The distances follow the Gram's own rule (``gram_mode``; "auto" takes
    exact differences below ``gram_auto_threshold`` elements, M²·D): with
    exact differences, r² and Z̄s come from Zs_i − Zs_j; otherwise r² takes
    the matmul identity and Z̄s = 2[rowsum(Ws)∘Zs − Ws Zs], as the JAX
    package's pullback always does.  The identity's error, about
    eps·max|Zs − c|², swamps close pairs when the points span many
    lengthscales: for 1024 inducing points on [0, 100] in f32 it put the
    Poisson step's lengthscale gradient 48 % off, where exact differences
    agree with the plain path's autograd."""
    M, D = Zs.shape
    exact = _resolve_gram_mode(M, M, D) == "broadcast"
    if exact:
        diff = Zs[:, None, :] - Zs[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
    else:
        r2 = pairwise_sq_dist(Zs, Zs, mode="matmul")
    K0 = kmap.k_of_r2(r2)
    dk = dk_from_k_for(kmap)
    gprime = dk(K0) if dk is not None else kmap.dk_of_r2(r2)
    W = Kuu_bar * (v2 * gprime)
    Ws = W + W.T
    if exact:
        Zs_bar = 2.0 * torch.einsum("ij,ijd->id", Ws, diff)
    else:
        Zs_bar = 2.0 * (torch.sum(Ws, dim=1)[:, None] * Zs - Ws @ Zs)
    return Zs_bar, torch.sum(Kuu_bar * K0), torch.trace(Kuu_bar)


class _WhitenedCacheFusedGram(torch.autograd.Function):
    """:class:`_WhitenedCacheFused` with the Kuu Gram generated inside the
    (L, L⁻¹) kernel (``gram_chol_inv``): inputs ``(Zs, σ², jitter, Lq, m)``
    and the map.  The backward recomputes the Gram once, for the pullback
    K̄uu → (Z̄s, σ̄², jitter̄); matmuls only."""

    @staticmethod
    def forward(ctx, Zs, v2, jitter, Lq, m, kmap):
        Lk, J = gram_chol_inv(Zs, v2, jitter, kmap)
        alpha, C0, S = _cache_tail(J, Lq, m)
        ctx.kmap = kmap
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(Lk, J, C0, Lq, m, Zs, v2, jitter)
        return Lk, J, alpha, S

    @staticmethod
    def backward(ctx, dLk, dJ, dalpha, dS):
        Lk, J, C0, Lq, m, Zs, v2, jitter = ctx.saved_tensors
        Kuu_bar, Lq_bar, m_bar = _cache_chol_cotangents(Lk, J, C0, Lq, m, (dLk, dJ, dalpha, dS))
        if Kuu_bar is None:
            return torch.zeros_like(Zs), torch.zeros_like(v2), torch.zeros_like(jitter), \
                Lq_bar, m_bar, None
        Zs_bar, v2_bar, jitter_bar = _gram_pullback(Kuu_bar, Zs, v2, ctx.kmap)
        need = ctx.needs_input_grad
        # a scalar that came from the host gets its gradient there
        v2_bar = v2_bar.to(v2) if need[1] else None
        jitter_bar = jitter_bar.to(jitter) if need[2] else None
        return Zs_bar, v2_bar, jitter_bar, Lq_bar, m_bar, None


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


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor in ``like``'s dtype (a tensor stays on its device and
    in the graph; a float is filled in on ``like``'s device, with no copy
    from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype)
    return like.new_full((), v)


@posterior.register(SparseVariationalApproximation)
def _posterior_svgp(sva: SparseVariationalApproximation, lfx=None, ys=None, **_) -> SVGPPosterior:
    """posterior(sva[, lfx, ys]): the SVGP posterior cache (reference
    ``:115-136`` Centered, ``:160-187`` NonCentered), differentiable in q,
    z and the kernel's hyperparameters.  The three-argument form checks
    that ``lfx`` has the approximation's prior, then builds the same
    cache."""
    if lfx is not None:
        _check_consistent_prior(sva, lfx)
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
            v2 = _scalar(1.0 if variance is None else variance, m)
            Kuu_L, Lk_inv, alpha, S_corr = _WhitenedCacheFusedGram.apply(
                Zs, v2, _scalar(fz.noise, m), qL, m, kmap
            )
        else:
            Kuu_L, Lk_inv, alpha, S_corr = _WhitenedCacheFused.apply(fz.cov(), qL, m)
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


def _structure(obj):
    """(tree structure, leaves) of a prior: dataclass fields recursively;
    tensors and numbers are leaves, anything else is part of the
    structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        struct, leaves = [], []
        for f in dataclasses.fields(obj):
            s, lv = _structure(getattr(obj, f.name))
            struct.append((f.name, s))
            leaves.extend(lv)
        return (type(obj), tuple(struct)), leaves
    if isinstance(obj, (torch.Tensor, np.ndarray, float, int)):
        return "leaf", [obj]
    return obj if isinstance(obj, type) else type(obj), []


def _check_consistent_prior(sva, lfx):
    """``lfx`` must have the approximation's prior: the same object, or one
    of the same structure with equal hyperparameter values."""
    fx = lfx.fx if isinstance(lfx, LatentFiniteGP) else lfx
    prior = fx.f
    if prior is sva.fz.f:
        return
    (sa, la), (sb, lb) = _structure(prior), _structure(sva.fz.f)
    if sa != sb:
        raise ValueError(
            "(Latent)FiniteGP prior is not consistent with SparseVariationalApproximation's"
        )
    for a, b in zip(la, lb):
        a = torch.as_tensor(a).detach().cpu()
        b = torch.as_tensor(b).detach().cpu()
        if a.shape != b.shape or not bool(torch.all(a == b)):
            raise ValueError(
                "(Latent)FiniteGP prior is not consistent with "
                "SparseVariationalApproximation's (hyperparameter values differ)"
            )


def _epilogue_ready(prior, z, S_corr, prefer=False):
    """Dispatch test for the fused data-term epilogue: the
    ``unwrap_stationary`` parts if it will be used, else None.

    ``prefer`` is set where the alternative recomputes the (M, B) Gram in
    the backward anyway (the streaming ELBO's checkpointed blocks) and for
    the serving sweep; in mode "auto" the epilogue declines without it, as
    the JAX package's does, because a minibatch ELBO that keeps its
    residuals does less work.  None means the plain route serves: no
    S-correction cache, ``data_term_mode="plain"``, kernels off, no
    ``prefer``, or a CPU tensor the epilogue does not take.  On the kernel
    device, where the epilogue would be taken, a prior or a shape the kernel
    does not take raises instead."""
    mode = config.data_term_mode
    if mode == "plain" or S_corr is None or not kernels_take(S_corr):
        return None
    if mode == "auto" and not prefer:
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
    if epilogue_part(zp.shape[0], zp.shape[1], S_corr.dtype) is None:
        if on_device:
            raise NotImplementedError(
                f"the fused SVGP epilogue's SIMT kernel (f64, and f32 with D > 8; the "
                f"tensor-core kernel takes f32 with D <= 8 at any M) has no tiling over M "
                f"(ROADMAP.md §2, row 2): its (block_b, M) K0 tile does not fit shared "
                f"memory at M={zp.shape[0]}, D={zp.shape[1]}, {S_corr.dtype}, block_b <= "
                f"{config.epilogue_block_b}; set data_term_mode='plain'"
            )
        return None
    return parts


def _epilogue_operands(prior, z, alpha, S_corr, prefer=False):
    """``(kmap, scale, Zs, Se, ae)`` for :func:`_epilogue_mu_var`, or None
    where :func:`_epilogue_ready` declines.

    With K = σ²·K0: ``mu = m(x) + K0ᵀ(σ²α)`` and
    ``var = prior.var + diag(K0ᵀ (σ⁴S) K0)``, so the kernel takes
    ``ae = σ²α``, ``Se = σ⁴S`` and inputs scaled by ``s``; every
    hyperparameter gradient flows through these four.  Formed once per
    sweep."""
    parts = _epilogue_ready(prior, z, S_corr, prefer)
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


def prior_kl(sva: SparseVariationalApproximation) -> torch.Tensor:
    """KL(q(u) ‖ p(u)) (reference ``_prior_kl``, ``:362-373``)."""
    if isinstance(sva.parametrization, Centered):
        return kl_divergence(sva.q, sva.fz.to_mvn())
    # whitened: (tr(Cε) + mᵀm − M − logdet Cε) / 2
    m = sva.q.mean
    L = sva.q.scale_tril
    return 0.5 * (torch.sum(L * L) + m @ m - m.shape[-1] - linalg.chol_logdet(L))


def elbo(sva: SparseVariationalApproximation, lfx, y: torch.Tensor,
         num_data: int | None = None, quadrature=None) -> torch.Tensor:
    """Evidence lower bound (reference ``:307-360``).

    Takes a ``FiniteGP`` with isotropic Gaussian noise (wrapped into a
    ``GaussianLikelihood``) or a ``LatentFiniteGP`` with any likelihood.
    ``num_data`` scales the data term by ``num_data / n_batch`` for a
    minibatch."""
    if quadrature is None:
        quadrature = DefaultExpectationMethod()
    if isinstance(lfx, FiniteGP):
        if not lfx.is_isotropic_noise:
            raise ValueError(
                "The observation noise fx.Σy must be homoscedastic.\n"
                "To avoid this error, construct fx using: f = GP(kernel); "
                "fx = f(x, σ²), where σ² is a positive Real."
            )
        lfx = LatentFiniteGP(lfx, GaussianLikelihood(lfx.noise))
    _check_consistent_prior(sva, lfx)

    f_post = _posterior_svgp(sva)
    x = lfx.fx.x
    operands = _epilogue_operands(
        f_post.prior, f_post.inducing_points(), f_post.cache.alpha, f_post.cache.S_corr
    )
    if operands is not None:
        q_mean, q_var = _epilogue_mu_var(f_post.prior, x, operands)
    else:
        q_mean, q_var = f_post.mean_and_var(x)
    variational_exp = expected_loglikelihood(quadrature, lfx.lik, q_mean, q_var, y)
    scale = 1.0 if num_data is None else num_data / y.shape[0]
    return torch.sum(variational_exp) * scale - prior_kl(sva)


@approx_lml.register(SparseVariationalApproximation)
def _approx_lml_svgp(sva, lfx, ys, **kwargs):
    """approx_lml = elbo for SVGP (reference ``:276-280``)."""
    return elbo(sva, lfx, ys, **kwargs)
