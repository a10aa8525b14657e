"""Streaming / online sparse variational GP updates (port of
``approximategps_tpu/models/svgp_online.py``; Bui, Nguyen & Turner,
"Streaming sparse Gaussian process approximations", NeurIPS 2017).

When a new batch arrives, the old variational posterior ``q_old(b)`` (at
the old inducing sites, under the old hyperparameters) stands in for all
past data through an analytic Gaussian correction to the new batch's ELBO:

    F = Σᵢ E_{q(fᵢ)}[log p(yᵢ|fᵢ)] − KL(q(a) ‖ p_new(a))
        + E_{q(b)}[log q_old(b)] − E_{q(b)}[log p_old(b)],

``q(b) = ∫ p_new(b|a) q(a) da`` the new posterior's marginal at the old
sites.  :func:`online_elbo` is ``elbo`` (the posterior build: row 1 on the
card for a NonCentered approximation at M ≥ 512) plus M×M solves.  For a
Gaussian likelihood :func:`online_optimal_q` is the closed-form optimum, and
with fixed sites and hyperparameters :func:`site_update` accumulates the
whitened natural parameters, never subtracting, so that the stream equals
the full-batch Titsias optimum.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import linalg
from ..core.distributions import MultivariateNormal
from ..core.gp import FiniteGP
from ..core.means import ZeroMean
from .svgp import Centered, SparseVariationalApproximation, elbo
from .vfe import whitened_q

__all__ = [
    "OnlineSVGPState",
    "GaussianSiteState",
    "centered_q",
    "online_state",
    "online_elbo",
    "online_optimal_q",
    "site_state",
    "site_update",
    "site_posterior_q",
]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def centered_q(sva: SparseVariationalApproximation) -> MultivariateNormal:
    """The variational posterior in f-space at the inducing sites:
    ``Centered`` stores it; ``NonCentered`` stores the whitened ε-space
    one, mapped by m_f = μ(z) + Lk m_ε, L_f = Lk L_ε."""
    if isinstance(sva.parametrization, Centered):
        return sva.q
    Lk = sva.fz.scale_tril()
    return MultivariateNormal(sva.fz.mean() + Lk @ sva.q.mean, Lk @ sva.q.scale_tril)


@dataclasses.dataclass(frozen=True, eq=False)
class OnlineSVGPState:
    """A fitted round: the old inducing prior ``fz`` (old sites and old
    hyperparameters: p_old(b)) and the old variational posterior ``q`` in
    f-space."""

    fz: FiniteGP
    q: MultivariateNormal


def online_state(sva: SparseVariationalApproximation) -> OnlineSVGPState:
    """Freeze a fitted approximation (either parametrization) into the
    state carried to the next round."""
    return OnlineSVGPState(sva.fz, centered_q(sva))


def _projected_marginal(sva: SparseVariationalApproximation, b: torch.Tensor):
    """(μ_b, Σ_b) of q(b) at the old sites ``b``, under the new prior:
    μ_b = μ(b) + A(m_a − μ(a)), Σ_b = K_bb − K_ba K_aa⁻¹ K_ab + A S_a Aᵀ,
    A = K_ba K_aa⁻¹."""
    fz = sva.fz
    q_a = centered_q(sva)
    Lk = fz.scale_tril()
    V = linalg.solve_lower_triangular(Lk, fz.f.cov(fz.x, b))  # Lk⁻¹ K_ab; Q_bb = VᵀV
    mu_b = fz.f.mean(b) + V.T @ linalg.solve_lower_triangular(Lk, q_a.mean - fz.mean())
    # Φ_bᵀ S_a Φ_b = UᵀU with U = L_Sᵀ (Lk⁻ᵀ V)
    U = q_a.scale_tril.T @ linalg.solve_upper_triangular(Lk.T, V)
    return mu_b, fz.f.cov(b) - V.T @ V + U.T @ U


def _old_correction(sva: SparseVariationalApproximation, state: OnlineSVGPState) -> torch.Tensor:
    """E_{q(b)}[log q_old(b)] − E_{q(b)}[log p_old(b)], each
    E[log N(b; m, S)] = log N(μ_b; m, S) − tr(S⁻¹ Σ_b)/2 (the Mb·log 2π
    constants cancel)."""
    mu_b, Sigma_b = _projected_marginal(sva, state.fz.x)
    q_old, fz_old = state.q, state.fz
    L_S = q_old.scale_tril
    L_K = fz_old.scale_tril()
    r_q = linalg.solve_lower_triangular(L_S, mu_b - q_old.mean)
    r_p = linalg.solve_lower_triangular(L_K, mu_b - fz_old.mean())
    tr_q = torch.trace(linalg.cholesky_solve(L_S, Sigma_b))
    tr_p = torch.trace(linalg.cholesky_solve(L_K, Sigma_b))
    e_logq = -0.5 * (linalg.chol_logdet(L_S) + r_q @ r_q + tr_q)
    e_logp = -0.5 * (linalg.chol_logdet(L_K) + r_p @ r_p + tr_p)
    return e_logq - e_logp


def online_elbo(sva: SparseVariationalApproximation, state: OnlineSVGPState, lfx,
                y: torch.Tensor, num_data: int | None = None, quadrature=None) -> torch.Tensor:
    """The online evidence lower bound for the new batch given the old
    round's state (arXiv:1705.07131 eq. 12, uncollapsed): ``elbo`` plus the
    correction, which vanishes when the old posterior is the old prior.
    ``num_data`` scales the data term within the round only; past rounds
    enter through the correction, never rescaled."""
    return elbo(sva, lfx, y, num_data=num_data, quadrature=quadrature) + \
        _old_correction(sva, state)


def _require_zero_mean(f, what: str) -> None:
    """Reject a prior mean that is not ``ZeroMean``; a prior without a
    ``mean_fn`` is not a plain GP and is rejected too (the natural-parameter
    updates omit the prior-mean shifts)."""
    _missing = object()
    mean_fn = getattr(f, "mean_fn", _missing)
    if mean_fn is _missing or not isinstance(mean_fn, ZeroMean):
        raise ValueError(f"{what} requires a GP with ZeroMean.")


def _isotropic_s2(fx: FiniteGP, what: str, like: torch.Tensor) -> torch.Tensor:
    if not fx.is_isotropic_noise:
        raise ValueError(f"{what} requires isotropic noise")
    return torch.as_tensor(fx.noise, dtype=like.dtype, device=like.device)


def online_optimal_q(state: OnlineSVGPState, fz_new: FiniteGP, fx: FiniteGP,
                     y: torch.Tensor) -> MultivariateNormal:
    """The closed-form optimal q(a) of the online bound for a Gaussian
    likelihood.  In the whitened basis (Ṽ = Lk⁻¹K),

        C = I + σ⁻² Ṽ_x Ṽ_xᵀ + Ṽ_b D_old Ṽ_bᵀ,  S = Lk C⁻¹ Lkᵀ,
        m = Lk C⁻¹ (σ⁻² Ṽ_x y + Ṽ_b e_old),

    D_old = S_old⁻¹ − K_old⁻¹ and e_old = S_old⁻¹ m_old the old sites,
    formed by triangular solves only (Ṽ_b D_old Ṽ_bᵀ = G_sᵀG_s − G_kᵀG_k,
    G = L⁻¹ Ṽ_bᵀ).  A zero-mean prior (new and carried) and isotropic
    noise only."""
    _require_zero_mean(fz_new.f, "online_optimal_q")
    _require_zero_mean(state.fz.f, "online_optimal_q (carried state.fz)")
    Lk = fz_new.scale_tril()
    s2 = _isotropic_s2(fx, "online_optimal_q", Lk)
    Vx = linalg.solve_lower_triangular(Lk, fz_new.f.cov(fz_new.x, fx.x))
    Vb = linalg.solve_lower_triangular(Lk, fz_new.f.cov(fz_new.x, state.fz.x))
    L_S_old = state.q.scale_tril
    Gs = linalg.solve_lower_triangular(L_S_old, Vb.T)
    Gk = linalg.solve_lower_triangular(state.fz.scale_tril(), Vb.T)
    C = _eye(Lk.shape[0], Lk) + (Vx @ Vx.T) / s2 + Gs.T @ Gs - Gk.T @ Gk
    rhs = Vx @ y / s2 + Gs.T @ linalg.solve_lower_triangular(L_S_old, state.q.mean)
    return whitened_q(Lk, C, rhs)


# -- the fixed-site fast path: whitened natural-parameter accumulation -------


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianSiteState:
    """Accumulated Gaussian likelihood sites in the whitened inducing basis,
    for a stream whose inducing sites and hyperparameters stay fixed:

        lam += Ṽ_x Ṽ_xᵀ / σ²,   eta += Ṽ_x y / σ²,   Ṽ_x = Lk⁻¹ K_zx.

    lam is PSD and only grows; a batch costs one (M, B) Gram, one
    triangular solve and one rank-B update, and the M × M factorization
    waits for :func:`site_posterior_q`."""

    fz: FiniteGP
    lam: torch.Tensor
    eta: torch.Tensor


def site_state(fz: FiniteGP) -> GaussianSiteState:
    """An empty accumulator for a stream anchored at ``fz`` (a zero-mean
    prior), in the inducing points' dtype and on their device."""
    _require_zero_mean(fz.f, "site_state")
    z = torch.as_tensor(fz.x)
    M = z.shape[0]
    return GaussianSiteState(fz, z.new_zeros((M, M)), z.new_zeros((M,)))


def site_update(state: GaussianSiteState, fx: FiniteGP, y: torch.Tensor) -> GaussianSiteState:
    """Absorb one Gaussian batch (exact and order-independent)."""
    fz = state.fz
    Lk = fz.scale_tril()
    s2 = _isotropic_s2(fx, "site_update", Lk)
    Vx = linalg.solve_lower_triangular(Lk, fz.f.cov(fz.x, fx.x))
    return GaussianSiteState(fz, state.lam + (Vx @ Vx.T) / s2, state.eta + Vx @ y / s2)


def site_posterior_q(state: GaussianSiteState) -> MultivariateNormal:
    """The optimal q(u) given every batch absorbed so far, the full-batch
    Titsias optimum on the concatenated data: C = I + lam,
    S = Lk C⁻¹ Lkᵀ, m = Lk C⁻¹ eta."""
    Lk = state.fz.scale_tril()
    C = _eye(Lk.shape[0], Lk) + state.lam
    return whitened_q(Lk, C, state.eta)
