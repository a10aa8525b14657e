"""VFE / Titsias sparse posterior and collapsed bound (port of
``approximategps_tpu/models/vfe.py``).

``VFE(fz)`` is the variationally optimal sparse approximation anchored at
the inducing prior ``fz = f(z, jitter)``: its closed-form optimal q(u)
feeds a Centered SVGP posterior (Titsias 2009), and the collapsed bound is
evaluated through Woodbury, so that the large-N work is matmuls.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import linalg
from ..core.distributions import MultivariateNormal
from ..core.gp import FiniteGP
from ..core.means import ZeroMean
from .api import approx_lml, posterior
from .svgp import Centered, SparseVariationalApproximation, SVGPPosterior

__all__ = ["VFE", "optimal_variational_posterior", "vfe_elbo"]

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True, eq=False)
class VFE:
    """Titsias (2009) variationally optimal sparse approximation, anchored
    at the inducing prior ``fz = f(z, jitter)``."""

    fz: FiniteGP


def _noise(fx: FiniteGP, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fx.noise, dtype=like.dtype, device=like.device)


def optimal_variational_posterior(fu: FiniteGP, fx: FiniteGP,
                                  y: torch.Tensor) -> MultivariateNormal:
    """Closed-form optimal q(u) for a Gaussian likelihood: with
    Σ = Kuu + σ⁻² Kuf Kfu, m = σ⁻² Kuu Σ⁻¹ Kuf y and S = Kuu Σ⁻¹ Kuu.
    Requires a zero-mean prior and isotropic noise."""
    mean_fn = getattr(fu.f, "mean_fn", None)
    if mean_fn is not None and not isinstance(mean_fn, ZeroMean):
        raise ValueError("The exact posterior requires a GP with ZeroMean.")
    if not fx.is_isotropic_noise:
        raise ValueError("optimal_variational_posterior requires isotropic noise")
    Kuf = fu.f.cov(fu.x, fx.x)
    s2 = _noise(fx, Kuf)
    # Whitened evaluation: with V = Lk⁻¹Kuf and C = I + V Vᵀ/σ²,
    #   Σ = Lk C Lkᵀ,  m = Lk C⁻¹ V y / σ²,  S = Lk C⁻¹ Lkᵀ.
    # The textbook unwhitened form (Σ = Kuu + KufKfu/σ², S = Kuu Σ⁻¹ Kuu) is
    # the same in exact arithmetic but breaks in f32: Σ inherits
    # cond(Kuu)·(1 + N·k̄/σ²) and the S sandwich loses positive
    # definiteness (the JAX package measured NaN on the CPU in f32 and a
    # 2.4e-2 posterior-mean error on the TPU at N = 3000, M = 32,
    # σ² = 0.05, where this form stays within 7e-6 of the f64 truth).
    Lk = fu.scale_tril()  # with fz's jitter
    V = linalg.solve_lower_triangular(Lk, Kuf)
    C = torch.eye(Lk.shape[0], dtype=Lk.dtype, device=Lk.device) + (V @ V.T) / s2
    return whitened_q(Lk, C, V @ y / s2)


def whitened_q(Lk: torch.Tensor, C: torch.Tensor, rhs: torch.Tensor) -> MultivariateNormal:
    """q with S = Lk C⁻¹ Lkᵀ and m = Lk C⁻¹ rhs (C symmetrized by the
    factorization); S is not triangular, so it is factored once at M × M.
    The optimal q's of the batch and the online bounds
    (``svgp_online.py``) in the whitened basis."""
    C_L = linalg.safe_cholesky(C)
    m = Lk @ linalg.cholesky_solve(C_L, rhs)
    W = linalg.solve_lower_triangular(C_L, Lk.T).T  # S = W Wᵀ
    return MultivariateNormal(m, linalg.safe_cholesky(W @ W.T))


@posterior.register(VFE)
def _posterior_vfe(vfe: VFE, fx: FiniteGP, y: torch.Tensor, **_) -> SVGPPosterior:
    """posterior(VFE(fz), fx, y): the Centered SVGP posterior at the optimal
    q(u)."""
    q_opt = optimal_variational_posterior(vfe.fz, fx, y)
    return posterior(SparseVariationalApproximation(vfe.fz, q_opt, Centered()))


def vfe_elbo(vfe: VFE, fx: FiniteGP, y: torch.Tensor) -> torch.Tensor:
    """Titsias' collapsed bound
    log N(y | m, Qff + σ²I) − tr(Kff − Qff)/(2σ²), Qff = Kfu Kuu⁻¹ Kuf,
    through Woodbury: O(M²N + M³)."""
    if not fx.is_isotropic_noise:
        raise ValueError("vfe_elbo requires isotropic noise")
    fz = vfe.fz
    n = y.shape[0]
    Kuu_L = fz.scale_tril()
    Kuf = fz.f.cov(fz.x, fx.x)
    s2 = _noise(fx, Kuf)
    V = linalg.solve_lower_triangular(Kuu_L, Kuf)  # Qff = VᵀV
    A = V / torch.sqrt(s2)
    B = torch.eye(A.shape[0], dtype=A.dtype, device=A.device) + A @ A.T
    B_L = linalg.safe_cholesky(B)
    delta = y - fx.f.mean(fx.x)
    c = linalg.solve_lower_triangular(B_L, A @ delta)
    quad = (delta @ delta - c @ c) / s2
    logdet = n * torch.log(s2) + linalg.chol_logdet(B_L)
    lognorm = -0.5 * (n * _LOG2PI + logdet + quad)
    trace_term = (torch.sum(fx.f.var(fx.x)) - torch.sum(V * V)) / (2.0 * s2)
    return lognorm - trace_term


@approx_lml.register(VFE)
def _approx_lml_vfe(vfe: VFE, fx: FiniteGP, y: torch.Tensor, **_):
    return vfe_elbo(vfe, fx, y)
