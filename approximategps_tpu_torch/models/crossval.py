"""Leave-one-out cross-validation for exact GP regression (port of
``approximategps_tpu/models/crossval.py``; Rasmussen & Williams, GPML
§5.4.2, eqs. 5.10–5.12).

All N leave-one-out predictive distributions come from one factorization
of C = K + Σy:

    μ_i = y_i − α_i / [C⁻¹]_ii,   σ²_i = 1 / [C⁻¹]_ii,
    LOO-lpd = Σᵢ log N(y_i; μ_i, σ²_i),

with α = C⁻¹(y − m) and diag(C⁻¹) the squared column norms of L⁻¹
(``blocked_tril_inv``: a triangular solve against I with a matmul-only
pullback).  Per-point noise is taken, since C is ``fx.cov()``; autograd
through :func:`loo_logpdf` gives GPML eq. 5.13's gradient.
"""

from __future__ import annotations

import math

import torch

from ..core import linalg
from ..core.gp import FiniteGP

__all__ = ["loo_mean_and_var", "loo_logpdf"]

_LOG2PI = math.log(2.0 * math.pi)


def _loo_parts(fx: FiniteGP, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(α, diag(C⁻¹)) from one Cholesky of C = K + Σy."""
    L = fx.scale_tril()
    alpha = linalg.cholesky_solve(L, y - fx.mean())
    Linv = linalg.blocked_tril_inv(L)
    return alpha, torch.sum(Linv * Linv, dim=0)


def loo_mean_and_var(fx: FiniteGP, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each point's leave-one-out predictive (mean, variance) of y_i given
    the others (GPML eq. 5.12), in y-space: observation noise included."""
    alpha, cinv_diag = _loo_parts(fx, y)
    var = 1.0 / cinv_diag
    return y - alpha * var, var


def loo_logpdf(fx: FiniteGP, y: torch.Tensor) -> torch.Tensor:
    """The LOO log predictive probability Σᵢ log p(y_i | y_{−i}, θ) (GPML
    eqs. 5.11–5.12), differentiable in θ, x, the noise and y."""
    alpha, cinv_diag = _loo_parts(fx, y)
    # log N(y_i; μ_i, σ²_i) = −½log2π + ½log c_ii − α_i²/(2 c_ii)
    return torch.sum(-0.5 * _LOG2PI + 0.5 * torch.log(cinv_diag)
                     - alpha**2 / (2.0 * cinv_diag))
