"""Unified top-level API (port of ``approximategps_tpu/models/api.py``):
``posterior`` and ``approx_lml`` dispatch on the approximation's type, and
each approximation module registers its methods."""

from __future__ import annotations

from functools import singledispatch
from typing import Any

__all__ = ["posterior", "approx_lml"]


@singledispatch
def posterior(approx: Any, *args, **kwargs):
    """posterior(approx, lfx, ys): the approximate posterior under
    ``approx``."""
    raise NotImplementedError(
        f"posterior not implemented for approximation {type(approx).__name__}"
    )


@singledispatch
def approx_lml(approx: Any, *args, **kwargs):
    """approx_lml(approx, lfx, ys): approximation to the log marginal
    likelihood."""
    raise NotImplementedError(
        f"approx_lml not implemented for approximation {type(approx).__name__}"
    )


def _register_exact():
    # posterior(fx, y) for exact GP regression, as AbstractGPs spells it
    from ..core.gp import FiniteGP
    from ..core.gp import posterior as exact_posterior

    @posterior.register(FiniteGP)
    def _(fx: FiniteGP, y, **kwargs):
        return exact_posterior(fx, y)


_register_exact()
