"""Carry parameters across from the JAX package.

``from_jax_params`` takes the JAX package's SVGP parameters (anything numpy
can read: JAX arrays, numpy arrays) in either form the repo uses and
returns the same form on the port's side, so that ``build_svgp`` /
``posterior`` compute the same thing in both packages.  Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.distributions import MultivariateNormal
from .core.gp import GP
from .core.kernels import SqExponentialKernel, with_lengthscale
from .models.api import posterior
from .models.svgp import SparseVariationalApproximation, SVGPPosterior
from .utils.bijectors import softplus
from .utils.training import SVGPParams

__all__ = ["from_jax_params", "build_posterior_from_bench_params"]

_BENCH_KEYS = ("k", "z", "m", "A")


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: JAX hands out read-only buffers
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def from_jax_params(params, *, device="cpu", dtype=torch.float32):
    """The JAX package's parameters as the port's.

    - ``bench.py``'s dict ``{"k": [raw variance, raw lengthscale], "z": (M, D),
      "m": (M,), "A": (M, M)}`` becomes the same dict of tensors;
    - ``approximategps_tpu.utils.training.SVGPParams`` (or any object with
      its five fields) becomes :class:`SVGPParams`.
    """
    if isinstance(params, dict):
        if set(params) != set(_BENCH_KEYS):
            raise ValueError(f"expected the bench dict with keys {_BENCH_KEYS}, got {sorted(params)}")
        return {k: _tensor(params[k], device, dtype) for k in _BENCH_KEYS}
    try:
        fields = {name: getattr(params, name) for name in SVGPParams._fields}
    except AttributeError as exc:
        raise TypeError(
            f"expected the bench dict or SVGPParams, got {type(params).__name__}"
        ) from exc
    return SVGPParams(**{k: _tensor(v, device, dtype) for k, v in fields.items()})


def build_posterior_from_bench_params(params: dict, jitter: float = 1e-6) -> SVGPPosterior:
    """The serving posterior of ``bench.py``'s ``svgp_predict_sweep``:
    σ² = softplus(k[0]), lengthscale softplus(k[1]), SE kernel, inducing
    jitter ``jitter``, q = N(m, tril(A)), NonCentered."""
    k = params["k"]
    kernel = softplus(k[0]) * with_lengthscale(SqExponentialKernel(), softplus(k[1]))
    f = GP(kernel)
    fz = f(params["z"], jitter)
    q = MultivariateNormal(params["m"], torch.tril(params["A"]))
    return posterior(SparseVariationalApproximation(fz, q))
