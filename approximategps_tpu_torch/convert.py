"""Carry parameters across from the JAX package.

``from_jax_params`` takes the JAX package's parameters (anything numpy can
read: JAX arrays, numpy arrays) in each form the repo uses and returns the
same form on the port's side, so that ``build_svgp`` / ``posterior`` /
``build_exact_fx`` / ``build_vecchia_fx`` / ``build_vecchia_nugget_fx`` /
``build_vecchia_rq_fx`` / ``build_knn_hetero_fx`` / ``natgrad_elbo`` /
``poisson_svgp_loss`` / ``laplace_neg_lml`` / ``heteroscedastic_svgp`` /
``heteroscedastic_loss`` compute the same thing in both packages, and
``laplace_kernel`` with ``laplace_data`` give the Laplace rows' model and
data (from numpy).  The tensors
land on the card unless the caller names another device.  Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.distributions import MultivariateNormal
from .core.gp import GP, FiniteGP, LatentGP
from .core.kernels import (
    Matern32Kernel,
    RationalQuadraticKernel,
    SqExponentialKernel,
    WhiteKernel,
    with_lengthscale,
)
from .core.likelihoods import BernoulliLikelihood, PoissonLikelihood
from .models.api import posterior
from .models.laplace import laplace_lml
from .models.multi_latent import HeteroscedasticGaussianLikelihood, MultiLatentSVGP, \
    multi_latent_elbo
from .models.svgp import SparseVariationalApproximation, SVGPPosterior, elbo
from .utils.bijectors import softplus
from .utils.training import SVGPParams

__all__ = ["from_jax_params", "build_posterior_from_bench_params", "build_exact_fx",
           "build_vecchia_fx", "build_vecchia_nugget_fx", "build_vecchia_rq_fx",
           "build_knn_hetero_fx", "natgrad_elbo", "poisson_svgp_loss", "laplace_neg_lml",
           "laplace_kernel", "laplace_data", "LAPLACE_CG_THETA", "heteroscedastic_svgp",
           "heteroscedastic_loss"]

_BENCH_KEYS = ("k", "z", "m", "A")
_THETA_LENS = (3, 4)  # raw θ of the exact GP and the Vecchia models (3), and of the RQ model


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: JAX hands out read-only buffers
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def from_jax_params(params, *, device="cuda", dtype=torch.float32):
    """The JAX package's parameters as the port's, on ``device`` (the card
    by default).

    - ``bench.py``'s dict ``{"k": [raw variance, raw lengthscale], "z": (M, D),
      "m": (M,), "A": (M, M)}`` becomes the same dict of tensors;
    - ``approximategps_tpu.utils.training.SVGPParams`` (or any object with
      its five fields) becomes :class:`SVGPParams`;
    - the exact GP's raw hyperparameter vector θ, shape (3,): raw
      (variance, lengthscale, noise variance), as ``tests/test_iterative.py``
      builds it, becomes a (3,) tensor for :func:`build_exact_fx`, and the
      Vecchia models' raw (variance, lengthscale, noise or nugget variance)
      ones for :func:`build_vecchia_fx` and :func:`build_vecchia_nugget_fx`,
      and the (4,) raw θ of :func:`build_vecchia_rq_fx`.
    """
    if isinstance(params, dict):
        if set(params) != set(_BENCH_KEYS):
            raise ValueError(f"expected the bench dict with keys {_BENCH_KEYS}, got {sorted(params)}")
        return {k: _tensor(params[k], device, dtype) for k in _BENCH_KEYS}
    if hasattr(params, "shape") and tuple(params.shape) in {(n,) for n in _THETA_LENS}:
        return _tensor(params, device, dtype)
    try:
        fields = {name: getattr(params, name) for name in SVGPParams._fields}
    except AttributeError as exc:
        raise TypeError(
            f"expected the bench dict, SVGPParams or a raw θ of shape (3,) or (4,), "
            f"got {type(params).__name__}"
        ) from exc
    return SVGPParams(**{k: _tensor(v, device, dtype) for k, v in fields.items()})


def build_posterior_from_bench_params(params: dict, jitter: float = 1e-6) -> SVGPPosterior:
    """The serving posterior of ``bench.py``'s ``svgp_predict_sweep``:
    σ² = softplus(k[0]), lengthscale softplus(k[1]), SE kernel, inducing
    jitter ``jitter``, q = N(m, tril(A)), NonCentered."""
    fz = _bench_gp(params["k"])(params["z"], jitter)
    q = MultivariateNormal(params["m"], torch.tril(params["A"]))
    return posterior(SparseVariationalApproximation(fz, q))


def build_exact_fx(theta: torch.Tensor, x: torch.Tensor) -> FiniteGP:
    """The exact GP of the matrix-free path from its raw hyperparameters, as
    ``build_fx(θ)`` of ``tests/test_iterative.py`` builds it in the JAX
    package: softplus(θ₀)·SE(lengthscale softplus(θ₁)) at ``x`` with noise
    variance softplus(θ₂)."""
    kernel = softplus(theta[0]) * with_lengthscale(SqExponentialKernel(), softplus(theta[1]))
    return GP(kernel)(x, softplus(theta[2]))


def build_vecchia_fx(theta: torch.Tensor, x: torch.Tensor) -> FiniteGP:
    """The Vecchia model of ``bench.py``'s Vecchia rows from raw
    hyperparameters: softplus(θ₀)·Matérn-3/2(lengthscale softplus(θ₁)) at
    ``x`` with noise variance softplus(θ₂) (θ₂ = −inf gives noise 0)."""
    kernel = softplus(theta[0]) * with_lengthscale(Matern32Kernel(), softplus(theta[1]))
    return GP(kernel)(x, softplus(theta[2]))


def build_vecchia_nugget_fx(theta: torch.Tensor, x: torch.Tensor) -> FiniteGP:
    """The noisy-data Vecchia training model of ``bench.py``'s
    ``vecchia_nugget_lml_grad`` from raw hyperparameters:
    softplus(θ₀)·Matérn-3/2(lengthscale softplus(θ₁)) + softplus(θ₂)·White
    at ``x`` with FiniteGP noise 0 (the precision root ignores that noise,
    so the white term carries it)."""
    kernel = (softplus(theta[0]) * with_lengthscale(Matern32Kernel(), softplus(theta[1]))
              + softplus(theta[2]) * WhiteKernel())
    return GP(kernel)(x, 0.0)


def build_vecchia_rq_fx(theta: torch.Tensor, x: torch.Tensor) -> FiniteGP:
    """The noisy-data Vecchia model with a kernel that does not unwrap, from
    raw hyperparameters: softplus(θ₀)·RationalQuadratic(α = softplus(θ₂))
    with lengthscale softplus(θ₁), + softplus(θ₃)·White, at ``x`` with
    FiniteGP noise 0 (the white term carries the noise, as in
    :func:`build_vecchia_nugget_fx`).  Its root runs the windowed tier."""
    kernel = (softplus(theta[0]) * with_lengthscale(RationalQuadraticKernel(softplus(theta[2])),
                                                    softplus(theta[1]))
              + softplus(theta[3]) * WhiteKernel())
    return GP(kernel)(x, 0.0)


def build_knn_hetero_fx(theta: torch.Tensor, x: torch.Tensor,
                        noise_vec: torch.Tensor) -> FiniteGP:
    """``predict_knn``'s model with noise that is not a scalar, from raw
    (variance, lengthscale): softplus(θ₀)·Matérn-3/2(lengthscale
    softplus(θ₁)) at ``x`` with the per-point noise variances ``noise_vec``
    (N,)."""
    kernel = softplus(theta[0]) * with_lengthscale(Matern32Kernel(), softplus(theta[1]))
    return GP(kernel)(x, noise_vec)


def _bench_gp(k: torch.Tensor) -> GP:
    """``bench.py``'s SVGP prior from raw k: softplus(k₀)·SE(lengthscale
    softplus(k₁))."""
    return GP(softplus(k[0]) * with_lengthscale(SqExponentialKernel(), softplus(k[1])))


def natgrad_elbo(hyper: dict, m: torch.Tensor, L: torch.Tensor, xb: torch.Tensor,
                 yb: torch.Tensor, num_data: int | None = None, jitter: float = 1e-6,
                 noise: float = 0.1) -> torch.Tensor:
    """The ELBO of ``bench.py::natgrad_hybrid``'s ``elbo_fn`` (to maximise):
    hyperparameters ``{"k": raw (variance, lengthscale), "z": (M, D)}``,
    the SE prior of :func:`build_posterior_from_bench_params`, inducing
    jitter ``jitter``, q = N(m, tril(L)) NonCentered, Gaussian noise
    ``noise``, the minibatch scaled to ``num_data``."""
    f = _bench_gp(hyper["k"])
    sva = SparseVariationalApproximation(f(hyper["z"], jitter),
                                         MultivariateNormal(m, torch.tril(L)))
    return elbo(sva, f(xb, noise), yb, num_data=num_data)


def poisson_svgp_loss(params: dict, xb: torch.Tensor, yb: torch.Tensor,
                      num_data: int | None = None, jitter: float = 1e-3) -> torch.Tensor:
    """−ELBO of ``bench.py::poisson_svgp``: the bench dict's SE prior, a
    Poisson likelihood (exp link, analytic expectation) with latent jitter
    1e-6, inducing jitter ``jitter`` (1e-3: f32 cannot factor 1024 densely
    spaced 1-D inducing points at 1e-6), q = N(m, tril(A)) NonCentered."""
    f = _bench_gp(params["k"])
    lf = LatentGP(f, PoissonLikelihood(), 1e-6)
    sva = SparseVariationalApproximation(f(params["z"], jitter),
                                         MultivariateNormal(params["m"], torch.tril(params["A"])))
    return -elbo(sva, lf(xb), yb, num_data=num_data)


def heteroscedastic_svgp(params: dict, jitter: float = 1e-6) -> MultiLatentSVGP:
    """The heteroscedastic two-latent SVGP, y ~ N(f¹, exp(f²)), from raw
    parameters ``{"mean": bench dict, "logvar": bench dict}``: each latent
    the SE prior of :func:`build_posterior_from_bench_params` from its own
    raw k, inducing points z (M, D), inducing jitter ``jitter`` and
    q = N(m, tril(A)) NonCentered (``tests/test_multi_latent.py``'s model,
    each latent with its own z)."""
    svas = []
    for tag in ("mean", "logvar"):
        p = params[tag]
        q = MultivariateNormal(p["m"], torch.tril(p["A"]))
        svas.append(SparseVariationalApproximation(_bench_gp(p["k"])(p["z"], jitter), q))
    return MultiLatentSVGP(tuple(svas), HeteroscedasticGaussianLikelihood())


def heteroscedastic_loss(params: dict, xb: torch.Tensor, yb: torch.Tensor,
                         num_data: int | None = None, n_gh: int = 10,
                         jitter: float = 1e-6) -> torch.Tensor:
    """−``multi_latent_elbo`` of :func:`heteroscedastic_svgp` on a
    minibatch: Gauss–Hermite with ``n_gh`` points a latent (``n_gh``²
    nodes), the data term scaled to ``num_data``."""
    return -multi_latent_elbo(heteroscedastic_svgp(params, jitter), xb, yb, num_data=num_data,
                              n_gh=n_gh)


def laplace_kernel(theta: torch.Tensor):
    """The Laplace rows' kernel from raw θ: softplus(θ₀)·SE(lengthscale
    softplus(θ₁)), ``bench.py::laplace_n5k``'s, and at
    :data:`LAPLACE_CG_THETA` the 1.5·SE(lengthscale 1.2) of
    ``laplace_cg_mode`` and ``laplace_cg_lml``."""
    return _bench_gp(theta).kernel


# raw θ of the matrix-free Laplace rows' kernel: softplus⁻¹ of (1.5, 1.2)
LAPLACE_CG_THETA = np.log(np.expm1(np.array([1.5, 1.2])))


def laplace_neg_lml(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor, jitter: float = 1e-6,
                    maxiter: int = 20) -> torch.Tensor:
    """−``laplace_lml`` of ``bench.py::laplace_n5k``: K = the Gram of
    :func:`laplace_kernel` at ``x`` plus ``jitter``·I, a Bernoulli (logit)
    likelihood, at most ``maxiter`` Newton steps."""
    K = GP(laplace_kernel(theta))(x, jitter).cov()
    return -laplace_lml(BernoulliLikelihood(), y, K, maxiter=maxiter)


def laplace_data(N: int, D: int, seed: int = 0, device="cuda", dtype=torch.float32):
    """``bench.py``'s Laplace rows' data, drawn with numpy from ``seed`` (the
    JAX draws cannot be reproduced): N points uniform on [0, 10]^D (for
    D = 1 sorted and of shape (N,), as ``laplace_n5k`` has them) and labels
    in {0, 1}, each 1 with probability 1/2 (int32)."""
    rng = np.random.default_rng(seed)
    x = 10.0 * rng.uniform(size=(N, D))
    if D == 1:
        x = np.sort(x[:, 0])
    y = (rng.uniform(size=N) > 0.5).astype(np.int32)
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(y, device=device))
