"""approximategps_tpu_torch — the PyTorch / CUDA port of approximategps_tpu.

A second package beside the JAX one, which stays the reference.  It
carries the SVGP serving path (``posterior``, then
``SVGPPosterior.predict_blocks``) and the SVGP training path: the minibatch
``elbo`` and the full-data ``streaming_elbo`` with their gradients, and
``adam_fit``; and the matrix-free exact GP: hyperparameter training on
``-logpdf_slq`` (``make_slq_hyperopt_step``) and serving through
``posterior_cg``; and Vecchia serving and training: the banded and sparse
precision roots (``approx_root_prec_band``, the maximin / random orderings
and nearest / scaled neighbour sets), ``approx_lml`` with its
hyperparameter gradient (a white-noise nugget included) and
``predict_knn``, with the kernels that do not unwrap (rational quadratic,
periodic, linear, polynomial, products) and noise that is not a scalar on the
windowed tier; every likelihood of the JAX package (Gaussian, Bernoulli,
Poisson, Exponential, Gamma, negative binomial, Student-t, the Gauss–Newton
wrapper and user functions) with Gauss–Hermite, Monte-Carlo and analytic
expectations; VFE (the Titsias bound and optimal q); the natural-gradient
updates and the hybrid step ``make_natgrad_adam_step`` (Adam on the
hyperparameters, one natural-gradient step on q), and ``lbfgs_fit``; and
block-Vecchia (``BlockNearestNeighbors``: ``approx_lml`` and ``posterior``
from batched per-block factorizations, no hand-written kernel); and the
Laplace approximation, dense (``LaplaceApproximation``: Newton with IFT
gradients, ``build_laplace_objective``) and matrix-free (``LaplaceCG``:
CG-Newton and the SLQ log determinant, every product through the Gram
matvec kernel on the card), with the Lanczos
square-root samplers ``sample_prior_msqrt`` and ``sample_posterior_msqrt``.
Hand-written CUDA kernels for Hopper (``csrc/``) carry them
on the GPU, each beside a plain PyTorch version that CPU tensors take:

- ``ops.panel_chol.gram_chol_inv``: (L, L⁻¹) with the Kuu Gram generated
  inside the factorization;
- ``ops.panel_chol.chol_inv``: (L, L⁻¹) of a given SPD matrix;
- ``ops.svgp_epilogue.svgp_data_epilogue``: (mean, var) without the (M, B)
  cross-covariance in device memory, and its backward
  (``svgp_data_epilogue_bwd``), which rebuilds it tile by tile;
- ``ops.gram_matvec.gram_matvec``: K(Xq, Zk)·V without K, and the passes of
  its pullback, under every CG, Lanczos and surrogate matvec;
- ``ops.batched_chol.vecchia_band``: Vecchia band rows from point windows,
  window → Gram → bordered Cholesky in one pass, under the band build and
  ``predict_knn``, and its pullback ``vecchia_band_bwd`` under every
  Vecchia training step;
- ``ops.batched_chol.batched_chol_solve_band``: band rows from prebuilt
  window Grams, under the windowed Vecchia tier;
- ``ops.gram.stationary_gram``: g(r²(X, Z)) with r² and the map fused, under
  non-symmetric Grams with ``gram_mode="fused"``.

The kernels are built with ``nvcc`` at first use (``ops/_build.py``); the
host-side orderings of ``native/`` with g++.
"""

from . import config as _config_module
from . import convert, core, models, native, ops, utils
from .config import config, config_context, set_config
from .core import (
    GP,
    AbstractGP,
    Analytic,
    BernoulliLikelihood,
    ConstantKernel,
    DefaultExpectationMethod,
    ExponentialLikelihood,
    FunctionLikelihood,
    GammaLikelihood,
    GaussHermite,
    GaussianLikelihood,
    GaussNewtonLikelihood,
    Likelihood,
    MonteCarlo,
    NegativeBinomialLikelihood,
    PoissonLikelihood,
    StudentTLikelihood,
    as_likelihood,
    blocked_tril_inv,
    expected_loglikelihood,
    LatentFiniteGP,
    LatentGP,
    LinearKernel,
    ExponentialKernel,
    FiniteGP,
    InputScaledKernel,
    Kernel,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    MultivariateNormal,
    PeriodicKernel,
    PolynomialKernel,
    ProductKernel,
    RationalQuadraticKernel,
    RBFKernel,
    ScaledKernel,
    SEKernel,
    SqExponentialKernel,
    StationaryKernel,
    SumKernel,
    WhiteKernel,
    logpdf,
    unwrap_stationary_nugget,
    with_lengthscale,
)
from .models import (
    VFE,
    BandInvRoot,
    BlockInvRoot,
    BlockNearestNeighbors,
    CGPosterior,
    Centered,
    NonCentered,
    NearestNeighbors,
    SparseInvRoot,
    SparseVariationalApproximation,
    SVGPPosterior,
    approx_lml,
    approx_root_prec_band,
    approx_root_prec_sparse,
    band_U_matvec,
    block_vecchia_factors,
    band_Ut_matmul,
    cg_solve,
    elbo,
    kernel_matvec,
    logpdf_slq,
    optimal_variational_posterior,
    pivoted_cholesky,
    posterior,
    posterior_cg,
    predict_knn,
    prior_kl,
    resolve_ordering,
    streaming_elbo,
    vfe_elbo,
    woodbury_preconditioner,
    LaplaceApproximation,
    LaplaceObjective,
    LaplacePosterior,
    LaplaceResult,
    build_laplace_objective,
    laplace_f_and_lml,
    laplace_f_cov,
    laplace_lml,
    laplace_steps,
    laplace_steps_scan,
    newton_inner_loop,
    newton_inner_loop_jvp,
    newton_multistart,
    LaplaceCG,
    LaplaceCGPosterior,
    laplace_lml_cg,
    newton_inner_loop_cg,
    msqrt_matvec,
    sample_prior_msqrt,
    sample_posterior_msqrt,
)
from .native import maximin_ordering, nearest_predecessor_neighbors, scaled_ball_predecessors
from .ops import knn_search
from .utils import (
    SVGPParams,
    adam_fit,
    build_svgp,
    init_svgp_params,
    lbfgs_fit,
    make_natgrad_adam_step,
    make_slq_hyperopt_step,
    natgrad_update,
    natgrad_update_tril,
)

__all__ = [
    "config",
    "config_context",
    "set_config",
    "GP",
    "AbstractGP",
    "FiniteGP",
    "LatentGP",
    "LatentFiniteGP",
    "Likelihood",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "PoissonLikelihood",
    "ExponentialLikelihood",
    "GammaLikelihood",
    "NegativeBinomialLikelihood",
    "GaussNewtonLikelihood",
    "StudentTLikelihood",
    "FunctionLikelihood",
    "as_likelihood",
    "GaussHermite",
    "MonteCarlo",
    "Analytic",
    "DefaultExpectationMethod",
    "expected_loglikelihood",
    "blocked_tril_inv",
    "Kernel",
    "StationaryKernel",
    "SqExponentialKernel",
    "SEKernel",
    "RBFKernel",
    "Matern12Kernel",
    "ExponentialKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "PeriodicKernel",
    "LinearKernel",
    "PolynomialKernel",
    "ProductKernel",
    "ScaledKernel",
    "InputScaledKernel",
    "WhiteKernel",
    "ConstantKernel",
    "SumKernel",
    "unwrap_stationary_nugget",
    "with_lengthscale",
    "MultivariateNormal",
    "Centered",
    "NonCentered",
    "SparseVariationalApproximation",
    "SVGPPosterior",
    "posterior",
    "approx_lml",
    "elbo",
    "prior_kl",
    "streaming_elbo",
    "SVGPParams",
    "init_svgp_params",
    "build_svgp",
    "adam_fit",
    "lbfgs_fit",
    "natgrad_update",
    "natgrad_update_tril",
    "make_natgrad_adam_step",
    "VFE",
    "optimal_variational_posterior",
    "vfe_elbo",
    "logpdf",
    "cg_solve",
    "kernel_matvec",
    "posterior_cg",
    "logpdf_slq",
    "CGPosterior",
    "pivoted_cholesky",
    "woodbury_preconditioner",
    "make_slq_hyperopt_step",
    "NearestNeighbors",
    "BandInvRoot",
    "SparseInvRoot",
    "approx_root_prec_band",
    "approx_root_prec_sparse",
    "band_Ut_matmul",
    "band_U_matvec",
    "predict_knn",
    "resolve_ordering",
    "maximin_ordering",
    "nearest_predecessor_neighbors",
    "scaled_ball_predecessors",
    "knn_search",
    "BlockNearestNeighbors",
    "BlockInvRoot",
    "block_vecchia_factors",
    "LaplaceApproximation",
    "LaplaceObjective",
    "LaplacePosterior",
    "LaplaceResult",
    "build_laplace_objective",
    "laplace_f_and_lml",
    "laplace_f_cov",
    "laplace_lml",
    "laplace_steps",
    "laplace_steps_scan",
    "newton_inner_loop",
    "newton_inner_loop_jvp",
    "newton_multistart",
    "LaplaceCG",
    "LaplaceCGPosterior",
    "laplace_lml_cg",
    "newton_inner_loop_cg",
    "msqrt_matvec",
    "sample_prior_msqrt",
    "sample_posterior_msqrt",
]
