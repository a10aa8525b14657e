"""Approximate-inference models: SVGP serving and training, VFE, the
matrix-free exact GP and its Lanczos samplers, the Laplace approximation
(dense and matrix-free), Vecchia serving and training, and block-Vecchia."""

from . import (api, block_vecchia, iterative, laplace, laplace_cg, svgp, svgp_streaming, vecchia,
               vfe)
from .api import approx_lml, posterior
from .block_vecchia import BlockInvRoot, BlockNearestNeighbors, block_vecchia_factors
from .svgp import (
    Centered,
    NonCentered,
    SparseVariationalApproximation,
    SVGPPosterior,
    elbo,
    prior_kl,
)
from .svgp_streaming import streaming_data_term, streaming_elbo
from .iterative import (
    CGPosterior,
    cg_solve,
    kernel_matvec,
    logpdf_slq,
    msqrt_matvec,
    pivoted_cholesky,
    posterior_cg,
    sample_posterior_msqrt,
    sample_prior_msqrt,
    woodbury_preconditioner,
)
from .laplace import (
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
)
from .laplace_cg import LaplaceCG, LaplaceCGPosterior, laplace_lml_cg, newton_inner_loop_cg
from .vecchia import (
    BandInvRoot,
    NearestNeighbors,
    SparseInvRoot,
    approx_root_prec_band,
    approx_root_prec_sparse,
    band_U_matvec,
    band_Ut_matmul,
    predict_knn,
    resolve_ordering,
)
from .vfe import VFE, optimal_variational_posterior, vfe_elbo
