"""Approximate-inference models: SVGP serving and training, VFE, the
matrix-free exact GP, Vecchia serving and training, and block-Vecchia."""

from . import api, block_vecchia, iterative, svgp, svgp_streaming, vecchia, vfe
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
    pivoted_cholesky,
    posterior_cg,
    woodbury_preconditioner,
)
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
