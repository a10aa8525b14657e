"""Approximate-inference models: SVGP serving and training, the
matrix-free exact GP and Vecchia serving and training."""

from . import api, iterative, svgp, svgp_streaming, vecchia
from .api import approx_lml, posterior
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
