"""Approximate-inference models: SVGP serving and training, and the
matrix-free exact GP."""

from . import api, iterative, svgp, svgp_streaming
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
