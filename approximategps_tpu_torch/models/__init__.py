"""Approximate-inference models: SVGP serving and training."""

from . import api, svgp, svgp_streaming
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
