"""Approximate-inference models: the SVGP serving path."""

from . import api, svgp
from .api import approx_lml, posterior
from .svgp import Centered, NonCentered, SparseVariationalApproximation, SVGPPosterior
