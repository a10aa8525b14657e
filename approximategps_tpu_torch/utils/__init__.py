"""Parameter transforms and the SVGP parameter pack."""

from . import bijectors, training
from .bijectors import cholesky_parameter, fill_triangular, flat_from_tril, invsoftplus, softplus
from .training import SVGPParams, build_svgp, init_svgp_params
