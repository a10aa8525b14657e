"""Parameter transforms, the SVGP parameter pack, the Adam loop and the
exact-GP hyperparameter step."""

from . import bijectors, training
from .bijectors import cholesky_parameter, fill_triangular, flat_from_tril, invsoftplus, softplus
from .training import (
    SVGPParams,
    adam_fit,
    build_svgp,
    init_svgp_params,
    make_slq_hyperopt_step,
)
