"""Parameter transforms, the SVGP parameter pack, the Adam and L-BFGS
loops, the natural-gradient updates and hybrid step, and the exact-GP
hyperparameter step."""

from . import bijectors, training
from .bijectors import cholesky_parameter, fill_triangular, flat_from_tril, invsoftplus, softplus
from .training import (
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
