"""Parameter transforms, the SVGP parameter pack, the Adam and L-BFGS
loops, the natural-gradient updates and hybrid step, the exact-GP
hyperparameter step, hyperpriors, checkpoints, minibatches and profiling."""

from . import bijectors, checkpoint, data, priors, profiling, training
from .bijectors import (
    cholesky_parameter,
    fill_triangular,
    fill_triangular_inverse,
    flat_from_tril,
    invsoftplus,
    positive,
    softplus,
)
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from .data import epoch_batches, minibatch_iterator
from .priors import (
    gamma_prior,
    halfnormal_prior,
    log_prior,
    lognormal_prior,
    map_objective,
    normal_prior,
)
from .profiling import StepTimer, named_scope, reset_spans, spans, time_fn, trace
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
