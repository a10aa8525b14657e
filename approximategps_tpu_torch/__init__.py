"""approximategps_tpu_torch — the PyTorch / CUDA port of approximategps_tpu.

A second package beside the JAX one, which stays the reference.  This
slice carries the SVGP serving path: a NonCentered posterior built from
given parameters (``posterior``), then a mean-and-variance sweep over a large
test set (``SVGPPosterior.predict_blocks``).  Two hand-written CUDA kernels
for Hopper (``csrc/``) carry it on the GPU, each beside a plain PyTorch
version that CPU tensors take:

- ``ops.panel_chol.gram_chol_inv``: (L, L⁻¹) with the Kuu Gram generated
  inside the factorization;
- ``ops.svgp_epilogue.svgp_data_epilogue``: (mean, var) without the (M, B)
  cross-covariance in device memory.

The kernels are built with ``nvcc`` at first use (``ops/_build.py``).
"""

from . import config as _config_module
from . import convert, core, models, ops, utils
from .config import config, config_context, set_config
from .core import (
    GP,
    AbstractGP,
    ExponentialKernel,
    FiniteGP,
    InputScaledKernel,
    Kernel,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    MultivariateNormal,
    RBFKernel,
    ScaledKernel,
    SEKernel,
    SqExponentialKernel,
    StationaryKernel,
    with_lengthscale,
)
from .models import (
    Centered,
    NonCentered,
    SparseVariationalApproximation,
    SVGPPosterior,
    approx_lml,
    posterior,
)
from .utils import SVGPParams, build_svgp, init_svgp_params

__all__ = [
    "config",
    "config_context",
    "set_config",
    "GP",
    "AbstractGP",
    "FiniteGP",
    "Kernel",
    "StationaryKernel",
    "SqExponentialKernel",
    "SEKernel",
    "RBFKernel",
    "Matern12Kernel",
    "ExponentialKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "ScaledKernel",
    "InputScaledKernel",
    "with_lengthscale",
    "MultivariateNormal",
    "Centered",
    "NonCentered",
    "SparseVariationalApproximation",
    "SVGPPosterior",
    "posterior",
    "approx_lml",
    "SVGPParams",
    "init_svgp_params",
    "build_svgp",
]
