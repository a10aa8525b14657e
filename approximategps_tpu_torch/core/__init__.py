"""Core math: kernels, GP objects, distributions, dense linear algebra."""

from . import distributions, gp, kernels, linalg, means
from .distributions import MultivariateNormal
from .gp import GP, AbstractGP, FiniteGP
from .kernels import (
    ExponentialKernel,
    InputScaledKernel,
    Kernel,
    KernelMap,
    KernelMapId,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    RBFKernel,
    ScaledKernel,
    SEKernel,
    SqExponentialKernel,
    StationaryKernel,
    as_points,
    pairwise_sq_dist,
    unwrap_stationary,
    with_lengthscale,
)
from .means import ConstMean, FunctionMean, ZeroMean
