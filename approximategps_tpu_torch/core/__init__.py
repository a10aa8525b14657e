"""Core math: kernels, GP objects, distributions, likelihoods, quadrature,
dense linear algebra."""

from . import distributions, gp, kernels, likelihoods, linalg, means, quadrature
from .distributions import DiagNormal, MultivariateNormal, kl_divergence, mvnormal_from_cov
from .gp import (
    GP,
    AbstractGP,
    CholeskyRep,
    FiniteGP,
    LatentFiniteGP,
    LatentGP,
    PosteriorGP,
    logpdf,
    posterior,
    predict_in_blocks,
)
from .kernels import (
    ConstantKernel,
    ExponentialKernel,
    InputScaledKernel,
    Kernel,
    KernelMap,
    KernelMapId,
    LinearKernel,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    PeriodicKernel,
    PolynomialKernel,
    ProductKernel,
    RationalQuadraticKernel,
    RBFKernel,
    ScaledKernel,
    ScaleTransform,
    SEKernel,
    SqExponentialKernel,
    StationaryKernel,
    SumKernel,
    WhiteKernel,
    as_points,
    pairwise_sq_dist,
    unwrap_spectral,
    unwrap_stationary,
    unwrap_stationary_nugget,
    with_lengthscale,
)
from .likelihoods import (
    BernoulliLikelihood,
    ExponentialLikelihood,
    FunctionLikelihood,
    GammaLikelihood,
    GaussianLikelihood,
    GaussNewtonLikelihood,
    Likelihood,
    NegativeBinomialLikelihood,
    PoissonLikelihood,
    StudentTLikelihood,
    as_likelihood,
)
from .linalg import blocked_tril_inv
from .quadrature import (
    Analytic,
    DefaultExpectationMethod,
    GaussHermite,
    MonteCarlo,
    expected_loglikelihood,
)
from .means import ConstMean, FunctionMean, ZeroMean
