"""Approximate-inference models: SVGP serving and training, VFE, the
matrix-free exact GP and its Lanczos samplers, the Laplace approximation
(dense and matrix-free), Vecchia serving and training, block-Vecchia,
pathwise sampling, the multi-latent and online SVGPs, and leave-one-out
cross-validation."""

from . import (api, block_vecchia, crossval, iterative, laplace, laplace_cg, multi_latent,
               sampling, svgp, svgp_online, svgp_streaming, vecchia, vfe)
from .api import approx_lml, posterior
from .crossval import loo_logpdf, loo_mean_and_var
from .multi_latent import (
    HeteroscedasticGaussianLikelihood,
    MultiLatentSVGP,
    SoftmaxLikelihood,
    multi_latent_elbo,
)
from .sampling import rff_features, sample_posterior_functions_cg, sample_svgp_functions
from .svgp_online import (
    GaussianSiteState,
    OnlineSVGPState,
    online_elbo,
    online_optimal_q,
    online_state,
    site_posterior_q,
    site_state,
    site_update,
)
from .block_vecchia import BlockInvRoot, BlockNearestNeighbors, block_vecchia_factors
from .svgp import (
    SVGP,
    Centered,
    NonCentered,
    SparseVariationalApproximation,
    SVGPPosterior,
    elbo,
    inducing_points,
    prior_kl,
)
from .svgp_streaming import dp_streaming_elbo, streaming_data_term, streaming_elbo
from .iterative import (
    CGPosterior,
    cg_solve,
    kernel_matvec,
    logpdf_slq,
    msqrt_matvec,
    pivoted_cholesky,
    posterior_cg,
    sample_posterior_msqrt,
    sample_prior_msqrt,
    woodbury_preconditioner,
)
from .laplace import (
    LaplaceApproximation,
    LaplaceObjective,
    LaplacePosterior,
    LaplaceResult,
    build_laplace_objective,
    laplace_f_and_lml,
    laplace_f_cov,
    laplace_lml,
    laplace_steps,
    laplace_steps_scan,
    newton_inner_loop,
    newton_inner_loop_jvp,
    newton_multistart,
)
from .laplace_cg import LaplaceCG, LaplaceCGPosterior, laplace_lml_cg, newton_inner_loop_cg
from .vecchia import (
    BandInvRoot,
    NearestNeighbors,
    SparseInvRoot,
    approx_root_prec_band,
    approx_root_prec_sparse,
    band_U_matvec,
    band_Ut_matmul,
    predict_knn,
    resolve_ordering,
)
from .vfe import VFE, optimal_variational_posterior, vfe_elbo
