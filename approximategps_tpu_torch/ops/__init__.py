"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Importing these modules builds nothing; ``_build.load_library``
runs ``nvcc`` at the first launch."""

from . import batched_chol, gram, gram_matvec, knn, panel_chol, svgp_epilogue
from .batched_chol import (
    batched_chol_solve_band,
    batched_chol_solve_band_pass,
    masked_chol_solve_band_math,
    vecchia_band,
    vecchia_band_bwd,
    vecchia_band_bwd_pass,
    vecchia_band_pass,
    vecchia_band_plain,
    vecchia_band_t,
)
from .gram import (
    stationary_gram,
    stationary_gram_bwd,
    stationary_gram_pass,
    stationary_gram_plain,
)
from .gram_matvec import (
    fused_stationary_matvec,
    gram_matvec_bwd,
    gram_matvec_pass,
    gram_matvec_plain,
)
from .knn import knn_search
from .panel_chol import chol_inv, chol_inv_plain, gram_chol_inv, gram_chol_inv_plain
from .svgp_epilogue import (
    svgp_data_epilogue,
    svgp_data_epilogue_bwd,
    svgp_data_epilogue_bwd_plain,
    svgp_data_epilogue_plain,
)
