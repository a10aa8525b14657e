"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Importing these modules builds nothing; ``_build.load_library``
runs ``nvcc`` at the first launch."""

from . import gram_matvec, panel_chol, svgp_epilogue
from .gram_matvec import (
    fused_stationary_matvec,
    gram_matvec_bwd,
    gram_matvec_pass,
    gram_matvec_plain,
)
from .panel_chol import chol_inv, chol_inv_plain, gram_chol_inv, gram_chol_inv_plain
from .svgp_epilogue import (
    svgp_data_epilogue,
    svgp_data_epilogue_bwd,
    svgp_data_epilogue_bwd_plain,
    svgp_data_epilogue_plain,
)
