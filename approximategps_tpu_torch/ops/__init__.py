"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Importing these modules builds nothing; ``_build.load_library``
runs ``nvcc`` at the first launch."""

from . import panel_chol, svgp_epilogue
from .panel_chol import chol_inv, chol_inv_plain, gram_chol_inv, gram_chol_inv_plain
from .svgp_epilogue import (
    svgp_data_epilogue,
    svgp_data_epilogue_bwd,
    svgp_data_epilogue_bwd_plain,
    svgp_data_epilogue_plain,
)
