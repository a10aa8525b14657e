"""Numerics-policy switches for approximategps_tpu_torch.

The PyTorch counterpart of ``approximategps_tpu/config.py``, cut to the
knobs the SVGP serving and training paths and the matrix-free exact-GP
and Laplace paths read.  Like the JAX package, this holds only
switches that must agree across a whole computation (solve strategy,
factorization and data-term routes), never model options.

Where the JAX package says "on TPU" (``compute_dtype="auto"``, the
``"auto"`` routes), the port reads "on the kernel device"
(:func:`kernel_device`).  Value names differ from the JAX package where
they named TPU machinery:
``use_pallas`` is ``use_kernels``, the ``"pallas"`` / ``"xla"`` routes are
``"auto"`` / ``"plain"``, the ``"mxu"`` distance mode is ``"matmul"``, and
the ``"pallas"`` Gram mode is ``"fused"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator

import torch


@dataclasses.dataclass
class _Config:
    # Pairwise-distance implementation for Gram matrices:
    #   "broadcast": exact (x - z)**2 broadcasting
    #   "matmul":    |x|^2 + |z|^2 - 2 x z^T on centred inputs
    #   "fused":     non-symmetric Grams of a kernel with a CUDA map through
    #                the fused Gram kernel (ops/gram.stationary_gram: the
    #                kernel on a CUDA tensor, its plain version on the CPU);
    #                symmetric Grams take broadcast and maps with a
    #                parameter (rational quadratic, periodic) matmul
    #   "auto":      broadcast below gram_auto_threshold (N*M*D), else
    #                matmul; never fused, as in the JAX package
    gram_mode: str = os.environ.get("AGP_GRAM_MODE", "auto")
    gram_auto_threshold: int = 1 << 22
    # Whether the hand-written CUDA kernels may serve at all.  A wrapper
    # given a CPU tensor runs its plain PyTorch version instead.
    use_kernels: bool = os.environ.get("AGP_USE_KERNELS", "1") == "1"
    # SVGP projection strategy (see resolve_solve_mode):
    #   "triangular": triangular solves against chol(Kuu)
    #   "inv_matmul": precompute Lk⁻¹ once; builds the S-correction cache
    #                 that both serving kernels consume
    #   "auto":       inv_matmul on the kernel device at M >= 512
    solve_mode: str = os.environ.get("AGP_SOLVE_MODE", "auto")
    # (L, L⁻¹) factorization route of chol_with_inv and the posterior build:
    # "auto" (the kernels) or "plain" (cuSOLVER / LAPACK through
    # torch.linalg).
    chol_mode: str = os.environ.get("AGP_CHOL_MODE", "auto")
    # Gram-fused posterior build: "auto" generates Kuu inside the (L, L⁻¹)
    # kernel (ops/panel_chol.gram_chol_inv); "off" builds Kuu first.
    gram_chol: str = os.environ.get("AGP_GRAM_CHOL", "auto")
    # SVGP data term: "auto" takes the fused epilogue kernel where the caller
    # prefers it (the serving sweep and the streaming ELBO, whose plain
    # blocks would recompute the (M, B) Gram in the backward anyway) and
    # the plain route for the minibatch ELBO; "plain" takes the Gram and
    # diag_quad_sym in PyTorch everywhere.
    data_term_mode: str = os.environ.get("AGP_DATA_TERM_MODE", "auto")
    # Largest test-point tile one CUDA block of the epilogue's SIMT forward
    # (f64, and f32 with D > 8) owns (16, 8 or 4); the wrapper halves it
    # until the (block_b, M) K tile fits shared memory, and the sweep raises
    # on CUDA where none fits.  The f32 tensor-core forward has no such tile.
    epilogue_block_b: int = int(os.environ.get("AGP_EPILOGUE_BLOCK_B", "16"))
    # Largest M for which the posterior build forms the S-correction matrix
    # S = Lk⁻ᵀ(BBᵀ−I)Lk⁻¹ (the cache the fused epilogue consumes).
    s_corr_max_m: int = int(os.environ.get("AGP_S_CORR_MAX_M", "4096"))
    # Storage dtype of the SVGP's (M, B) projection intermediates (Kuf, A,
    # BᵀA, S·Kuf; models/svgp.py::_storage_dtype):
    #   "auto":     bf16 storage for f32 tensors on the kernel device at
    #               M >= bf16_storage_min_m, f32 otherwise (the CPU never
    #               downcasts)
    #   "float32":  full width everywhere
    #   "bfloat16": bf16 storage for f32 tensors at any M and on any device
    # bf16 is a storage type only: the products accumulate in f32 (cuBLAS),
    # every reduction over M or B is taken in f32, and the master
    # parameters, Kuu's factor, L⁻¹, the KL and the pullbacks' M×M
    # products stay f32.  f64 is never downcast.
    compute_dtype: str = os.environ.get("AGP_COMPUTE_DTYPE", "auto")
    # Smallest M at which compute_dtype="auto" stores the projections in
    # bf16 on the kernel device; its own knob, apart from tri_matmul_min_m.
    bf16_storage_min_m: int = int(os.environ.get("AGP_BF16_STORAGE_MIN_M", "4096"))
    # Smallest M at which the chol/inv pullback's Φ-sandwich, the whitened
    # cache's pullback and the SVGP projections take the triangular-aware
    # block products (core/linalg.py::matmul_left_upper and the rest),
    # which skip the zero half of a triangular factor (about 44 % of the
    # flops at 8 blocks).
    tri_matmul_min_m: int = int(os.environ.get("AGP_TRI_MATMUL_MIN_M", "4096"))
    # K·V in the matrix-free tier (models/iterative.py, ops/gram_matvec.py):
    #   "auto":  the fused gram_matvec kernel on the kernel device, the plain
    #            block path (Gram blocks and a matmul) elsewhere
    #   "fused": the gram_matvec autograd Function on any device, with its
    #            plain inner pass on the CPU (the tests' mode)
    #   "plain": always the block path
    # The JAX package's cg_matvec_precision counts TPU matmul passes and has
    # no counterpart: the port's matmuls in CG, the preconditioner and
    # pivoted_cholesky run in full f32, with TF32 off
    # (torch.backends.cuda.matmul.allow_tf32 False, PyTorch's default).
    matvec_mode: str = os.environ.get("AGP_MATVEC_MODE", "auto")
    # Widest (N, R) block the fused matvec takes; wider blocks take the
    # block path, where one Gram serves every column.
    matvec_fused_max_rhs: int = int(os.environ.get("AGP_MATVEC_MAX_RHS", "32"))
    # The Laplace CG tier's storage="auto" (models/laplace_cg.py) where the
    # fused kernel does not run (the CPU, a kernel it does not take): N at or
    # below this builds the N × N Gram once a solve and multiplies with it
    # (2.4 GB in f32 at 24576); above it, every K·V is a kernel_matvec's
    # Gram blocks, in O(N·block) memory.  Where the kernel runs, "auto"
    # always takes it: on the H100 its product outruns one with a stored
    # Gram (exps against the Gram's bytes; chip_smoke.py phase 15).
    cg_dense_threshold: int = int(os.environ.get("AGP_CG_DENSE_N", "24576"))


config = _Config()


def kernel_device(t: torch.Tensor) -> bool:
    """The one device gate: True where the hand-written kernels serve — a
    CUDA tensor in f32 or f64.  Takes the place of the JAX package's
    ``jax.default_backend() == "tpu"`` checks."""
    return t.is_cuda and t.dtype in (torch.float32, torch.float64)


def kernels_take(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper may be called for ``t``: kernels allowed,
    and ``t`` either on the kernel device or on the CPU, where the wrapper
    runs the kernel's plain version."""
    return config.use_kernels and (t.device.type == "cpu" or kernel_device(t))


def resolve_solve_mode(t: torch.Tensor, size: int | None = None) -> str:
    """The effective solve_mode: "auto" becomes "inv_matmul" on the kernel
    device at M >= 512 (``size`` = M) and "triangular" otherwise, as the
    JAX package does on the TPU.  Without it no S-correction cache is built
    and neither serving kernel runs."""
    mode = config.solve_mode
    if mode != "auto":
        return mode
    if kernel_device(t) and (size is None or size >= 512):
        return "inv_matmul"
    return "triangular"


def set_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise AttributeError(f"unknown config key: {k}")
        setattr(config, k, v)


@contextlib.contextmanager
def config_context(**kwargs) -> Iterator[None]:
    old = {k: getattr(config, k) for k in kwargs}
    set_config(**kwargs)
    try:
        yield
    finally:
        set_config(**old)
