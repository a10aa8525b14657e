"""(L, L⁻¹) factorizations: the ports of
``approximategps_tpu/ops/panel_chol.py::pallas_gram_chol_inv`` (row 1 of
the kernel table) and ``::pallas_chol_inv`` (row 4).

``gram_chol_inv(Zs, sig2, jitter, kmap)`` returns L = chol(σ²·g(r²(Zs, Zs))
+ jitter·I) and J = L⁻¹; ``chol_inv(A)`` returns L = chol(sym(A)) and
J = L⁻¹ for a given SPD matrix.  Both are (M, M) with exact zeros above the
diagonal.  On a CPU tensor each runs its plain version.  On a CUDA tensor
each launches a hand-written kernel chosen by dtype alone
(:func:`gram_chol_inv_part`): f32 takes ``csrc/gram_chol_inv_mma.cu`` (one
launch a panel step, the next diagonal block factored inside the step
before it, the products as 3xTF32 ``wgmma``; K's tiles generated from Zs,
or A's tiles read and symmetrized), f64 ``csrc/gram_chol_inv.cu`` (one
host loop over 64-wide panels, six dependent launches a panel step).
Anything else raises.  Neither is differentiable itself: the autograd
Functions of ``core/linalg.py`` and ``models/svgp.py`` wrap them.
"""

from __future__ import annotations

import torch

from ..core.kernels import KernelMap, pairwise_sq_dist
from ..core.linalg import chol_with_inv_plain
from . import _build

__all__ = [
    "PANEL",
    "gram_chol_inv",
    "gram_chol_inv_part",
    "gram_chol_inv_plain",
    "gram_chol_inv_supported",
    "chol_inv",
    "chol_inv_plain",
]

PANEL = 64  # panel width of both kernels
_MAX_D = 64


def gram_chol_inv_supported(M: int, D: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernel takes: any M (padded to a multiple of
    the panel inside), 1 <= D <= 64, f32 or f64."""
    return M >= 1 and 1 <= D <= _MAX_D and dtype in (torch.float32, torch.float64)


def gram_chol_inv_part(M: int, D: int, dtype: torch.dtype) -> str | None:
    """The kernel that serves (M, D, dtype) on the card, by dtype alone (as
    for :func:`chol_inv`): "mma" (``csrc/gram_chol_inv_mma.cu``, the panel
    steps) in f32, "loop" (``csrc/gram_chol_inv.cu``, the host loop) in f64,
    None where neither takes the call (the wrapper raises)."""
    if not gram_chol_inv_supported(M, D, dtype):
        return None
    return "mma" if dtype == torch.float32 else "loop"


def gram_chol_inv_plain(Zs: torch.Tensor, sig2, jitter, kmap: KernelMap):
    """The plain PyTorch version: the Gram from exact broadcast distances,
    then torch.linalg's Cholesky and triangular inverse."""
    r2 = pairwise_sq_dist(Zs, Zs, mode="broadcast")
    eye = torch.eye(Zs.shape[0], dtype=Zs.dtype, device=Zs.device)
    K = sig2 * kmap.k_of_r2(r2) + jitter * eye
    return chol_with_inv_plain(K)


def _padded_factors(like: torch.Tensor, M: int):
    """Outputs and scratch at Mp = M rounded up to the panel, for the
    kernel of ``like``'s dtype (the panel steps' partial tiles and counters
    in f32, the host loop's partial tiles in f64): (L, J, scratch, Mp)."""
    Mp = -(-M // PANEL) * PANEL
    L = torch.empty((Mp, Mp), dtype=like.dtype, device=like.device)
    J = torch.empty((Mp, Mp), dtype=like.dtype, device=like.device)
    lib = _build.load_library()
    size = (lib.agp_gram_chol_inv_mma_scratch if like.dtype == torch.float32
            else lib.agp_gram_chol_inv_scratch)
    scratch = torch.empty((size(Mp),), dtype=like.dtype, device=like.device)
    return L, J, scratch, Mp


def _coef(sig2, jitter, like: torch.Tensor) -> torch.Tensor:
    """(σ², jitter) as a two-element array on ``like``'s device, with no
    copy from the host: a float is written by a fill kernel (an indexed
    assignment of a float would copy it from the host), a tensor on the
    card by a device copy, a CPU tensor read as a float first."""
    coef = torch.empty((2,), dtype=like.dtype, device=like.device)
    for slot, v in zip(coef, (sig2, jitter)):
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            slot.copy_(v)
        else:
            slot.fill_(float(v))
    return coef


def _unpad(L, J, M):
    if L.shape[0] != M:
        L, J = L[:M, :M].contiguous(), J[:M, :M].contiguous()
    return L, J


def gram_chol_inv(Zs: torch.Tensor, sig2, jitter, kmap: KernelMap):
    """(L, J) = (chol(σ²·g(r²(Zs, Zs)) + jitter·I), L⁻¹).

    Zs: (M, D) inputs with any lengthscale already applied; ``sig2`` and
    ``jitter`` scalars (floats or 0-dim tensors; the kernel reads them from
    device memory, filled without a copy from the host); ``kmap`` the
    stationary map.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel of its dtype (:func:`gram_chol_inv_part`), or
    raises."""
    if Zs.device.type == "cpu":
        return gram_chol_inv_plain(Zs, sig2, jitter, kmap)
    if not Zs.is_cuda:
        raise ValueError(f"gram_chol_inv: unsupported device {Zs.device}")
    part = gram_chol_inv_part(*Zs.shape, Zs.dtype) if Zs.ndim == 2 else None
    if part is None:
        raise ValueError(
            f"gram_chol_inv: needs (M, D) f32/f64 with 1 <= D <= {_MAX_D}, "
            f"got {tuple(Zs.shape)} {Zs.dtype}"
        )
    lib = _build.load_library()
    fn = lib.agp_gram_chol_inv_mma_f32 if part == "mma" else lib.agp_gram_chol_inv_f64
    Zs = Zs.contiguous()
    M, D = Zs.shape
    coef = _coef(sig2, jitter, Zs)
    L, J, scratch, Mp = _padded_factors(Zs, M)
    stream = torch.cuda.current_stream(Zs.device).cuda_stream
    with torch.cuda.device(Zs.device):
        err = fn(Zs.data_ptr(), coef.data_ptr(), L.data_ptr(), J.data_ptr(), scratch.data_ptr(),
                 M, Mp, D, int(kmap.id), stream)
    _build.check(err, "gram_chol_inv")
    gram_chol_inv.launches += 1
    return _unpad(L, J, M)


gram_chol_inv.launches = 0


def chol_inv_plain(A: torch.Tensor):
    """The plain PyTorch version of :func:`chol_inv`: torch.linalg's
    Cholesky of sym(A) and triangular inverse."""
    return chol_with_inv_plain(A)


def chol_inv(A: torch.Tensor):
    """(L, J) = (chol(sym(A)), L⁻¹) for an SPD (M, M) matrix (add any
    jitter before).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel of its dtype (the panel steps in f32, the host loop
    in f64), anything else raises."""
    if A.device.type == "cpu":
        return chol_inv_plain(A)
    if not A.is_cuda:
        raise ValueError(f"chol_inv: unsupported device {A.device}")
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] < 1 or A.dtype not in (
        torch.float32, torch.float64
    ):
        raise ValueError(f"chol_inv: needs a square f32/f64 matrix, got {tuple(A.shape)} {A.dtype}")
    lib = _build.load_library()
    fn = lib.agp_chol_inv_mma_f32 if A.dtype == torch.float32 else lib.agp_chol_inv_f64
    A = A.contiguous()
    M = A.shape[0]
    L, J, scratch, Mp = _padded_factors(A, M)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), L.data_ptr(), J.data_ptr(), scratch.data_ptr(), M, Mp, stream)
    _build.check(err, "chol_inv")
    chol_inv.launches += 1
    return _unpad(L, J, M)


chol_inv.launches = 0
