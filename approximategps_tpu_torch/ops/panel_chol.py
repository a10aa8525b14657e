"""Gram-fused (L, L⁻¹) factorization: the port of
``approximategps_tpu/ops/panel_chol.py::pallas_gram_chol_inv``.

``gram_chol_inv(Zs, sig2, jitter, kmap)`` returns L = chol(σ²·g(r²(Zs, Zs))
+ jitter·I) and J = L⁻¹, both (M, M) with exact zeros above the diagonal.
On a CUDA tensor it launches the hand-written kernel of
``csrc/gram_chol_inv.cu`` (a host loop over 64-wide panels; see the note
there); on a CPU tensor it runs :func:`gram_chol_inv_plain`.
"""

from __future__ import annotations

import torch

from ..core.kernels import KernelMap, pairwise_sq_dist
from ..core.linalg import chol_with_inv_plain
from . import _build

__all__ = ["PANEL", "gram_chol_inv", "gram_chol_inv_plain", "gram_chol_inv_supported"]

PANEL = 64  # panel width of csrc/gram_chol_inv.cu
_MAX_D = 64


def gram_chol_inv_supported(M: int, D: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernel takes: any M (padded to a multiple of
    the panel inside), 1 <= D <= 64, f32 or f64."""
    return M >= 1 and 1 <= D <= _MAX_D and dtype in (torch.float32, torch.float64)


def gram_chol_inv_plain(Zs: torch.Tensor, sig2, jitter, kmap: KernelMap):
    """The plain PyTorch version: the Gram from exact broadcast distances,
    then torch.linalg's Cholesky and triangular inverse."""
    r2 = pairwise_sq_dist(Zs, Zs, mode="broadcast")
    eye = torch.eye(Zs.shape[0], dtype=Zs.dtype, device=Zs.device)
    K = sig2 * kmap.k_of_r2(r2) + jitter * eye
    return chol_with_inv_plain(K)


def gram_chol_inv(Zs: torch.Tensor, sig2, jitter, kmap: KernelMap):
    """(L, J) = (chol(σ²·g(r²(Zs, Zs)) + jitter·I), L⁻¹).

    Zs: (M, D) inputs with any lengthscale already applied; ``sig2`` and
    ``jitter`` scalars (floats or 0-dim tensors); ``kmap`` the stationary
    map.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if Zs.device.type == "cpu":
        return gram_chol_inv_plain(Zs, sig2, jitter, kmap)
    if not Zs.is_cuda:
        raise ValueError(f"gram_chol_inv: unsupported device {Zs.device}")
    if Zs.ndim != 2 or not gram_chol_inv_supported(Zs.shape[0], Zs.shape[1], Zs.dtype):
        raise ValueError(
            f"gram_chol_inv: needs (M, D) f32/f64 with 1 <= D <= {_MAX_D}, "
            f"got {tuple(Zs.shape)} {Zs.dtype}"
        )
    lib = _build.load_library()
    fn = lib.agp_gram_chol_inv_f32 if Zs.dtype == torch.float32 else lib.agp_gram_chol_inv_f64
    Zs = Zs.contiguous()
    M, D = Zs.shape
    Mp = -(-M // PANEL) * PANEL
    L = torch.empty((Mp, Mp), dtype=Zs.dtype, device=Zs.device)
    J = torch.empty((Mp, Mp), dtype=Zs.dtype, device=Zs.device)
    # partial tiles of the depth-split products
    scratch = torch.empty((lib.agp_gram_chol_inv_scratch(Mp),), dtype=Zs.dtype, device=Zs.device)
    stream = torch.cuda.current_stream(Zs.device).cuda_stream
    with torch.cuda.device(Zs.device):
        err = fn(Zs.data_ptr(), L.data_ptr(), J.data_ptr(), scratch.data_ptr(), M, Mp, D,
                 float(sig2), float(jitter), int(kmap.id), stream)
    _build.check(err, "gram_chol_inv")
    gram_chol_inv.launches += 1
    if Mp != M:
        L, J = L[:M, :M].contiguous(), J[:M, :M].contiguous()
    return L, J


gram_chol_inv.launches = 0
