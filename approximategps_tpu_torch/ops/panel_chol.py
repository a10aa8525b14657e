"""(L, L⁻¹) factorizations: the ports of
``approximategps_tpu/ops/panel_chol.py::pallas_gram_chol_inv`` and
``::pallas_chol_inv``.

``gram_chol_inv(Zs, sig2, jitter, kmap)`` returns L = chol(σ²·g(r²(Zs, Zs))
+ jitter·I) and J = L⁻¹; ``chol_inv(A)`` returns L = chol(sym(A)) and
J = L⁻¹ for a given SPD matrix.  Both are (M, M) with exact zeros above the
diagonal.  On a CUDA tensor each launches a hand-written kernel; on a CPU
tensor each runs its plain version.  :func:`chol_inv` and f64
:func:`gram_chol_inv` take ``csrc/gram_chol_inv.cu`` (one host loop over
64-wide panels, six dependent launches a panel step, which reads the Gram
panel from Zs or A's panel; part "loop"); f32 :func:`gram_chol_inv` takes
``csrc/gram_chol_inv_mma.cu`` (one launch a panel step, the next diagonal
block factored inside the step before it, the products as 3xTF32 ``wgmma``;
part "mma").  :func:`gram_chol_inv_part` chooses, and ``part=`` forces
either where it takes the call.  Neither is differentiable itself: the
autograd Functions of ``core/linalg.py`` and ``models/svgp.py`` wrap them.
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

PANEL = 64  # panel width of csrc/gram_chol_inv.cu
_MAX_D = 64


def gram_chol_inv_supported(M: int, D: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernel takes: any M (padded to a multiple of
    the panel inside), 1 <= D <= 64, f32 or f64."""
    return M >= 1 and 1 <= D <= _MAX_D and dtype in (torch.float32, torch.float64)


def gram_chol_inv_part(M: int, D: int, dtype: torch.dtype) -> str | None:
    """The kernel that serves (M, D, dtype) on the card: "mma"
    (``csrc/gram_chol_inv_mma.cu``) in f32, "loop" (``csrc/gram_chol_inv.cu``)
    in f64, None where neither takes the call (the wrapper raises)."""
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


def _padded_factors(like: torch.Tensor, M: int, part: str = "loop"):
    """Outputs and scratch for the panel loop ("loop") or the panel steps
    ("mma") at Mp = M rounded up to the panel: (L, J, scratch, Mp)."""
    Mp = -(-M // PANEL) * PANEL
    L = torch.empty((Mp, Mp), dtype=like.dtype, device=like.device)
    J = torch.empty((Mp, Mp), dtype=like.dtype, device=like.device)
    # partial tiles of the depth-split products (and the steps' counters)
    lib = _build.load_library()
    size = (lib.agp_gram_chol_inv_mma_scratch if part == "mma" else lib.agp_gram_chol_inv_scratch)
    scratch = torch.empty((size(Mp),), dtype=like.dtype, device=like.device)
    return L, J, scratch, Mp


def _unpad(L, J, M):
    if L.shape[0] != M:
        L, J = L[:M, :M].contiguous(), J[:M, :M].contiguous()
    return L, J


def gram_chol_inv(Zs: torch.Tensor, sig2, jitter, kmap: KernelMap, part: str | None = None):
    """(L, J) = (chol(σ²·g(r²(Zs, Zs)) + jitter·I), L⁻¹).

    Zs: (M, D) inputs with any lengthscale already applied; ``sig2`` and
    ``jitter`` scalars (floats or 0-dim tensors, on the host or the card:
    the kernel reads them from device memory); ``kmap`` the stationary map.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    that :func:`gram_chol_inv_part` names (or ``part``: "loop", or "mma" in
    f32), or raises."""
    if Zs.device.type == "cpu":
        return gram_chol_inv_plain(Zs, sig2, jitter, kmap)
    if not Zs.is_cuda:
        raise ValueError(f"gram_chol_inv: unsupported device {Zs.device}")
    if Zs.ndim != 2 or not gram_chol_inv_supported(Zs.shape[0], Zs.shape[1], Zs.dtype):
        raise ValueError(
            f"gram_chol_inv: needs (M, D) f32/f64 with 1 <= D <= {_MAX_D}, "
            f"got {tuple(Zs.shape)} {Zs.dtype}"
        )
    part = part or gram_chol_inv_part(Zs.shape[0], Zs.shape[1], Zs.dtype)
    if part not in ("mma", "loop") or (part == "mma" and Zs.dtype != torch.float32):
        raise ValueError(f"gram_chol_inv: no {part!r} kernel takes {Zs.dtype} (the panel "
                         "steps of part 'mma': f32)")
    lib = _build.load_library()
    fn = (lib.agp_gram_chol_inv_mma_f32 if part == "mma" else
          lib.agp_gram_chol_inv_f32 if Zs.dtype == torch.float32 else lib.agp_gram_chol_inv_f64)
    Zs = Zs.contiguous()
    M, D = Zs.shape
    coef = torch.empty((2,), dtype=Zs.dtype, device=Zs.device)
    coef[0] = sig2
    coef[1] = jitter
    L, J, scratch, Mp = _padded_factors(Zs, M, part)
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
    jitter before).  A CPU tensor takes the plain version; a CUDA tensor in
    f32 or f64 launches the kernel, anything else raises."""
    if A.device.type == "cpu":
        return chol_inv_plain(A)
    if not A.is_cuda:
        raise ValueError(f"chol_inv: unsupported device {A.device}")
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] < 1 or A.dtype not in (
        torch.float32, torch.float64
    ):
        raise ValueError(f"chol_inv: needs a square f32/f64 matrix, got {tuple(A.shape)} {A.dtype}")
    lib = _build.load_library()
    fn = lib.agp_chol_inv_f32 if A.dtype == torch.float32 else lib.agp_chol_inv_f64
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
