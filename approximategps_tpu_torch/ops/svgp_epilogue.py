"""Fused SVGP data-term epilogue, forward: the port of
``approximategps_tpu/ops/svgp_epilogue.py::svgp_data_epilogue``.

For a stationary map g and the S-correction cache of ``models/svgp.py``:

    mu_corr  = K0ᵀ ae                 (B,)
    var_corr = diag(K0ᵀ Se K0)        (B,),   K0 = g(r²(Zs, Xs))  (M, B)

On a CUDA tensor the hand-written kernel of ``csrc/svgp_epilogue.cu`` keeps
K0 and Se·K0 out of device memory; on a CPU tensor :func:`svgp_data_epilogue_plain`
forms them.  Both take the inputs jointly centred (exact for a stationary
kernel; it recovers the accuracy the |x|²-identity loses on data far from
the origin), as the JAX package's ``_pad_inputs`` does.  No autograd yet.
"""

from __future__ import annotations

import torch

from ..config import config
from ..core.kernels import KernelMap
from . import _build

__all__ = ["svgp_data_epilogue", "svgp_data_epilogue_plain", "epilogue_block_b"]

_THREADS = 512  # csrc/svgp_epilogue.cu NT
_SMEM_LIMIT = 200 * 1024  # of the 227 KB a block may use on Hopper
_MAX_D = 64


def _smem_bytes(block_b: int, M: int, D: int, itemsize: int) -> int:
    """Dynamic shared memory of one epilogue block (see ``launch`` in the
    .cu file): the (block_b, M) K0 tile, the points, their norms and the
    warp reduction."""
    return (block_b * M + block_b * D + block_b + 2 * (_THREADS // 32) * block_b) * itemsize


def epilogue_block_b(M: int, D: int, dtype: torch.dtype) -> int | None:
    """Test points per CUDA block: the largest of 16, 8, 4 (at most
    ``config.epilogue_block_b``) whose K0 tile fits shared memory, or None
    when none does."""
    if dtype not in (torch.float32, torch.float64) or not 1 <= D <= _MAX_D:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    for bb in (16, 8, 4):
        if bb <= config.epilogue_block_b and _smem_bytes(bb, M, D, itemsize) <= _SMEM_LIMIT:
            return bb
    return None


def _centre(Xs: torch.Tensor, Zs: torch.Tensor):
    c = 0.5 * (Xs.mean(dim=0) + Zs.mean(dim=0))
    return Xs - c, Zs - c


def _k0(Xc: torch.Tensor, Zc: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """K0 (M, B) by the centred matmul identity."""
    zz = torch.sum(Zc * Zc, dim=-1, keepdim=True)
    xx = torch.sum(Xc * Xc, dim=-1, keepdim=True)
    r2 = torch.clamp(zz + xx.T - 2.0 * (Zc @ Xc.T), min=0.0)
    return kmap.k_of_r2(r2)


def svgp_data_epilogue_plain(Xs, Zs, Se, ae, kmap: KernelMap):
    """The plain PyTorch version: K0 and Se·K0 formed in full."""
    Xc, Zc = _centre(Xs, Zs)
    K0 = _k0(Xc, Zc, kmap)
    return K0.T @ ae, torch.sum(K0 * (Se @ K0), dim=0)


def svgp_data_epilogue(Xs: torch.Tensor, Zs: torch.Tensor, Se: torch.Tensor,
                       ae: torch.Tensor, kmap: KernelMap):
    """(mu_corr, var_corr) = (K0ᵀ ae, diag(K0ᵀ Se K0)), K0 = g(r²(Zs, Xs)).

    Xs: (B, D) scaled test inputs; Zs: (M, D) scaled inducing inputs; Se:
    (M, M), exactly symmetric (the kernel reads its upper triangle, the
    plain version all of it); ae: (M,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if Xs.device.type == "cpu":
        return svgp_data_epilogue_plain(Xs, Zs, Se, ae, kmap)
    B, D = Xs.shape
    M = Zs.shape[0]
    dtype = Xs.dtype
    tensors = (Xs, Zs, Se, ae)
    if (
        not all(t.is_cuda and t.device == Xs.device and t.dtype == dtype for t in tensors)
        or Zs.shape != (M, D) or Se.shape != (M, M) or ae.shape != (M,) or B < 1
    ):
        raise ValueError(
            "svgp_data_epilogue: needs Xs (B, D), Zs (M, D), Se (M, M), ae (M,) "
            f"on one CUDA device in one dtype; got {[(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]}"
        )
    block_b = epilogue_block_b(M, D, dtype)
    if block_b is None:
        raise ValueError(
            f"svgp_data_epilogue: no tile fits shared memory at M={M}, D={D}, {dtype}"
        )
    lib = _build.load_library()
    fn = lib.agp_svgp_epilogue_f32 if dtype == torch.float32 else lib.agp_svgp_epilogue_f64
    Xc, Zc = _centre(Xs, Zs)
    Xc, Zc, Se, ae = Xc.contiguous(), Zc.contiguous(), Se.contiguous(), ae.contiguous()
    mu = torch.empty((B,), dtype=dtype, device=Xs.device)
    var = torch.empty((B,), dtype=dtype, device=Xs.device)
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    with torch.cuda.device(Xs.device):
        err = fn(Xc.data_ptr(), Zc.data_ptr(), Se.data_ptr(), ae.data_ptr(),
                 mu.data_ptr(), var.data_ptr(), B, M, D, block_b, int(kmap.id), stream)
    _build.check(err, "svgp_data_epilogue")
    svgp_data_epilogue.launches += 1
    return mu, var


svgp_data_epilogue.launches = 0
