"""Fused SVGP data-term epilogue and its pullback: the port of
``approximategps_tpu/ops/svgp_epilogue.py::svgp_data_epilogue`` (forward,
``_epilogue_fwd_impl``; backward, ``_bwd_fused``).

For a stationary map g and the S-correction cache of ``models/svgp.py``:

    mu_corr  = K0ᵀ ae                 (B,)
    var_corr = diag(K0ᵀ Se K0)        (B,),   K0 = g(r²(Zs, Xs))  (M, B)

:func:`svgp_data_epilogue` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward are hand-written kernels that keep K0 and
Se·K0 out of device memory, chosen by :func:`epilogue_part` from dtype, M
and D: in f32 with D <= 8 the tensor-core kernels (3xTF32 ``wgmma``;
``csrc/svgp_epilogue_mma.cu``, ``csrc/svgp_epilogue_bwd_mma.cu``), any M;
otherwise (f64 always) the SIMT kernels (``csrc/svgp_epilogue.cu``, whose
forward needs its (block_b, M) K0 tile in shared memory, and
``csrc/svgp_epilogue_bwd.cu``).  An explicit ``part`` forces either where
it takes the call.  On CPU tensors the forward is
:func:`svgp_data_epilogue_plain` and the backward
:func:`svgp_data_epilogue_bwd_plain`, which form them.  All take the inputs
jointly centred (exact for a stationary kernel; it recovers the accuracy the
|x|²-identity loses on data far from the origin), as the JAX package's
``_pad_inputs`` does; the centring needs no pullback, since the cotangents
of a joint shift sum to zero.
"""

from __future__ import annotations

import torch

from ..config import config
from ..core.kernels import KernelMap, dk_from_k_for
from . import _build

__all__ = [
    "svgp_data_epilogue",
    "svgp_data_epilogue_plain",
    "svgp_data_epilogue_bwd",
    "svgp_data_epilogue_bwd_plain",
    "epilogue_block_b",
    "epilogue_bwd_scratch",
    "epilogue_part",
]

_THREADS = 512  # csrc/svgp_epilogue.cu NT
_SMEM_LIMIT = 200 * 1024  # of the 227 KB a block may use on Hopper
_MAX_D = 64
_MMA_MAX_D = 8  # the tensor-core kernels' coordinates live in registers


def _smem_bytes(block_b: int, M: int, D: int, itemsize: int) -> int:
    """Dynamic shared memory of one epilogue block (see ``launch`` in the
    .cu file): the (block_b, M) K0 tile, the points, their norms and the
    warp reduction."""
    return (block_b * M + block_b * D + block_b + 2 * (_THREADS // 32) * block_b) * itemsize


def epilogue_block_b(M: int, D: int, dtype: torch.dtype) -> int | None:
    """Test points per CUDA block of the SIMT forward (f64, and f32 with
    D > 8): the largest of 16, 8, 4 (at most ``config.epilogue_block_b``)
    whose K0 tile fits shared memory, or None when none does."""
    if dtype not in (torch.float32, torch.float64) or not 1 <= D <= _MAX_D:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    for bb in (16, 8, 4):
        if bb <= config.epilogue_block_b and _smem_bytes(bb, M, D, itemsize) <= _SMEM_LIMIT:
            return bb
    return None


def _mma_takes(D: int, dtype: torch.dtype) -> bool:
    return dtype == torch.float32 and 1 <= D <= _MMA_MAX_D


def epilogue_part(M: int, D: int, dtype: torch.dtype) -> str | None:
    """The forward kernel that serves (M, D, dtype) on the card: "mma" (the
    tensor cores, no shared-memory tile of M, so any M) in f32 with
    1 <= D <= 8; else "simt" where :func:`epilogue_block_b` finds its K0
    tile a place in shared memory; else None (the wrapper raises).  The
    backward takes "mma" where this does, and "simt" for every other f32 or
    f64 call with D <= 64."""
    if _mma_takes(D, dtype):
        return "mma"
    return "simt" if epilogue_block_b(M, D, dtype) is not None else None


def _centre(Xs: torch.Tensor, Zs: torch.Tensor):
    c = 0.5 * (Xs.mean(dim=0) + Zs.mean(dim=0))
    return Xs - c, Zs - c


def _r2(Xc: torch.Tensor, Zc: torch.Tensor) -> torch.Tensor:
    """r² (M, B) by the centred matmul identity, clamped at 0."""
    zz = torch.sum(Zc * Zc, dim=-1, keepdim=True)
    xx = torch.sum(Xc * Xc, dim=-1, keepdim=True)
    return torch.clamp(zz + xx.T - 2.0 * (Zc @ Xc.T), min=0.0)


def svgp_data_epilogue_plain(Xs, Zs, Se, ae, kmap: KernelMap):
    """The plain PyTorch version: K0 and Se·K0 formed in full."""
    Xc, Zc = _centre(Xs, Zs)
    K0 = kmap.k_of_r2(_r2(Xc, Zc))
    return K0.T @ ae, torch.sum(K0 * (Se @ K0), dim=0)


def _check(what, tensors, B, M, D):
    Xs, Zs, Se, ae = tensors[:4]
    dtype = Xs.dtype
    if (
        not all(t.is_cuda and t.device == Xs.device and t.dtype == dtype for t in tensors)
        or Zs.shape != (M, D) or Se.shape != (M, M) or ae.shape != (M,) or B < 1
        or any(t.shape != (B,) for t in tensors[4:])
    ):
        raise ValueError(
            f"{what}: needs Xs (B, D), Zs (M, D), Se (M, M), ae (M,) and (B,) cotangents "
            "on one CUDA device in one dtype; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]}"
        )


def _part(what, part, default, D, dtype):
    part = part or default
    if part not in ("simt", "mma") or (part == "mma" and not _mma_takes(D, dtype)):
        raise ValueError(f"{what}: no {part!r} kernel takes {dtype}, D={D} "
                         f"(the tensor-core kernels: f32, D <= {_MMA_MAX_D})")
    return part


def _forward(Xs, Zs, Se, ae, kmap: KernelMap, part: str | None = None):
    if Xs.device.type == "cpu":
        return svgp_data_epilogue_plain(Xs, Zs, Se, ae, kmap)
    B, D = Xs.shape
    M = Zs.shape[0]
    dtype = Xs.dtype
    _check("svgp_data_epilogue", (Xs, Zs, Se, ae), B, M, D)
    part = _part("svgp_data_epilogue", part, epilogue_part(M, D, dtype) or "simt", D, dtype)
    block_b = epilogue_block_b(M, D, dtype)
    if part == "simt" and block_b is None:
        raise ValueError(
            f"svgp_data_epilogue: no tile of the SIMT kernel fits shared memory at M={M}, "
            f"D={D}, {dtype}"
        )
    lib = _build.load_library()
    Xc, Zc = _centre(Xs, Zs)
    Xc, Zc, Se, ae = Xc.contiguous(), Zc.contiguous(), Se.contiguous(), ae.contiguous()
    mu = torch.empty((B,), dtype=dtype, device=Xs.device)
    var = torch.empty((B,), dtype=dtype, device=Xs.device)
    ptrs = (Xc.data_ptr(), Zc.data_ptr(), Se.data_ptr(), ae.data_ptr(), mu.data_ptr(),
            var.data_ptr())
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    with torch.cuda.device(Xs.device):
        if part == "mma":
            # Se split into TF32 halves in the kernels' layout, once a call
            scratch = torch.empty((lib.agp_svgp_epilogue_mma_scratch_f32(M, D),), dtype=dtype,
                                  device=Xs.device)
            err = lib.agp_svgp_epilogue_mma_f32(*ptrs, scratch.data_ptr(), B, M, D,
                                                int(kmap.id), stream)
        else:
            fn = (lib.agp_svgp_epilogue_f32 if dtype == torch.float32
                  else lib.agp_svgp_epilogue_f64)
            err = fn(*ptrs, B, M, D, block_b, int(kmap.id), stream)
    _build.check(err, "svgp_data_epilogue")
    svgp_data_epilogue.launches += 1
    return mu, var


def svgp_data_epilogue_bwd_plain(Xs, Zs, Se, ae, dmu, dvar, kmap: KernelMap):
    """The plain PyTorch version of the pullback, in closed form with K0
    formed in full (the formula the kernel implements, not autograd of the
    plain forward):

        S̄e = (K0∘dvar) K0ᵀ,   āe = K0 dmu,
        W  = (2 (Se K0)∘dvar + ae⊗dmu) ∘ g′(r²),
        X̄s = 2 (xs∘colsum W − Wᵀ Zs),   Z̄s = 2 (zs∘rowsum W − W Xs).

    g′ comes through K0 where the map allows it (SE: −½K0), as in the JAX
    package.  Returns (X̄s, Z̄s, S̄e, āe)."""
    Xc, Zc = _centre(Xs, Zs)
    r2 = _r2(Xc, Zc)
    K0 = kmap.k_of_r2(r2)
    dk = dk_from_k_for(kmap)
    gprime = dk(K0) if dk is not None else kmap.dk_of_r2(r2)
    Se_bar = (K0 * dvar) @ K0.T
    ae_bar = K0 @ dmu
    W = (2.0 * (Se @ K0) * dvar + ae[:, None] * dmu) * gprime
    Xs_bar = 2.0 * (Xc * torch.sum(W, dim=0)[:, None] - W.T @ Zc)
    Zs_bar = 2.0 * (Zc * torch.sum(W, dim=1)[:, None] - W @ Xc)
    return Xs_bar, Zs_bar, Se_bar, ae_bar


def _bwd_entry(part: str, dtype: torch.dtype):
    """The pullback kernel of ``part`` in ``dtype`` and its scratch query."""
    lib = _build.load_library()
    if part == "mma":
        return lib.agp_svgp_epilogue_bwd_mma_f32, lib.agp_svgp_epilogue_bwd_mma_scratch_f32
    if dtype == torch.float32:
        return lib.agp_svgp_epilogue_bwd_f32, lib.agp_svgp_epilogue_bwd_scratch_f32
    return lib.agp_svgp_epilogue_bwd_f64, lib.agp_svgp_epilogue_bwd_scratch_f64


def epilogue_bwd_scratch(B: int, M: int, D: int, dtype: torch.dtype,
                         device: torch.device) -> int:
    """Elements of scratch that :func:`svgp_data_epilogue_bwd` allocates for
    a call at (B, M, D) in ``dtype`` on ``device`` with its default part.
    The layout depends on the card's SM count and occupancy, so this asks
    the card."""
    _, n_fn = _bwd_entry("mma" if _mma_takes(D, dtype) else "simt", dtype)
    with torch.cuda.device(device):
        return int(n_fn(B, M, D))


def svgp_data_epilogue_bwd(Xs, Zs, Se, ae, dmu, dvar, kmap: KernelMap,
                           part: str | None = None):
    """(X̄s, Z̄s, S̄e, āe): the pullback of :func:`svgp_data_epilogue` for
    the cotangents ``dmu`` and ``dvar`` (B,).  A CPU tensor takes
    :func:`svgp_data_epilogue_bwd_plain`; a CUDA tensor launches the
    tensor-core kernels of ``csrc/svgp_epilogue_bwd_mma.cu`` (f32,
    D <= 8) or the SIMT kernels of ``csrc/svgp_epilogue_bwd.cu`` (or
    ``part``: "simt", or "mma" where it takes the call), or raises.  Takes
    every M, B and 1 <= D <= 64 in f32 or f64, a superset of what the
    forward takes."""
    if Xs.device.type == "cpu":
        return svgp_data_epilogue_bwd_plain(Xs, Zs, Se, ae, dmu, dvar, kmap)
    B, D = Xs.shape
    M = Zs.shape[0]
    dtype = Xs.dtype
    _check("svgp_data_epilogue_bwd", (Xs, Zs, Se, ae, dmu, dvar), B, M, D)
    if dtype not in (torch.float32, torch.float64) or not 1 <= D <= _MAX_D:
        raise ValueError(f"svgp_data_epilogue_bwd: needs f32/f64 and 1 <= D <= {_MAX_D}, "
                         f"got {dtype}, D={D}")
    part = _part("svgp_data_epilogue_bwd", part, "mma" if _mma_takes(D, dtype) else "simt", D,
                 dtype)
    fn, n_fn = _bwd_entry(part, dtype)
    Xc, Zc = _centre(Xs, Zs)
    ins = [t.contiguous() for t in (Xc, Zc, Se, ae, dmu, dvar)]
    like = dict(dtype=dtype, device=Xs.device)
    outs = [torch.empty((B, D), **like), torch.empty((M, D), **like),
            torch.empty((M, M), **like), torch.empty((M,), **like)]
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    with torch.cuda.device(Xs.device):
        # the scratch layout depends on the card's SM count and occupancy
        n_scratch = n_fn(B, M, D)
        scratch = torch.empty((n_scratch,), **like)
        err = fn(*(t.data_ptr() for t in ins + outs), scratch.data_ptr(), B, M, D,
                 int(kmap.id), stream)
    _build.check(err, "svgp_data_epilogue_bwd")
    svgp_data_epilogue_bwd.launches += 1
    return tuple(outs)


svgp_data_epilogue_bwd.launches = 0


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Xs, Zs, Se, ae, kmap, part):
        ctx.kmap, ctx.part = kmap, part
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(Xs, Zs, Se, ae)
        return _forward(Xs, Zs, Se, ae, kmap, part)

    @staticmethod
    def backward(ctx, dmu, dvar):
        if dmu is None and dvar is None:
            return None, None, None, None, None, None
        Xs, Zs, Se, ae = ctx.saved_tensors
        like = dmu if dmu is not None else dvar
        dmu = torch.zeros_like(like) if dmu is None else dmu
        dvar = torch.zeros_like(like) if dvar is None else dvar
        grads = svgp_data_epilogue_bwd(Xs, Zs, Se, ae, dmu.to(Xs.dtype), dvar.to(Xs.dtype),
                                       ctx.kmap, ctx.part)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None,
                None)


def svgp_data_epilogue(Xs: torch.Tensor, Zs: torch.Tensor, Se: torch.Tensor,
                       ae: torch.Tensor, kmap: KernelMap, part: str | None = None):
    """(mu_corr, var_corr) = (K0ᵀ ae, diag(K0ᵀ Se K0)), K0 = g(r²(Zs, Xs)),
    differentiable in all four tensors.

    Xs: (B, D) scaled test inputs; Zs: (M, D) scaled inducing inputs; Se:
    (M, M), exactly symmetric (the forward kernels read one triangle, the
    plain version all of it); ae: (M,).  A CPU tensor takes the plain
    versions; a CUDA tensor launches the kernels that :func:`epilogue_part`
    names (or ``part``, forward and backward: "simt", or "mma" in f32 with
    D <= 8) or raises."""
    return _Epilogue.apply(Xs, Zs, Se, ae, kmap, part)


svgp_data_epilogue.launches = 0
