"""The fused stationary Gram: the port of ``approximategps_tpu/ops/gram.py``'s
``pallas_stationary_gram`` (row 11 of the kernel table).

``K[i, j] = g(|x_i − z_j|²)`` for a parameter-free stationary map g, with r²
and the map fused, so that no r² (N, M) intermediate is stored.  It is one
``torch.autograd.Function``, :func:`stationary_gram`, whose forward switches
on the device: :func:`stationary_gram_pass` launches the hand-written kernel
``csrc/stationary_gram.cu`` for a CUDA tensor (or raises) and takes
:func:`stationary_gram_plain`, the map of exact broadcast distances summed
coordinate by coordinate, for a CPU tensor.  Its backward is the JAX custom
VJP's closed form (``_bwd``) in PyTorch on both devices, three matmuls that
the JAX package leaves to XLA too:

    W = ḡ ∘ g′(r²),   X̄ = 2(rowsum(W)∘X − W Z),   Z̄ = 2(colsum(W)∘Z − Wᵀ X).

For the SE map the pullback reads g′ off the stored K (g′ = −½·g, the
``dk_from_k`` shortcut of the JAX package's fused pullbacks) instead of
recomputing r² coordinate by coordinate.  Both passes take leading batch
dimensions, (..., N, D) and (..., M, D), and
the Function has a vmap rule, so that kernels' ``gram`` run under
``torch.func.vmap`` (the Vecchia window Grams) launch one batched kernel.
``core.kernels`` reaches it under ``config.gram_mode = "fused"`` for every
non-symmetric Gram of a kernel with a CUDA map.
"""

from __future__ import annotations

import functools

import torch

from ..core.kernels import KernelMap, dk_from_k_for
from . import _build

__all__ = ["stationary_gram", "stationary_gram_pass", "stationary_gram_plain",
           "stationary_gram_bwd"]

_MAX_N = 65535 * 64  # rows of X the kernel's grid covers


def _sq_dist(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """(..., N, M) squared distances from exact differences, one coordinate
    at a time (no (N, M, D) intermediate)."""
    r2 = None
    for d in range(X.shape[-1]):
        dd = X[..., :, d, None] - Z[..., None, :, d]
        r2 = dd * dd if r2 is None else r2 + dd * dd
    return r2


def stationary_gram_plain(X: torch.Tensor, Z: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """The plain PyTorch version of the kernel: g of the exact broadcast
    distances, X (..., N, D) and Z (..., M, D) → (..., N, M)."""
    return kmap.k_of_r2(_sq_dist(X, Z))


def _check_cuda_args(X, Z) -> None:
    if (
        not (X.is_cuda and Z.device == X.device and Z.dtype == X.dtype)
        or X.dtype not in (torch.float32, torch.float64)
        or X.ndim < 2 or Z.ndim != X.ndim or X.shape[-1] != Z.shape[-1] or X.shape[-1] < 1
        or X.shape[-2] > _MAX_N
    ):
        raise ValueError(
            f"stationary_gram: needs X (..., N <= {_MAX_N}, D) and Z (..., M, D) with the same "
            "batch dimensions, on one CUDA device in f32 or f64; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in (X, Z)]}")


@functools.cache
def _entry(dtype: torch.dtype):
    """The kernel's C entry point for ``dtype``, resolved once."""
    lib = _build.load_library()
    return lib.agp_stationary_gram_f32 if dtype == torch.float32 else lib.agp_stationary_gram_f64


def stationary_gram_pass(X: torch.Tensor, Z: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """K = g(r²(X, Z)), X (..., N, D) and Z (..., M, D) with broadcastable
    batch dimensions, any strides, → (..., N, M) contiguous.  A CPU tensor
    takes :func:`stationary_gram_plain`; a CUDA tensor launches the kernel
    of ``csrc/stationary_gram.cu`` or raises.  Not differentiable itself:
    :func:`stationary_gram` is.  The host's share of a call is kept small
    (the kernel itself takes tens of microseconds at the minibatch step's
    Kuf): the plain 2-D case passes its strides as they are, and the
    current device is switched only where it is not X's."""
    if X.device.type == "cpu":
        return stationary_gram_plain(X, Z, kmap)
    _check_cuda_args(X, Z)
    (N, D), M = X.shape[-2:], Z.shape[-2]
    if X.ndim == 2:
        out = torch.empty((N, M), dtype=X.dtype, device=X.device)
        B, Xb, Zb = 1, X, Z
        sx, sz = (0, *X.stride()), (0, *Z.stride())
    else:
        batch = torch.broadcast_shapes(X.shape[:-2], Z.shape[:-2])
        out = torch.empty((*batch, N, M), dtype=X.dtype, device=X.device)
        B = out.numel() // max(N * M, 1)
        # one batch dimension: expanded dimensions keep a zero stride where a
        # reshape can, and are copied where it cannot
        Xb = X.expand(*batch, N, D).reshape(B, N, D)
        Zb = Z.expand(*batch, M, D).reshape(B, M, D)
        sx, sz = Xb.stride(), Zb.stride()
    if out.numel() == 0:
        return out
    fn, dev = _entry(X.dtype), X.device
    args = (Xb.data_ptr(), sx[0], sx[1], sx[2], Zb.data_ptr(), sz[0], sz[1], sz[2],
            out.data_ptr(), B, N, M, D, int(kmap.id), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    _build.check(err, "stationary_gram")
    stationary_gram.launches += 1
    return out


def stationary_gram_bwd(X, Z, kmap: KernelMap, gbar, need_x: bool = True, need_z: bool = True,
                        K=None):
    """(X̄, Z̄) of ⟨gbar, g(r²(X, Z))⟩, each None where not needed: the JAX
    custom VJP's formulas with W = ḡ ∘ g′(r²), g′ read off the forward's
    ``K`` where the map has the shortcut and ``K`` is given, else from r²
    recomputed by exact differences.  Batch dimensions broadcast; each
    cotangent is summed back to its input's shape."""
    dk_from_k = dk_from_k_for(kmap)
    if K is not None and dk_from_k is not None:
        W = gbar * dk_from_k(K)
    else:
        W = gbar * kmap.dk_of_r2(_sq_dist(X, Z))
    Xbar = Zbar = None
    if need_x:
        Xbar = 2.0 * (torch.sum(W, dim=-1, keepdim=True) * X - W @ Z)
        Xbar = Xbar.sum_to_size(X.shape)
    if need_z:
        Zbar = 2.0 * (torch.sum(W, dim=-2)[..., None] * Z - W.mT @ X)
        Zbar = Zbar.sum_to_size(Z.shape)
    return Xbar, Zbar


class _StationaryGram(torch.autograd.Function):
    @staticmethod
    def forward(X, Z, kmap):
        return stationary_gram_pass(X, Z, kmap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, Z, kmap = inputs
        ctx.kmap = kmap
        # K only where the pullback reads g′ off it
        ctx.save_for_backward(X, Z, output if dk_from_k_for(kmap) is not None else None)

    @staticmethod
    def backward(ctx, gbar):
        X, Z, K = ctx.saved_tensors
        need_x, need_z, _ = ctx.needs_input_grad
        return (*stationary_gram_bwd(X, Z, ctx.kmap, gbar.to(X.dtype), need_x, need_z, K), None)

    @staticmethod
    def vmap(info, in_dims, X, Z, kmap):
        # the mapped dimension in front of each input (expanded where one is
        # not mapped), then one batched call
        xd, zd, _ = in_dims
        X = X.movedim(xd, 0) if xd is not None else X.expand(info.batch_size, *X.shape)
        Z = Z.movedim(zd, 0) if zd is not None else Z.expand(info.batch_size, *Z.shape)
        return _StationaryGram.apply(X, Z, kmap), 0


def stationary_gram(X: torch.Tensor, Z: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """K = g(|x_i − z_j|²) for a parameter-free stationary map (row 11 of
    the kernel table): X (N, D) and Z (M, D), or with matching leading batch
    dimensions, → (N, M) in X's dtype.  Differentiable in X and Z; runs
    under ``torch.func.vmap``."""
    return _StationaryGram.apply(X, Z, kmap)


stationary_gram.launches = 0
