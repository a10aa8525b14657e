"""Fused stationary Gram matvec and its pullback: the port of
``approximategps_tpu/ops/gram_matvec.py::pallas_gram_matvec`` (forward
``_forward_multi``; pullback ``_coord_cotangent`` and ``_gmv_bwd``).

    out[i, r] = Σ_j g(‖xq_i − zk_j‖²) V[j, r],    K = g(r²(Xq, Zk)) never stored.

:func:`gram_matvec` is a ``torch.autograd.Function`` on both devices; only
its inner pass, :func:`gram_matvec_pass`, switches between the hand-written
kernels (a CUDA tensor) and :func:`gram_matvec_plain` (a CPU tensor), so the
CPU tests run the pullback's algebra and not autograd through a Gram.  The
pullback is the same pass run again: V̄ = K(Zk, Xq)·Ō, and each coordinate
cotangent is one pass with the derivative map g′ and (1 + D)·R right-hand
sides [V, V∘z_d] (rank-R structure of W = (Ō Vᵀ)∘g′(r²); see
:func:`_coord_cotangent`).

The pass has two kernels, chosen by :func:`pass_part` from R alone: the
narrow one on the SIMT units (``csrc/gram_matvec.cu``; f32 below
``MMA_FROM_R`` columns, and f64 always) and the wide one with the product on
the tensor cores in 3xTF32 (``csrc/gram_matvec_mma.cu``; f32 from
``MMA_FROM_R`` on).  :func:`gram_matvec_self` is the self-Gram K(X, X)·V,
the same Function without key points: its pullback is one pass
(``csrc/gram_matvec_self_bwd.cu`` in f32; :func:`gram_matvec_self_bwd_plain`
on the CPU) that returns V̄ = K·Ō and X̄ = X̄q + Z̄k together, with r² and the
map computed once a pair.  The Function also takes the scalar scale of an
isotropic lengthscale, whose cotangent is one pass of a third map,
r²·g′(r²) (``deriv=2``), formed from r² itself.

What bounds the kernels on the H100 is operations (an exp an entry, and R
FMAs on the SIMT units or 3·R on the tensor cores), not bytes; the notes in
the ``.cu`` files give the designs.  Every pass and every one-pass pullback
counts one launch in ``gram_matvec.launches`` (more than 32 columns run as
chunks inside that launch) and in ``launches_by_pass`` under its kernel and
width, and the pullbacks count their passes in ``pullback_passes``.

:func:`fused_stationary_matvec` is the dispatch ``kernel_matvec`` uses: D ≤ 8,
R ≤ ``config.matvec_fused_max_rhs``, a kernel that unwraps to a scaled
stationary map, and no forward-mode tangent (the Function has no
forward-mode rule; the plain route has one).  Wider blocks take the plain
block path even on the card, as in the JAX package: there one Gram serves
all columns.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..config import config, kernel_device
from ..core.kernels import KernelMap, _param, unwrap_stationary
from . import _build

__all__ = [
    "gram_matvec",
    "gram_matvec_pass",
    "gram_matvec_plain",
    "gram_matvec_bwd",
    "gram_matvec_self",
    "gram_matvec_self_bwd",
    "gram_matvec_self_bwd_plain",
    "pass_part",
    "fused_stationary_matvec",
    "pullback_passes",
    "launches_by_pass",
]

_MAX_D = 8
_MAX_R = 128  # columns one pass takes
_PLAIN_ELEMS = 1 << 25  # (rows, M, D) differences one plain chunk forms
_SELF_BWD_CHUNK = 32  # columns a chunk of the one-pass pullback kernel
# the f32 crossover: narrower passes take the SIMT kernel, this wide and
# wider the tensor-core one (measured on the H100 by chip_smoke.py phase 3)
MMA_FROM_R = 8

# passes the pullbacks asked for (whatever the device), beside the kernel's
# own launch count: a run's launches are its forward applications plus these
pullback_passes = {"calls": 0, "passes": 0}
# the same launches by kernel and width: ("narrow" or "wide", R) for a pass,
# ("self pullback", R) for the one-pass pullback
launches_by_pass: dict[tuple[str, int], int] = {}


def _count_launch(kind: str, R: int) -> None:
    gram_matvec.launches += 1
    launches_by_pass[kind, R] = launches_by_pass.get((kind, R), 0) + 1


def _entry(kmap: KernelMap, deriv: int):
    """h of a pass: g (deriv 0), g′ (1) or r²·g′(r²) (2)."""
    if deriv == 2:
        return lambda r2: kmap.dk_of_r2(r2) * r2
    return kmap.dk_of_r2 if deriv else kmap.k_of_r2


def gram_matvec_plain(Xq: torch.Tensor, Zk: torch.Tensor, V: torch.Tensor, kmap: KernelMap,
                      deriv: int = 0) -> torch.Tensor:
    """The plain PyTorch version of one pass: exact-difference r², the map
    (g; g′ with ``deriv`` 1 or True; r²·g′(r²) with ``deriv`` 2), and the
    product, in row chunks."""
    fn = _entry(kmap, int(deriv))
    vec = V.ndim == 1
    V2 = V[:, None] if vec else V
    N, D = Xq.shape
    rows = max(1, _PLAIN_ELEMS // max(1, Zk.shape[0] * D))
    parts = []
    for i0 in range(0, N, rows):
        diff = Xq[i0:i0 + rows, None, :] - Zk[None, :, :]
        parts.append(fn(torch.sum(diff * diff, dim=-1)) @ V2)
    out = torch.cat(parts) if parts else V2.new_zeros((0, V2.shape[1]))
    return out[:, 0] if vec else out


def pass_part(R: int, dtype: torch.dtype = torch.float32) -> str:
    """The kernel a pass of R columns takes on the card: "mma" (the wide
    pass, tensor cores) for f32 from ``MMA_FROM_R`` columns on, else
    "simt" (the narrow pass; f64 always)."""
    return "mma" if dtype == torch.float32 and R >= MMA_FROM_R else "simt"


def gram_matvec_pass(Xq: torch.Tensor, Zk: torch.Tensor, V: torch.Tensor, kmap: KernelMap,
                     deriv: int = 0, part: str | None = None) -> torch.Tensor:
    """One pass out = h(r²(Xq, Zk))·V, h = g (g′ with ``deriv`` 1 or True,
    r²·g′(r²) with ``deriv`` 2: the lengthscale's cotangent); Xq
    (N, D ≤ 8), Zk (M, D), V (M,) or (M, R ≤ 128).  A CPU tensor takes
    :func:`gram_matvec_plain`; a CUDA tensor launches the kernel that
    :func:`pass_part` names (or ``part``: "simt", or "mma" in f32) or
    raises.  Not differentiable itself: :func:`gram_matvec` is."""
    if Xq.device.type == "cpu":
        return gram_matvec_plain(Xq, Zk, V, kmap, deriv)
    vec = V.ndim == 1
    V2 = V[:, None] if vec else V
    dtype = Xq.dtype
    if (
        not all(t.is_cuda and t.device == Xq.device and t.dtype == dtype for t in (Xq, Zk, V2))
        or dtype not in (torch.float32, torch.float64)
        or Xq.ndim != 2 or Zk.ndim != 2 or V2.ndim != 2
        or not 1 <= Xq.shape[1] <= _MAX_D or Zk.shape[1] != Xq.shape[1]
        or V2.shape[0] != Zk.shape[0] or not 1 <= V2.shape[1] <= _MAX_R
        or int(deriv) not in (0, 1, 2)
    ):
        raise ValueError(
            f"gram_matvec: needs Xq (N, D <= {_MAX_D}), Zk (M, D), V (M,) or (M, R <= {_MAX_R}) "
            "on one CUDA device in f32 or f64; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in (Xq, Zk, V)]}"
        )
    N, D = Xq.shape
    M, R = V2.shape
    part = part or pass_part(R, dtype)
    if part not in ("simt", "mma") or (part == "mma" and dtype != torch.float32):
        raise ValueError(f"gram_matvec: no {part!r} pass in {dtype}")
    out = torch.empty((N, R), dtype=dtype, device=Xq.device)
    if N > 0 and M > 0:
        lib = _build.load_library()
        fn = {("simt", torch.float32): lib.agp_gram_matvec_f32,
              ("simt", torch.float64): lib.agp_gram_matvec_f64,
              ("mma", torch.float32): lib.agp_gram_matvec_mma_f32}[part, dtype]
        Xq, Zk, V2 = Xq.contiguous(), Zk.contiguous(), V2.contiguous()
        stream = torch.cuda.current_stream(Xq.device).cuda_stream
        with torch.cuda.device(Xq.device):
            err = fn(Xq.data_ptr(), Zk.data_ptr(), V2.data_ptr(), out.data_ptr(), N, M, D, R,
                     int(kmap.id), int(deriv), stream)
        _build.check(err, "gram_matvec")
        _count_launch("narrow" if part == "simt" else "wide", R)
    else:
        out.zero_()
    return out[:, 0] if vec else out


def _coord_cotangent(Q, Zk, V2, O2, kmap: KernelMap):
    """Q̄ for out = K(Q, Zk)·V through the rank-R structure of
    W = (Σ_r ō_r v_rᵀ)∘g′(r²):

        Q̄_i = 2 (s_i q_i − U_i),   s_i = Σ_j W_ij,   U_id = Σ_j W_ij z_jd,

    both from g′ passes with right-hand sides [V_c, V_c∘z_d], chunked so
    that each pass takes at most 128 columns."""
    D = Q.shape[1]
    R = V2.shape[1]
    rc = max(1, _MAX_R // (1 + D))
    s = Q.new_zeros((Q.shape[0],))
    U = torch.zeros_like(Q)
    for r0 in range(0, R, rc):
        Vc = V2[:, r0:r0 + rc]
        Oc = O2[:, r0:r0 + rc]
        c = Vc.shape[1]
        cols = torch.cat([Vc] + [Vc * Zk[:, d:d + 1] for d in range(D)], dim=1)
        SU = gram_matvec_pass(Q, Zk, cols, kmap, deriv=True)
        pullback_passes["passes"] += 1
        s = s + torch.sum(Oc * SU[:, :c], dim=1)
        U = U + torch.stack(
            [torch.sum(Oc * SU[:, (1 + d) * c:(2 + d) * c], dim=1) for d in range(D)], dim=1)
    return 2.0 * (s[:, None] * Q - U)


def gram_matvec_bwd(Xq, Zk, V, obar, kmap: KernelMap, needs=(True, True, True)):
    """(X̄q, Z̄k, V̄) of out = K(Xq, Zk)·V for the cotangent ``obar``; an
    entry is None where ``needs`` says it is not wanted."""
    pullback_passes["calls"] += 1
    vec = V.ndim == 1
    V2 = V[:, None] if vec else V
    O2 = obar[:, None] if vec else obar
    Xq_bar = Zk_bar = V_bar = None
    if needs[2]:
        # Kᵀ ō: the transposed pass (g is symmetric in its arguments)
        V_bar = gram_matvec_pass(Zk, Xq, O2, kmap)
        pullback_passes["passes"] += 1
        V_bar = V_bar[:, 0] if vec else V_bar
    if needs[0]:
        Xq_bar = _coord_cotangent(Xq, Zk, V2, O2, kmap)
    if needs[1]:
        # the same contraction with the query and key roles (and V, Ō) swapped
        Zk_bar = _coord_cotangent(Zk, Xq, O2, V2, kmap)
    return Xq_bar, Zk_bar, V_bar


class _GramMatvec(torch.autograd.Function):
    """K(Xq·s, Zk·s)·V, the one Function of the three products: the cross
    product (``Zk`` given) with the general pullback's passes, the
    self-Gram K(Xq·s, Xq·s)·V (``Zk`` None) with its one-pass pullback, and
    ``s`` an optional scalar input scale (the inverse of an isotropic
    lengthscale).  The points' cotangents are s times the scaled points';
    s's own is formed from r² itself,

        s̄ = (2/s) Σᵢ Ōᵢ·[H V]ᵢ,   H = r²·g′(r²),

    one more pass, where Σᵢ x̄ᵢ·xᵢ of the points' cotangents would cancel
    (translation invariance makes their sum 0) and lose digits in f32.  A
    pullback of s alone is that one pass; of s and V with the points fixed
    (the logdet surrogate's V = w∘Zᵀ), that pass and V̄ = K·Ō."""

    @staticmethod
    def forward(ctx, Xq, Zk, V, s, kmap):
        Xqs = Xq if s is None else Xq * s
        Zks = Xqs if Zk is None else (Zk if s is None else Zk * s)
        ctx.kmap, ctx.self_gram = kmap, Zk is None
        ctx.save_for_backward(Xqs, Zks, V, s)
        return gram_matvec_pass(Xqs, Zks, V, kmap)

    @staticmethod
    def backward(ctx, obar):
        Xqs, Zks, V, s = ctx.saved_tensors
        kmap = ctx.kmap
        need_xq, need_zk, need_v, need_s = ctx.needs_input_grad[:4]
        O = obar.to(Xqs.dtype).contiguous()
        Xq_bar = Zk_bar = V_bar = s_bar = None
        if ctx.self_gram and need_xq:
            Xq_bar, V_bar = gram_matvec_self_bwd(Xqs, V, O, kmap)
        elif need_xq or need_zk or need_v:
            # a self-Gram with its points fixed wants V̄ = K·Ō alone: one pass
            Xq_bar, Zk_bar, V_bar = gram_matvec_bwd(Xqs, Zks, V, O, kmap,
                                                    (need_xq, need_zk, need_v))
        if s is not None:
            Xq_bar = None if Xq_bar is None else s * Xq_bar
            Zk_bar = None if Zk_bar is None else s * Zk_bar
        if need_s:
            H = gram_matvec_pass(Xqs, Zks, V, kmap, deriv=2)
            pullback_passes["passes"] += 1
            s_bar = (2.0 / s) * torch.sum(O * H)
        return (Xq_bar if need_xq else None, Zk_bar, V_bar if need_v else None, s_bar, None)


def gram_matvec(Xq: torch.Tensor, Zk: torch.Tensor, V: torch.Tensor,
                kmap: KernelMap) -> torch.Tensor:
    """K(Xq, Zk)·V without K, K = g(r²): Xq (N, D ≤ 8), Zk (M, D), V (M,) or
    (M, R ≤ 128) → (N,) or (N, R).  Reverse-mode differentiable in all
    three through the pass itself (see the module note); no forward-mode
    rule.  Fold lengthscales into the inputs and the variance onto the
    output."""
    return _GramMatvec.apply(Xq, Zk, V, None, kmap)


gram_matvec.launches = 0


def gram_matvec_self_bwd_plain(X: torch.Tensor, V2: torch.Tensor, O2: torch.Tensor,
                               kmap: KernelMap):
    """(X̄, V̄) of out = K(X, X)·V for the cotangent O, in row chunks:

        V̄ = K·Ō,   X̄_i = 2 (s_i x_i − U_i),   s_i = Σ_j W_ij,   U_i = Σ_j W_ij x_j,

    W = g′(r²) ∘ C, C_ij = [Ō_i | V_i]·[V_j | Ō_j], which is X̄q + Z̄k of the
    general pullback (x_i's query and key roles)."""
    N, D = X.shape
    rows = max(1, _PLAIN_ELEMS // max(1, N * D))
    xbar, vbar = [], []
    for i0 in range(0, N, rows):
        xi = X[i0:i0 + rows]
        diff = xi[:, None, :] - X[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
        vbar.append(kmap.k_of_r2(r2) @ O2)
        W = kmap.dk_of_r2(r2) * (O2[i0:i0 + rows] @ V2.T + V2[i0:i0 + rows] @ O2.T)
        xbar.append(2.0 * (W.sum(dim=1, keepdim=True) * xi - W @ X))
    return torch.cat(xbar), torch.cat(vbar)


def gram_matvec_self_bwd(X: torch.Tensor, V: torch.Tensor, obar: torch.Tensor,
                         kmap: KernelMap):
    """(X̄, V̄) of out = K(X, X)·V for the cotangent ``obar``, one pass: a
    CPU tensor takes :func:`gram_matvec_self_bwd_plain`, a CUDA f32 tensor
    the one-pass kernel (one launch), a CUDA f64 tensor the general
    pullback's passes (the f64 kernels are the SIMT reference), X̄ = X̄q + Z̄k."""
    vec = V.ndim == 1
    V2 = V[:, None] if vec else V
    O2 = obar[:, None] if vec else obar
    if X.is_cuda and X.dtype == torch.float64:
        Xq_bar, Zk_bar, V_bar = gram_matvec_bwd(X, X, V2, O2, kmap)
        X_bar = Xq_bar + Zk_bar
    else:
        if X.device.type == "cpu":
            X_bar, V_bar = gram_matvec_self_bwd_plain(X, V2, O2, kmap)
        else:
            X_bar, V_bar = _self_bwd_kernel(X, V2, O2, kmap)
        pullback_passes["calls"] += 1
        pullback_passes["passes"] += 1
    return X_bar, (V_bar[:, 0] if vec else V_bar)


def _self_bwd_kernel(X, V2, O2, kmap: KernelMap):
    ts = (X, V2, O2)
    if (
        not all(t.is_cuda and t.device == X.device and t.dtype == torch.float32 for t in ts)
        or X.ndim != 2 or not 1 <= X.shape[1] <= _MAX_D
        or V2.shape != O2.shape or V2.shape[0] != X.shape[0] or not 1 <= V2.shape[1] <= _MAX_R
    ):
        raise ValueError(
            f"gram_matvec_self_bwd: needs X (N, D <= {_MAX_D}), V and obar (N, R <= {_MAX_R}) "
            "on one CUDA device in f32; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in ts]}")
    N, D = X.shape
    R = V2.shape[1]
    chunks = -(-R // _SELF_BWD_CHUNK)
    # row-major as the kernel writes it, whatever V's strides (empty_like
    # would copy a column-major V's, as w∘Zᵀ has them)
    V_bar = torch.empty((N, R), dtype=X.dtype, device=X.device)
    X_bar = torch.empty((chunks, N, D), dtype=X.dtype, device=X.device)
    if N > 0:
        X, V2, O2 = X.contiguous(), V2.contiguous(), O2.contiguous()
        stream = torch.cuda.current_stream(X.device).cuda_stream
        with torch.cuda.device(X.device):
            err = _build.load_library().agp_gram_matvec_self_bwd_f32(
                X.data_ptr(), V2.data_ptr(), O2.data_ptr(), V_bar.data_ptr(), X_bar.data_ptr(),
                N, D, R, int(kmap.id), stream)
        _build.check(err, "gram_matvec_self_bwd")
        _count_launch("self pullback", R)
    # each chunk of 32 columns wrote its share of X̄: added in a fixed order
    return (X_bar[0] if chunks == 1 else X_bar.sum(dim=0)), V_bar


def gram_matvec_self(X: torch.Tensor, V: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """K(X, X)·V without K: X (N, D ≤ 8), V (N,) or (N, R ≤ 128) → (N,) or
    (N, R), the forward one pass of :func:`gram_matvec_pass`.  Reverse-mode
    differentiable in X and V through :func:`gram_matvec_self_bwd` (one
    pass for both); no forward-mode rule."""
    return _GramMatvec.apply(X, None, V, None, kmap)


def _has_tangent(*ts) -> bool:
    return any(isinstance(t, torch.Tensor) and fwAD.unpack_dual(t).tangent is not None
               for t in ts)


def fused_stationary_matvec(kernel, X: torch.Tensor, Xq: torch.Tensor | None = None):
    """``fused(v) -> K(X, X)·v | None`` (``K(Xq, X)·v`` with ``Xq``, the
    cross product through :func:`gram_matvec`), or None where the kernel,
    the inputs or the config do not qualify.

    Qualifies when ``config.matvec_mode`` is "fused" (any device: the CPU
    runs the Function with its plain pass, as the JAX package's tests run
    Pallas in interpret mode), or "auto" on the kernel device; kernels
    allowed; D ≤ 8; the kernel unwraps to a scaled parameter-free
    stationary map; and nothing carries a forward-mode tangent.  The closure
    returns None for blocks wider than ``config.matvec_fused_max_rhs`` (the
    plain block path, where one Gram serves all columns) and for a ``v``
    with a tangent."""
    mode = config.matvec_mode
    if mode == "plain" or not config.use_kernels:
        return None
    if mode not in ("auto", "fused"):
        raise ValueError(f"unknown matvec_mode {mode!r}")
    if X.ndim != 2 or not 1 <= X.shape[1] <= _MAX_D:
        return None
    if Xq is not None and (Xq.ndim != 2 or Xq.shape[1] != X.shape[1]):
        return None
    if mode == "auto" and not kernel_device(X):
        return None
    uw = unwrap_stationary(kernel)
    if uw is None:
        return None
    kmap, scale, variance = uw
    if _has_tangent(X, Xq, scale, variance):
        return None
    max_rhs = int(config.matvec_fused_max_rhs)
    s = None if scale is None else _param(scale, X)
    if s is not None and s.numel() == 1:
        # an isotropic lengthscale, whose cotangent the Function forms from r²
        s = s.reshape(())
    elif s is not None:
        X, Xq, s = X * s, None if Xq is None else Xq * s, None

    def product(v):
        return _GramMatvec.apply(X if Xq is None else Xq, None if Xq is None else X, v, s, kmap)

    def fused(v):
        if v.ndim not in (1, 2) or _has_tangent(v):
            return None
        if v.ndim == 2 and v.shape[1] > max_rhs:
            return None
        out = product(v)
        return out if variance is None else _param(variance, out) * out

    return fused
