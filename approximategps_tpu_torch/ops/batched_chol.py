"""Vecchia band rows: the port of ``approximategps_tpu/ops/batched_chol.py``'s
fused window → Gram → factor → band kernels ``pallas_vecchia_band`` (row 7
of the kernel table), ``pallas_vecchia_band_lanes`` (row 8) and
``pallas_vecchia_band_lanes_t`` (row 10), of their pullback (row 9), and of
``batched_chol_solve_band`` (row 6), the band rows from prebuilt Grams.

All three have one contract: point windows → band rows.  Window slot t < k
is neighbour t, slot k the conditioned point; invalid neighbour slots become
identity rows with zero coupling; a nugget may shift the valid diagonal.
For each window the band row is

    [−b·F^(−1/2), F^(−1/2)],   b = Kw⁻¹kni,   F = kdiag − kniᵀb,

with the pivot floors (8·eps relative to the original diagonal) and the
modified-Cholesky deflation of the JAX package.  One hand-written kernel,
``csrc/vecchia_band.cu``, serves both layouts: it takes strides, so
:func:`vecchia_band` ((N, D, k+1) windows, rows 7 and 8) and
:func:`vecchia_band_t` ((D, k+1, N) windows, row 10) hand it views and
nothing is transposed or copied.

Both are one ``torch.autograd.Function``.  Only its inner passes switch on the
device.  Forward, :func:`vecchia_band_pass`: the kernel for a CUDA tensor,
:func:`vecchia_band_plain` (the bordered (k+1) Cholesky of rows 8 and 10 in
PyTorch) for a CPU tensor.  Backward, :func:`vecchia_band_bwd_pass`: the
hand-written pullback ``csrc/vecchia_band_bwd.cu`` (row 9,
``_vecchia_band_lanes_bwd_pallas_t``) for a CUDA tensor, and for a CPU
tensor its plain version, :func:`_recompute_pullback`: row 7's own JAX
backward (``_vecchia_band_bwd``), which rebuilds :func:`window_gram_inputs`
under autograd and applies the closed-form band pullback :func:`band_bwd`,
the nugget's cotangent included.  :func:`vecchia_band_bwd` is the pullback
on its own.

:func:`batched_chol_solve_band` (row 6) takes prebuilt masked Grams (Kw,
kni, kdiag), as the windowed tier builds them for kernels that do not unwrap
to a map of the band kernel, or for noise that is not a scalar.  Its
autograd Function's forward, :func:`batched_chol_solve_band_pass`, launches
the hand-written kernel ``csrc/band_rows.cu`` (a window to the lanes of a
warp, its triangle in their registers) for a CUDA tensor (or raises)
and runs :func:`masked_chol_solve_band_math`, the plain masked-column math
(the JAX package's XLA ``batched_chol_solve_band_unrolled``), for a CPU
tensor; its backward is the closed-form :func:`band_bwd` on both devices,
the port of the JAX custom VJP ``_band_bwd``, which is not a Pallas kernel.
:func:`masked_chol_solve_band_math` is the same Function with the plain
forward on every device.
"""

from __future__ import annotations

import torch

from ..core.kernels import KernelMap
from . import _build

__all__ = [
    "MAX_D",
    "MAX_K",
    "band_bwd",
    "batched_chol_solve_band",
    "batched_chol_solve_band_pass",
    "masked_chol_solve_band_math",
    "window_gram_inputs",
    "vecchia_band",
    "vecchia_band_t",
    "vecchia_band_pass",
    "vecchia_band_plain",
    "vecchia_band_bwd",
    "vecchia_band_bwd_pass",
]

MAX_D = 8  # coordinates a window point may have (the kernel's template range)
MAX_K = 64  # neighbours a window may have (the band kernel's and row 6's limit)
_BWD_CHUNK = 16384  # windows the plain pullback takes at a time


def _floor(x: torch.Tensor) -> torch.Tensor:
    """8·eps·|x|: the relative pivot and variance floor."""
    return 8.0 * torch.finfo(x.dtype).eps * x.abs()


# ---------------------------------------------------------------------------
# The masked-column math from prebuilt Grams
# ---------------------------------------------------------------------------


def _masked_chol_factor(A: torch.Tensor):
    """Masked-column Cholesky of A (B, k, k) → (L, live): pivots floored at
    8·eps·|Aⱼⱼ|; a floored pivot deflates its column (off-diagonal entries
    0, ``live`` 0), since its column depends on the ones before it."""
    k = A.shape[-1]
    L = torch.zeros_like(A)
    live = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    for j in range(k):
        s = (L[:, :, :j] @ L[:, j, :j, None])[..., 0]  # s_i = Σ_{t<j} L[i,t] L[j,t]
        Ajj = A[:, j, j]
        d_raw = Ajj - s[:, j]
        fl = _floor(Ajj)
        d = torch.maximum(d_raw, fl)
        notc = (d_raw >= fl).to(A.dtype)
        sq = torch.sqrt(d)
        L[:, j + 1:, j] = (A[:, j + 1:, j] - s[:, j + 1:]) * (notc / sq)[:, None]
        L[:, j, j] = sq
        live[:, j] = notc
    return L, live


def _masked_spd_solve(L: torch.Tensor, live: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """A⁻¹c from :func:`_masked_chol_factor`'s result, c (B, k): forward and
    back substitution with the deflated coordinates forced to 0."""
    k = c.shape[1]
    Ldiag = torch.diagonal(L, dim1=1, dim2=2)
    w = torch.zeros_like(c)
    for i in range(k):
        s = torch.sum(L[:, i, :i] * w[:, :i], dim=1)
        w[:, i] = live[:, i] * (c[:, i] - s) / Ldiag[:, i]
    b = torch.zeros_like(c)
    for i in reversed(range(k)):
        s = torch.sum(L[:, i + 1:, i] * b[:, i + 1:], dim=1)
        b[:, i] = live[:, i] * (w[:, i] - s) / Ldiag[:, i]
    return b


def _band_from_solve(c, b, kdiag):
    F = torch.maximum(kdiag - torch.sum(c * b, dim=1), _floor(kdiag))
    u0 = torch.rsqrt(F)
    return torch.cat([-b * u0[:, None], u0[:, None]], dim=1), u0


def band_bwd(A, c, kdiag, gbar):
    """Closed-form pullback of the band rows (JAX ``_band_bwd``).  With
    S = A⁻¹, b = S·c, F = kdiag − c·b, u₀ = F^(−1/2), out = [−b·u₀, u₀]:

        ū₀ = ḡ_d − ḡ_r·b        F̄ = −½ u₀³ ū₀
        b̄ = −u₀ ḡ_r − c F̄       kdiag‾ = F̄
        c̄ = S b̄ − b F̄           Ā = −(S b̄) bᵀ

    One masked factorization serves both solves, with the forward's floors
    and deflation."""
    gr, gd = gbar[:, :-1], gbar[:, -1]
    L, live = _masked_chol_factor(A)
    b = _masked_spd_solve(L, live, c)
    _, u0 = _band_from_solve(c, b, kdiag)
    u0_bar = gd - torch.sum(gr * b, dim=1)
    F_bar = -0.5 * u0 ** 3 * u0_bar
    b_bar = -u0[:, None] * gr - c * F_bar[:, None]
    Sb_bar = _masked_spd_solve(L, live, b_bar)
    c_bar = Sb_bar - b * F_bar[:, None]
    A_bar = -Sb_bar[:, :, None] * b[:, None, :]
    return A_bar, c_bar, F_bar


def _masked_band_plain(A, c, kdiag):
    L, live = _masked_chol_factor(A)
    return _band_from_solve(c, _masked_spd_solve(L, live, c), kdiag)[0]


def batched_chol_solve_band_pass(Kw: torch.Tensor, kni: torch.Tensor,
                                 kdiag: torch.Tensor) -> torch.Tensor:
    """Band rows of prebuilt masked Grams Kw (B, k, k) (only the lower
    triangle is read), kni (B, k), kdiag (B,), any strides.  A CPU tensor
    takes the plain masked math; a CUDA tensor launches the kernel of
    ``csrc/band_rows.cu`` or raises.  Not differentiable itself:
    :func:`batched_chol_solve_band` is."""
    if Kw.device.type == "cpu":
        return _masked_band_plain(Kw, kni, kdiag)
    dtype = Kw.dtype
    if (
        not all(t.is_cuda and t.device == Kw.device and t.dtype == dtype for t in (kni, kdiag))
        or dtype not in (torch.float32, torch.float64)
        or Kw.ndim != 3 or not 1 <= Kw.shape[1] <= MAX_K or Kw.shape[2] != Kw.shape[1]
        or tuple(kni.shape) != tuple(Kw.shape[:2]) or tuple(kdiag.shape) != (Kw.shape[0],)
    ):
        raise ValueError(
            f"batched_chol_solve_band: needs Kw (B, k, k) with 1 <= k <= {MAX_K}, kni (B, k) "
            "and kdiag (B,) on one CUDA device in f32 or f64; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in (Kw, kni, kdiag)]}")
    B, k, _ = Kw.shape
    out = torch.empty((B, k + 1), dtype=dtype, device=Kw.device)
    if B == 0:
        return out
    lib = _build.load_library()
    fn = lib.agp_band_rows_f32 if dtype == torch.float32 else lib.agp_band_rows_f64
    stream = torch.cuda.current_stream(Kw.device).cuda_stream
    sk, sc = Kw.stride(), kni.stride()
    with torch.cuda.device(Kw.device):
        err = fn(Kw.data_ptr(), sk[0], sk[1], sk[2], kni.data_ptr(), sc[0], sc[1],
                 kdiag.data_ptr(), kdiag.stride(0), out.data_ptr(), B, k, stream)
    _build.check(err, "batched_chol_solve_band")
    batched_chol_solve_band.launches += 1
    return out


class _BandRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, c, kdiag, plain):
        ctx.save_for_backward(A, c, kdiag)
        return _masked_band_plain(A, c, kdiag) if plain else batched_chol_solve_band_pass(
            A, c, kdiag)

    @staticmethod
    def backward(ctx, gbar):
        A, c, kdiag = ctx.saved_tensors
        return (*band_bwd(A, c, kdiag, gbar.to(A.dtype)), None)


def masked_chol_solve_band_math(A: torch.Tensor, c: torch.Tensor,
                                kdiag: torch.Tensor) -> torch.Tensor:
    """Band rows from prebuilt masked Grams: A (B, k, k), c (B, k), kdiag
    (B,) → (B, k+1) = [−b·F^(−1/2), F^(−1/2)], b = A⁻¹c, F = kdiag − c·b
    floored at 8·eps·kdiag.  Plain PyTorch on every device (the plain
    version of row 6), batched over B with a Python loop over the k
    columns; differentiable through :func:`band_bwd`."""
    return _BandRows.apply(A, c, kdiag, True)


def batched_chol_solve_band(Kw: torch.Tensor, kni: torch.Tensor,
                            kdiag: torch.Tensor) -> torch.Tensor:
    """Row 6 of the kernel table: :func:`masked_chol_solve_band_math`'s
    band rows through the hand-written kernel on a CUDA tensor (k ≤ 64;
    the plain masked math on a CPU tensor), differentiable through the same
    closed-form :func:`band_bwd`."""
    return _BandRows.apply(Kw, kni, kdiag, False)


# ---------------------------------------------------------------------------
# Windows → Grams
# ---------------------------------------------------------------------------


def _window_r2(w: torch.Tensor) -> torch.Tensor:
    """(B, D, k+1) windows → (B, k+1, k+1) squared distances from exact
    differences (a point paired with itself gives exactly 0)."""
    dd = w[:, :, :, None] - w[:, :, None, :]
    return torch.sum(dd * dd, dim=1)


def window_gram_inputs(w, valid, kmap: KernelMap, nugget=None, nugget_self: bool = True):
    """(B, D, k+1) windows and a (B, k) 0/1 neighbour mask → the masked
    (Kw (B, k, k), kni (B, k), kdiag (B,)) of the band's math.

    Invalid neighbour slots become identity rows with zero coupling.  A
    ``nugget`` (a one-element tensor, or one value a window, (B,)) adds to
    the valid neighbours' diagonal and, with ``nugget_self``, to kdiag
    (slot k).  Differentiable in ``w`` and ``nugget``."""
    k = valid.shape[-1]
    G = kmap.k_of_r2(_window_r2(w))
    pm = valid[:, :, None] * valid[:, None, :]
    eye = torch.eye(k, dtype=w.dtype, device=w.device)
    Kw = G[:, :k, :k] * pm + (1.0 - pm) * eye
    kni = G[:, :k, k] * valid
    kdiag = G[:, k, k]
    if nugget is not None:
        Kw = Kw + nugget.reshape(-1, 1, 1) * (eye * pm)
        if nugget_self:
            kdiag = kdiag + nugget.reshape(-1)
    return Kw, kni, kdiag


def _bordered_gram(xw, valid, kmap: KernelMap, nugget, nugget_self: bool):
    """The masked (k+1)×(k+1) window Gram of the bordered factorization,
    slot k always valid."""
    N, _, kp1 = xw.shape
    k = kp1 - 1
    validp = torch.cat([valid, valid.new_ones((N, 1))], dim=1)
    pm = validp[:, :, None] * validp[:, None, :]
    eye = torch.eye(kp1, dtype=xw.dtype, device=xw.device)
    Gm = kmap.k_of_r2(_window_r2(xw)) * pm + (1.0 - pm) * eye
    if nugget is not None:
        nugmask = eye * pm
        if not nugget_self:
            nugmask[:, k, k] = 0.0
        Gm = Gm + nugget * nugmask
    return Gm


def vecchia_band_plain(xw, valid, kmap: KernelMap, nugget=None,
                       nugget_self: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the bordered (k+1) Cholesky
    of rows 8 and 10.

    chol([[Kw, kni], [kniᵀ, kdiag]]) has the last row [wᵀ, √F] with
    w = L⁻¹kni: the last pivot is the conditional variance F, and
    b = L⁻ᵀw is one back substitution over the leading k×k block.  Each
    pivot is floored at 8·eps of its slot's original diagonal (slot k's is
    kdiag, plus the nugget with ``nugget_self``), and a floored pivot
    deflates its column.  xw (N, D, k+1), valid (N, k) → (N, k+1)."""
    N, _, kp1 = xw.shape
    k = kp1 - 1
    A = _bordered_gram(xw, valid, kmap, nugget, nugget_self)
    floors = _floor(torch.diagonal(A, dim1=1, dim2=2))
    L = torch.zeros_like(A)
    for j in range(kp1):
        d_raw = A[:, j, j]
        d = torch.maximum(d_raw, floors[:, j])
        notc = (d_raw >= floors[:, j]).to(A.dtype)
        sq = torch.sqrt(d)
        col = A[:, j + 1:, j] * (notc / sq)[:, None]
        L[:, j, j] = sq
        L[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    inv_sqrt_F = 1.0 / L[:, k, k]
    b = torch.zeros((N, k), dtype=xw.dtype, device=xw.device)
    for i in reversed(range(k)):
        s = torch.sum(L[:, i + 1:k, i] * b[:, i + 1:], dim=1)
        b[:, i] = (L[:, k, i] - s) / L[:, i, i]
    return torch.cat([-b * inv_sqrt_F[:, None], inv_sqrt_F[:, None]], dim=1)


# ---------------------------------------------------------------------------
# The kernel's wrapper and the autograd Function
# ---------------------------------------------------------------------------


def _check_cuda_args(what: str, xw, valid, nugget, gbar=None) -> None:
    """Raise unless the kernel takes these tensors: windows (N, D <= 8,
    k + 1) with 1 <= k <= 64, an (N, k) mask, an optional one-element nugget
    and an optional (N, k + 1) cotangent, on one CUDA device in f32 or f64."""
    tensors = [t for t in (xw, valid, nugget, gbar) if t is not None]
    dtype = xw.dtype
    if (
        not all(t.is_cuda and t.device == xw.device and t.dtype == dtype for t in tensors)
        or dtype not in (torch.float32, torch.float64)
        or xw.ndim != 3 or valid.ndim != 2
        or not 1 <= xw.shape[1] <= MAX_D or not 2 <= xw.shape[2] <= MAX_K + 1
        or tuple(valid.shape) != (xw.shape[0], xw.shape[2] - 1)
        or (nugget is not None and nugget.numel() != 1)
        or (gbar is not None and tuple(gbar.shape) != (xw.shape[0], xw.shape[2]))
    ):
        raise ValueError(
            f"{what}: needs windows (N, D <= {MAX_D}, k + 1) with 1 <= k <= {MAX_K}, a "
            "(N, k) mask, an optional one-element nugget and (backward) an (N, k + 1) "
            "cotangent, on one CUDA device in f32 or f64; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]}")


def vecchia_band_pass(xw, valid, kmap: KernelMap, nugget=None,
                      nugget_self: bool = True) -> torch.Tensor:
    """Band rows of the windows ``xw`` (N, D, k+1), any strides, with the
    0/1 mask ``valid`` (N, k), any strides (a broadcast view reads one
    value); ``nugget`` None or a one-element tensor.  A CPU tensor takes
    :func:`vecchia_band_plain`; a CUDA tensor launches the kernel of
    ``csrc/vecchia_band.cu`` or raises.  Not differentiable itself:
    :func:`vecchia_band` is."""
    if xw.device.type == "cpu":
        return vecchia_band_plain(xw, valid, kmap, nugget, nugget_self)
    _check_cuda_args("vecchia_band", xw, valid, nugget)
    N, D, kp1 = xw.shape
    out = torch.empty((N, kp1), dtype=xw.dtype, device=xw.device)
    if N == 0:
        return out
    lib = _build.load_library()
    fn = lib.agp_vecchia_band_f32 if xw.dtype == torch.float32 else lib.agp_vecchia_band_f64
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    sx, sv = xw.stride(), valid.stride()
    with torch.cuda.device(xw.device):
        err = fn(xw.data_ptr(), sx[0], sx[1], sx[2], valid.data_ptr(), sv[0], sv[1],
                 None if nugget is None else nugget.data_ptr(), int(nugget_self),
                 out.data_ptr(), N, D, kp1 - 1, int(kmap.id), stream)
    _build.check(err, "vecchia_band")
    vecchia_band.launches += 1
    return out


def _recompute_pullback(xw, valid, kmap, nugget, nugget_self, gbar, need_x, need_nug):
    """The plain version of the pullback kernel: (x̄w, the nugget's
    per-window partials (N,)) by recomputing each chunk of windows' Grams
    under autograd, with the nugget taken one value a window, and applying
    :func:`band_bwd`, ``_BWD_CHUNK`` windows at a time."""
    N = xw.shape[0]
    xw_bar = torch.zeros_like(xw) if need_x else None
    nug_bar = xw.new_zeros(N) if need_nug else None
    for i0 in range(0, N, _BWD_CHUNK):
        sl = slice(i0, i0 + _BWD_CHUNK)
        w = xw[sl].detach().requires_grad_(need_x)
        nug = None if nugget is None else (
            nugget.detach().reshape(1).expand(w.shape[0]).clone().requires_grad_(need_nug))
        with torch.enable_grad():
            Kw, kni, kdiag = window_gram_inputs(w, valid[sl], kmap, nug, nugget_self)
        bars = band_bwd(Kw.detach(), kni.detach(), kdiag.detach(), gbar[sl])
        wanted = [t for t, need in ((w, need_x), (nug, need_nug)) if need]
        # without x̄w and without slot k's nugget only Kw depends on the nugget
        outs = [(t, b) for t, b in zip((Kw, kni, kdiag), bars) if t.requires_grad]
        grads = list(torch.autograd.grad([t for t, _ in outs], wanted, [b for _, b in outs],
                                         allow_unused=True))
        if need_x:
            g = grads.pop(0)
            if g is not None:
                xw_bar[sl] = g
        if need_nug:
            g = grads.pop(0)
            if g is not None:
                nug_bar[sl] = g
    return xw_bar, nug_bar


def vecchia_band_bwd_pass(xw, valid, kmap: KernelMap, nugget, nugget_self: bool, gbar,
                          need_x: bool = True, need_nug: bool = True, per_window: bool = False):
    """(x̄w, nugget‾), the pullback of :func:`vecchia_band_pass` at the band
    cotangent ``gbar`` (N, k+1), each None where not needed (nugget‾ always
    where there is no nugget).  A CPU tensor takes :func:`_recompute_pullback`;
    a CUDA tensor launches the kernel of ``csrc/vecchia_band_bwd.cu`` or
    raises.  x̄w comes in ``xw``'s strides where it is dense (row 10's
    (D, k+1, N) view gets a (D, k+1, N) cotangent).  Both routes give the
    nugget's per-window partials (N,): nugget‾, shaped like ``nugget``, is
    their fixed-order sum on the device, or with ``per_window`` the partials
    themselves."""
    need_nug = need_nug and nugget is not None
    if xw.device.type == "cpu":
        xw_bar, nbar = _recompute_pullback(xw, valid, kmap, nugget, nugget_self, gbar, need_x,
                                           need_nug)
    else:
        _check_cuda_args("vecchia_band_bwd", xw, valid, nugget, gbar)
        N, D, kp1 = xw.shape
        xw_bar = torch.empty_like(xw)
        nbar = None if nugget is None else torch.empty(N, dtype=xw.dtype, device=xw.device)
        if N > 0:
            lib = _build.load_library()
            fn = (lib.agp_vecchia_band_bwd_f32 if xw.dtype == torch.float32
                  else lib.agp_vecchia_band_bwd_f64)
            stream = torch.cuda.current_stream(xw.device).cuda_stream
            sx, sv, sg, sb = xw.stride(), valid.stride(), gbar.stride(), xw_bar.stride()
            with torch.cuda.device(xw.device):
                err = fn(xw.data_ptr(), sx[0], sx[1], sx[2], valid.data_ptr(), sv[0], sv[1],
                         None if nugget is None else nugget.data_ptr(), int(nugget_self),
                         gbar.data_ptr(), sg[0], sg[1], xw_bar.data_ptr(), sb[0], sb[1], sb[2],
                         None if nbar is None else nbar.data_ptr(), N, D, kp1 - 1,
                         int(kmap.id), stream)
            _build.check(err, "vecchia_band_bwd")
            vecchia_band_bwd.launches += 1
    if not need_nug:
        nbar = None
    elif not per_window:
        nbar = torch.sum(nbar).reshape(nugget.shape)
    return (xw_bar if need_x else None), nbar


class _VecchiaBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, valid, nugget, kmap, nugget_self):
        ctx.kmap, ctx.nugget_self = kmap, nugget_self
        ctx.save_for_backward(xw, valid, nugget)
        return vecchia_band_pass(xw, valid, kmap, nugget, nugget_self)

    @staticmethod
    def backward(ctx, gbar):
        xw, valid, nugget = ctx.saved_tensors
        need_x, _, need_nug = ctx.needs_input_grad[:3]
        xw_bar, nug_bar = vecchia_band_bwd_pass(xw, valid, ctx.kmap, nugget, ctx.nugget_self,
                                                gbar.to(xw.dtype), need_x, need_nug)
        return xw_bar, None, nug_bar, None, None


def _nugget(nugget, like: torch.Tensor):
    if nugget is None:
        return None
    return torch.as_tensor(nugget, dtype=like.dtype, device=like.device).reshape(1)


def vecchia_band(xw: torch.Tensor, valid: torch.Tensor, kmap: KernelMap, nugget=None,
                 nugget_self: bool = True) -> torch.Tensor:
    """Vecchia band rows from (N, D, k+1) point windows (rows 7 and 8 of
    the kernel table): ``xw[i, :, t]`` is neighbour t of window i, slot k
    the conditioned point; ``valid`` (N, k) the 0/1 neighbour mask;
    ``kmap`` a parameter-free stationary map (fold lengthscales into xw and
    divide the band by σ for a variance σ²).  ``nugget`` (a scalar or
    one-element tensor; keep it on the card) adds to the valid diagonal,
    slot k included only with ``nugget_self``.  Returns (N, k+1)
    [−b·F^(−1/2), F^(−1/2)]; invalid slots hold exactly 0.  Differentiable
    in ``xw`` and ``nugget``."""
    return _VecchiaBand.apply(xw, valid, _nugget(nugget, xw), kmap, nugget_self)


def vecchia_band_t(xwT: torch.Tensor, validT: torch.Tensor, kmap: KernelMap,
                   nugget=None) -> torch.Tensor:
    """:func:`vecchia_band` on transposed windows (row 10): ``xwT``
    (D, k+1, N) and ``validT`` (k, N), the layout in which sliding
    (previous-k) windows are built N-minor.  The kernel reads them through
    their strides; returns the (N, k+1) band."""
    return _VecchiaBand.apply(xwT.permute(2, 0, 1), validT.T, _nugget(nugget, xwT), kmap, True)


def vecchia_band_bwd(xw: torch.Tensor, valid: torch.Tensor, kmap: KernelMap, gbar: torch.Tensor,
                     nugget=None, nugget_self: bool = True, per_window: bool = False):
    """The pullback of :func:`vecchia_band` (row 9 of the kernel table) on its
    own: (x̄w, nugget‾) of ⟨gbar, vecchia_band(xw, valid, kmap, nugget,
    nugget_self)⟩; nugget‾ is None without a nugget, and with ``per_window``
    the (N,) partials of each window instead of their sum."""
    return vecchia_band_bwd_pass(xw, valid, kmap, _nugget(nugget, xw), nugget_self, gbar,
                                 per_window=per_window)


vecchia_band.launches = 0
vecchia_band_bwd.launches = 0
batched_chol_solve_band.launches = 0
