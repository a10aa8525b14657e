"""Nearest-neighbour (Vecchia) GP approximation: the port of
``approximategps_tpu/models/vecchia.py``.

The joint factorises as ∏ p(f_i | f_{i−k:i−1}) over the k previous points in
the given order, giving a sparse precision root U = (I−B)ᵀ F^(−1/2).  Under
the previous-k order U is banded and stored as an (N, k+1) band; each
point's row of B and its conditional variance F_i come from one small
Cholesky factorization of its window.

On the kernel device the whole window → Gram → factor → band construction is
the hand-written kernel of ``ops/batched_chol.py`` (``vecchia_band`` and
``vecchia_band_t``), and its pullback the hand-written pullback kernel
(``vecchia_band_bwd``); a ``σ²·k + τ²·White`` kernel rides them as a
nugget τ²/σ² on the window Gram's diagonal.  Where that kernel does not take
the problem — a kernel that does not unwrap to a scaled stationary map (plus
a white term for the root: the rational quadratic, periodic, linear,
polynomial and product kernels), noise that is not a scalar
(``predict_knn``), or D > 8 — the windows' Grams are built in PyTorch
through each kernel's own ``gram`` and factored by row 6's kernel
(``batched_chol_solve_band``, the JAX package's windowed tier behind
``use_pallas=True``).  Elsewhere (a CPU tensor, kernels off) and above
k = 64 the same Grams go to the plain masked math
(``masked_chol_solve_band_math``).

Orderings other than the natural one and neighbour sets other than the
previous k are host-side preprocessing (``native/``): the points are
reordered and the root is the sparse one over gathered predecessor sets
(``_posterior_nn_general``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, kernel_device
from ..core.gp import FiniteGP, PosteriorGP
from ..core.kernels import (
    Kernel,
    _as_param,
    _param,
    as_points,
    unwrap_stationary,
    unwrap_stationary_nugget,
)
from ..ops.batched_chol import (
    MAX_D,
    MAX_K,
    batched_chol_solve_band,
    masked_chol_solve_band_math,
    vecchia_band,
    vecchia_band_t,
)
from ..native import maximin_ordering, nearest_predecessor_neighbors, scaled_ball_predecessors
from ..ops.knn import knn_search
from .api import approx_lml, posterior

__all__ = [
    "NearestNeighbors",
    "BandInvRoot",
    "SparseInvRoot",
    "approx_root_prec_band",
    "approx_root_prec_sparse",
    "resolve_ordering",
    "band_Ut_matmul",
    "band_U_matvec",
    "predict_knn",
]

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NearestNeighbors:
    """k-nearest-neighbour (Vecchia) approximation.

    ``block_size`` chunks the windowed tier's Grams to bound memory;
    ``use_kernels``: None (auto) takes the kernels on the kernel device (a
    CUDA tensor in f32 or f64) and the plain path elsewhere; True or False
    forces a route (True on a CPU tensor runs the kernels' autograd
    Functions with their plain inner passes).

    ``ordering``: "natural" (as given), "random" or "maximin" (greedy
    farthest-point, Guinness 2018).  ``neighbors``: "previous" (the last k
    in the ordering: banded), "nearest" (the k nearest among all
    predecessors) or "scaled" (the predecessors within ``rho``·ℓᵢ of point
    i, ℓᵢ its distance to the ordered set, capped at the k nearest: the
    KL-minimising pattern of Schäfer et al., arXiv 2004.14455).  ``rho``:
    the ball's radius multiplier for "scaled" (larger is denser and more
    accurate; 2–4 in practice).  Orderings and neighbour sets other than
    the defaults are computed on the host from the inputs' values."""

    k: int
    block_size: int | None = None
    use_kernels: bool | None = None
    ordering: str = "natural"
    neighbors: str = "previous"
    rho: float = 3.0


def _shift(X: torch.Tensor, sh: int) -> torch.Tensor:
    """X moved down by ``sh`` ≥ 1 rows, zeros in front."""
    sh = min(sh, X.shape[0])
    return torch.cat([X.new_zeros((sh,) + X.shape[1:]), X[:X.shape[0] - sh]])


def band_Ut_matmul(Uband: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Uᵀ X for the banded upper-triangular U, X of shape (N,) or (N, P):
    (Uᵀ X)[i] = Σ_t Uband[i, t] · X[i − k + t], as k+1 shifts of X.

    Band contract: the out-of-range slots (row i, t with i − k + t < 0) must
    hold exactly 0; every constructor here writes zeros there, and the
    shifts do not mask them again."""
    k = Uband.shape[1] - 1
    cols = Uband if X.ndim == 1 else Uband[:, :, None]
    out = cols[:, k] * X
    for t in range(k):
        out = out + cols[:, t] * _shift(X, k - t)
    return out


def band_U_matvec(Uband: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """U w for the banded upper-triangular U: (U w)[j] = Σ_s U[j, j+s] w[j+s]
    with U[j, j+s] = Uband[j+s, k−s], as k+1 shifts."""
    N, kp1 = Uband.shape
    k = kp1 - 1
    out = Uband[:, k] * w
    for s in range(1, min(kp1, N + 1)):
        out = out + torch.cat([Uband[s:, k - s] * w[s:], w.new_zeros((s,))])
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class BandInvRoot:
    """inv(U Uᵀ) through the band of U, pluggable into ``PosteriorGP`` as the
    JAX package's ``BandInvRoot``; ``Uband`` keeps the band contract of
    :func:`band_Ut_matmul`."""

    Uband: torch.Tensor  # (N, k+1); [:, -1] is the diagonal of U

    def whiten(self, X: torch.Tensor) -> torch.Tensor:
        """V = Uᵀ X, so VᵀV = Xᵀ inv(A) X."""
        return band_Ut_matmul(self.Uband, X)

    def logdet(self) -> torch.Tensor:
        """logdet inv(U Uᵀ) = −2 logdet U."""
        return -2.0 * torch.sum(torch.log(self.Uband[:, -1]))


@dataclasses.dataclass(frozen=True, eq=False)
class SparseInvRoot:
    """inv(U Uᵀ) for a general sparse upper-triangular root given by
    predecessor indices: ``nbr`` (N, k) positions (−1 pads), ``coeff`` (N, k)
    off-diagonal entries U[nbr[i, t], i], ``diag`` (N,) the diagonal."""

    nbr: torch.Tensor
    coeff: torch.Tensor
    diag: torch.Tensor

    def whiten(self, X: torch.Tensor) -> torch.Tensor:
        """V = Uᵀ X: V[i] = diag[i]·X[i] + Σ_t coeff[i, t]·X[nbr[i, t]]."""
        vec = X.ndim == 1
        Xm = X[:, None] if vec else X
        gathered = Xm[torch.clamp(self.nbr, 0, Xm.shape[0] - 1)]  # (N, k, P)
        out = self.diag[:, None] * Xm + torch.einsum("nt,ntp->np", self.coeff, gathered)
        return out[:, 0] if vec else out

    def u_matvec(self, w: torch.Tensor) -> torch.Tensor:
        """U w: (U w)[j] = diag[j]·w[j] + Σ_{i,t: nbr[i,t] = j} coeff[i, t]·w[i]."""
        idx = torch.clamp(self.nbr, 0, w.shape[0] - 1).reshape(-1)
        contrib = (self.coeff * w[:, None]).reshape(-1)  # zero where padded
        return (self.diag * w).index_add(0, idx, contrib)

    def logdet(self) -> torch.Tensor:
        return -2.0 * torch.sum(torch.log(self.diag))


def _use_kernels(use_kernels: bool | None, t: torch.Tensor) -> bool:
    """Auto (None): the band kernel on the kernel device, where kernels are
    allowed; True or False as given."""
    if use_kernels is not None:
        return use_kernels
    return config.use_kernels and kernel_device(t)


def _fused(kern: Kernel, D: int, k: int, unwrap=unwrap_stationary):
    """``unwrap(kern)`` where the band kernel takes the problem, else None:
    the windowed tier runs for a kernel that does not unwrap (the JAX
    package leaves its fused tier there too) and beyond the kernel's limits,
    D > 8 or k > 64."""
    if not 1 <= D <= MAX_D or not 1 <= k <= MAX_K:
        return None
    return unwrap(kern)


def _fused_band(Xp: torch.Tensor, k: int, kern: Kernel, nbr=None):
    """The band by the kernel, or None where it declines (:func:`_fused`).

    Lengthscales fold into the inputs and the variance post-scales the band
    (U(σ²k) = U(k)/σ); a white term τ²·White becomes the kernel's nugget
    τ²/σ², formed on the inputs' device in at least f32 and never a host
    float, so its gradient reaches τ² and σ².  ``nbr=None`` conditions on
    the previous k points: the windows are built N-minor as k shifts of each
    coordinate row (the (D, k+1, N) layout of row 10); an (N, k) ``nbr``
    (−1 pads) gathers arbitrary predecessor windows in the (N, D, k+1)
    layout of row 8, as a view of the gathered (N, k+1, D) points."""
    N, D = Xp.shape
    unwrapped = _fused(kern, D, k, unwrap_stationary_nugget)
    if unwrapped is None:
        return None
    kmap, scale, variance, white = unwrapped
    ratio = None
    if white is not None:
        rdt = torch.promote_types(Xp.dtype, torch.float32)
        ratio = _as_param(white).to(device=Xp.device, dtype=rdt)
        if variance is not None:
            ratio = ratio / _as_param(variance).to(device=Xp.device, dtype=rdt)
    Xs = Xp if scale is None else Xp * _param(scale, Xp)
    if nbr is None:
        rows = []
        for d in range(D):
            Xd = Xs[:, d]
            rows += [torch.cat([Xd[:1].expand(k - t), Xd[:max(N - k + t, 0)]])[:N]
                     for t in range(k)]
            rows.append(Xd)
        xwT = torch.stack(rows).reshape(D, k + 1, N)
        iota = torch.arange(N, device=Xp.device)
        validT = torch.stack([iota >= k - t for t in range(k)]).to(Xp.dtype)
        Uband = vecchia_band_t(xwT, validT, kmap, ratio)
    else:
        valid = (nbr >= 0).to(Xp.dtype)
        pts = torch.cat([Xs[torch.clamp(nbr, 0, N - 1)], Xs[:, None, :]], dim=1)
        Uband = vecchia_band(pts.transpose(1, 2), valid, kmap, ratio)
    if variance is not None:
        Uband = Uband / torch.sqrt(_param(variance, Uband))
    return Uband


def _window_grams(kern: Kernel, Xw: torch.Tensor, xi: torch.Tensor):
    """Batched (Kw (B, k, k), kni (B, k)) of windows Xw (B, k, D) and their
    points xi (B, D) through the kernel's own ``gram``, as the JAX package's
    ``vmap(window)`` builds them."""
    Kw = torch.func.vmap(lambda w: kern.gram(w))(Xw)
    kni = torch.func.vmap(lambda w, x: kern.gram(w, x[None, :])[:, 0])(Xw, xi)
    return Kw, kni


def _band_solver(kernels: bool, k: int):
    """The band rows of prebuilt Grams: row 6's kernel (its autograd
    Function) on the kernel route up to its k limit, else the plain masked
    math."""
    return batched_chol_solve_band if kernels and k <= MAX_K else masked_chol_solve_band_math


def _window_rows(Xp, nbr_rows, rows_idx, kern, kern_diag, solve):
    """Band rows of the points ``rows_idx`` with predecessor positions
    ``nbr_rows`` (−1 masked): masked window Grams, then ``solve``."""
    N = Xp.shape[0]
    mask = nbr_rows >= 0
    Kw, kni = _window_grams(kern, Xp[torch.clamp(nbr_rows, 0, N - 1)], Xp[rows_idx])
    pm = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(nbr_rows.shape[1], dtype=Kw.dtype, device=Kw.device)
    Kw = torch.where(pm, Kw, eye)
    kni = torch.where(mask, kni, torch.zeros_like(kni))
    return solve(Kw, kni, kern_diag[rows_idx])


def _windowed_band(Xp, nbr, kern, block_size, kernels: bool):
    """The band of the windowed tier, ``block_size`` points at a time."""
    N = Xp.shape[0]
    kern_diag = kern.diag(Xp)
    solve = _band_solver(kernels, nbr.shape[1])
    bs = N if block_size is None else max(1, min(block_size, N))
    idx = torch.arange(N, device=Xp.device)
    parts = [_window_rows(Xp, nbr[i0:i0 + bs], idx[i0:i0 + bs], kern, kern_diag, solve)
             for i0 in range(0, N, bs)]
    return torch.cat(parts)


def _previous_k(N: int, k: int, device) -> torch.Tensor:
    idx = torch.arange(N, device=device)[:, None] - k + torch.arange(k, device=device)[None, :]
    return torch.where(idx >= 0, idx, torch.full_like(idx, -1))


def approx_root_prec_band(x, k: int, kern: Kernel, block_size=None, use_kernels=None):
    """Banded upper-triangular root of the approximate precision,
    U = (I−B)ᵀ F^(−1/2), as an (N, k+1) band: ``Uband[i, t] = U[i−k+t, i]``.

    On the kernel device (auto) the windows go through the band kernel in
    one launch (row 10's layout); where it declines, the windowed tier
    builds the window Grams in blocks of ``block_size`` points for row 6's
    kernel, one launch a block; the plain path does the same with the
    masked math."""
    Xp = as_points(x)
    kernels = _use_kernels(use_kernels, Xp)
    if kernels:
        fused = _fused_band(Xp, k, kern)
        if fused is not None:
            return fused
    return _windowed_band(Xp, _previous_k(Xp.shape[0], k, Xp.device), kern, block_size, kernels)


def approx_root_prec_sparse(x, nbr, kern: Kernel, block_size=None,
                            use_kernels=None) -> SparseInvRoot:
    """Sparse precision root for arbitrary predecessor sets ``nbr`` (N, k),
    −1 padded: the band kernel on gathered windows (row 8's layout) where
    it serves, else the windowed tier (row 6 on the kernel route, the plain
    masked math elsewhere)."""
    Xp = as_points(x)
    nbr = torch.as_tensor(nbr, device=Xp.device).to(torch.int64)
    k = nbr.shape[1]
    kernels = _use_kernels(use_kernels, Xp)
    band = _fused_band(Xp, k, kern, nbr=nbr) if kernels else None
    if band is None:
        band = _windowed_band(Xp, nbr, kern, block_size, kernels)
    return SparseInvRoot(nbr=nbr, coeff=band[:, :k], diag=band[:, k])


@posterior.register(NearestNeighbors)
def _posterior_nn(nn: NearestNeighbors, fx: FiniteGP, y: torch.Tensor, **_):
    """A PosteriorGP with the band as its precision: data (α = U Uᵀ δ,
    C = inv(U Uᵀ), x, δ).  The root ignores ``fx``'s noise, as the JAX
    package's does."""
    if nn.ordering != "natural" or nn.neighbors != "previous":
        return _posterior_nn_general(nn, fx, y)
    Uband = approx_root_prec_band(fx.x, nn.k, fx.f.kernel, nn.block_size, nn.use_kernels)
    delta = y - fx.mean()
    alpha = band_U_matvec(Uband, band_Ut_matmul(Uband, delta))
    return PosteriorGP(prior=fx.f, x=as_points(fx.x), alpha=alpha, rep=BandInvRoot(Uband),
                       delta=delta)


@approx_lml.register(NearestNeighbors)
def _approx_lml_nn(nn: NearestNeighbors, fx: FiniteGP, y: torch.Tensor, **_):
    """−(logdet C + N log 2π + αᵀδ)/2."""
    post = _posterior_nn(nn, fx, y)
    return -(post.rep.logdet() + y.shape[0] * _LOG2PI + post.alpha @ post.delta) / 2.0


def predict_knn(fx: FiniteGP, y: torch.Tensor, xs, k: int = 32, test_block: int = 4096,
                train_block: int = 65536, knn_mode: str = "auto", use_kernels=None):
    """Vecchia serving: each test point conditions only on its k nearest
    noisy observations (local kriging).  Returns the (mean, var) of the
    latent f at ``xs``, without any (N, N*) cross-covariance.

    The k-NN search (``ops.knn.knn_search``) runs a tile of ``test_block``
    points at a time.  On the kernel device (scalar noise, a kernel that
    unwraps, D ≤ 8, k ≤ 64) all N* windows then go through the band kernel in
    one launch, with the noise ratio as a nugget on the neighbours' diagonal
    only (``nugget_self=False``: slot k is the noise-free test point); the
    band row is the kriging weight b = Kw⁻¹kni and the conditional variance
    F in disguise.  Otherwise (noise that is not a scalar, a kernel that
    does not unwrap, D > 8) the windows' Grams are built in PyTorch,
    ``test_block`` points at a time, for row 6's kernel on the kernel device
    (one launch a block, k ≤ 64: the JAX package's k > 48 branch, whose
    k ≤ 48 twin is the same math) and the plain masked math elsewhere.

    Pass the signal kernel with the noise as ``fx``'s noise."""
    Xp = as_points(fx.x)
    Xs = as_points(xs)
    idx, _ = knn_search(Xp, Xs, min(k, Xp.shape[0]), train_block, test_block, knn_mode)
    return _krige(fx, y, Xs, idx, test_block, use_kernels)


def _krige(fx: FiniteGP, y: torch.Tensor, Xs: torch.Tensor, idx: torch.Tensor,
           test_block: int, use_kernels):
    """``predict_knn`` after the search: (mean, var) at the test points Xs
    (N*, D) from their neighbours' indices idx (N*, k)."""
    Xp = as_points(fx.x)
    N, D = Xp.shape
    k = idx.shape[1]
    kern = fx.f.kernel
    delta = y - fx.mean()
    noise = torch.as_tensor(fx.noise, dtype=Xp.dtype, device=Xp.device)
    mean_s = fx.f.mean(Xs)

    kernels = _use_kernels(use_kernels, Xp)
    fused = None
    # noise that is not a scalar has no single nugget ratio: the windowed
    # tier (the JAX package's fused tier takes scalar noise only)
    if noise.ndim == 0 and kernels:
        fused = _fused(kern, D, k)
    if fused is not None:
        kmap, scale, variance = fused
        var_s = Xp.new_ones(()) if variance is None else _param(variance, Xp)
        Xps = Xp if scale is None else Xp * _param(scale, Xp)
        Xss = Xs if scale is None else Xs * _param(scale, Xs)
        # the kriging weights are variance-invariant (U(σ²A) = U(A)/σ), so the
        # unit-variance band serves; F = σ²·F_unit from its last entry
        pts = torch.cat([Xps[idx], Xss[:, None, :]], dim=1)  # (N*, k+1, D)
        valid = Xp.new_ones(()).expand(Xs.shape[0], k)
        band = vecchia_band(pts.transpose(1, 2), valid, kmap, nugget=noise / var_s,
                            nugget_self=False)
        b = -band[:, :k] / band[:, k:]
        mu = mean_s + torch.sum(b * delta[idx], dim=1)
        var = var_s / torch.square(band[:, k])
        return mu, torch.clamp(var, min=0.0)

    noise_d = noise.expand(N) if noise.ndim == 0 else (noise if noise.ndim == 1
                                                       else torch.diagonal(noise))
    kdiag_s = kern.diag(Xs)
    solve = _band_solver(kernels, k)
    mus, variances = [], []
    for i0 in range(0, Xs.shape[0], test_block):
        w = idx[i0:i0 + test_block]
        Kw, kni = _window_grams(kern, Xp[w], Xs[i0:i0 + test_block])
        band = solve(Kw + torch.diag_embed(noise_d[w]), kni, kdiag_s[i0:i0 + test_block])
        b = -band[:, :k] / band[:, k:]
        mus.append(mean_s[i0:i0 + test_block] + torch.sum(b * delta[w], dim=1))
        variances.append(torch.clamp(1.0 / torch.square(band[:, k]), min=0.0))
    return torch.cat(mus), torch.cat(variances)


def resolve_ordering(x, ordering: str, key=None) -> np.ndarray:
    """The (N,) permutation of ``ordering`` on the host (numpy): "natural",
    "maximin" or "random" (numpy's generator seeded with ``key``, 0 by
    default, as the JAX package seeds it)."""
    Xp = as_points(x)
    if ordering == "natural":
        return np.arange(Xp.shape[0])
    if ordering == "maximin":
        return maximin_ordering(Xp.detach().cpu().numpy())
    if ordering == "random":
        return np.random.default_rng(0 if key is None else int(key)).permutation(Xp.shape[0])
    raise ValueError(f"unknown ordering: {ordering!r}")


def _posterior_nn_general(nn: NearestNeighbors, fx: FiniteGP, y: torch.Tensor):
    """Other orderings and neighbour sets: reorder the data on the host,
    build the sparse root over the gathered predecessor sets, and return a
    PosteriorGP over the reordered points (predictions do not depend on the
    order)."""
    Xp = as_points(fx.x)
    Xh = Xp.detach().cpu().numpy()  # the host copy the ordering code reads
    order = resolve_ordering(Xh, nn.ordering)
    if nn.neighbors == "nearest":
        nbr = nearest_predecessor_neighbors(Xh, order, nn.k)
    elif nn.neighbors == "scaled":
        nbr = scaled_ball_predecessors(Xh, order, nn.rho, nn.k)
    elif nn.neighbors == "previous":
        nbr = _previous_k(Xp.shape[0], nn.k, "cpu")
    else:
        raise ValueError(f"unknown neighbors: {nn.neighbors!r}")
    order_t = torch.as_tensor(order, device=Xp.device)
    Xo = Xp[order_t]
    rep = approx_root_prec_sparse(Xo, torch.as_tensor(nbr, device=Xp.device), fx.f.kernel,
                                  nn.block_size, nn.use_kernels)
    delta = y[order_t] - fx.f.mean(Xo)
    alpha = rep.u_matvec(rep.whiten(delta))
    return PosteriorGP(prior=fx.f, x=Xo, alpha=alpha, rep=rep, delta=delta)
