"""Block-Vecchia GP approximation (port of
``approximategps_tpu/models/block_vecchia.py``; Pan et al., arXiv
2410.04477).

The ordered points are grouped into blocks of ``b``, and the joint
factorizes as ∏_B p(f_B | f_{nb(B)}): one k×k Cholesky, a k×b solve and a
b×b Cholesky per block, N/b factorizations of (k, b)-sized operands instead
of N of k×k.  b = 1 recovers scalar Vecchia; full conditioning recovers the
exact GP.  Per block B with neighbour set nb(B),

    C_B = (K_nb⁻¹ K_{nb,B})ᵀ                 (b × k regression weights)
    S_B = K_BB − K_{B,nb} K_nb⁻¹ K_{nb,B}    (b × b conditional covariance)

give the block-sparse precision root U = (I − C)ᵀ blockdiag(L_{S_B})⁻ᵀ that
``BlockInvRoot`` applies for the lml, the posterior and whitening.

No hand-written kernel runs here: the block Grams are built batched through
each kernel's own ``gram`` (as the windowed Vecchia tier builds its window
Grams) and factored by ``torch.linalg``'s batched Cholesky and triangular
solves, with ``cholesky_ex``: no host check of the factorizations' info
(a sync), and a block whose factorization fails gets a NaN factor, as in
the JAX package, rather than an error.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import linalg
from ..core.gp import FiniteGP, PosteriorGP
from ..core.kernels import Kernel, as_points
from .api import approx_lml, posterior
from .vecchia import resolve_ordering

__all__ = ["BlockNearestNeighbors", "BlockInvRoot", "block_vecchia_factors"]

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class BlockNearestNeighbors:
    """Block-Vecchia approximation: blocks of ``block_size`` points, each
    conditioning on ``k`` predecessor points.

    ``neighbors="previous"``: the k points just before the block in the
    ordering (contiguous).  ``neighbors="nearest"``: the k predecessors
    closest to the block's centroid (an exact search on the host).
    ``ordering`` as in :class:`~approximategps_tpu_torch.models.vecchia.NearestNeighbors`."""

    block_size: int
    k: int
    ordering: str = "natural"
    neighbors: str = "previous"


@dataclasses.dataclass(frozen=True, eq=False)
class BlockInvRoot:
    """``inv(U Uᵀ)`` for the block-sparse root.

    ``nbr``: (NB, k) global point indices of each block's neighbours (−1
    pads); ``C``: (NB, b, k) regression weights; ``Ls_inv``: (NB, b, b)
    inverse Cholesky factors of the conditional covariances.  Block B owns
    rows [B·b, (B+1)·b)."""

    nbr: torch.Tensor
    C: torch.Tensor
    Ls_inv: torch.Tensor

    def whiten(self, X: torch.Tensor) -> torch.Tensor:
        """V = Uᵀ X: V_B = L_{S_B}⁻¹ (X_B − C_B X_{nb(B)})."""
        vec = X.ndim == 1
        Xm = X[:, None] if vec else X
        NB, b, _ = self.C.shape
        N = NB * b
        Xb = Xm[:N].reshape(NB, b, -1)
        Xnb = Xm[torch.clamp(self.nbr, 0, N - 1)]  # (NB, k, P); a −1 pad reads row 0
        out = (self.Ls_inv @ (Xb - self.C @ Xnb)).reshape(N, -1)
        return out[:, 0] if vec else out

    def u_matvec(self, w: torch.Tensor) -> torch.Tensor:
        """U w: the block-diagonal part L_{S_B}⁻ᵀ w_B, minus the neighbour
        coupling C_Bᵀ L_{S_B}⁻ᵀ w_B added into the rows nb(B)."""
        NB, b, _ = self.C.shape
        N = NB * b
        t = torch.einsum("nij,ni->nj", self.Ls_inv, w[:N].reshape(NB, b))  # L⁻ᵀ w_B
        contrib = -torch.einsum("nbk,nb->nk", self.C, t) * (self.nbr >= 0).to(w.dtype)
        idx = torch.clamp(self.nbr, 0, N - 1).reshape(-1)
        return t.reshape(N).index_add(0, idx, contrib.reshape(-1))

    def logdet(self) -> torch.Tensor:
        """logdet(inv(U Uᵀ)) = −2 logdet U = −2 Σ log diag(L_{S_B}⁻¹)."""
        return -2.0 * torch.sum(torch.log(torch.diagonal(self.Ls_inv, dim1=-2, dim2=-1)))

    def quad(self, delta: torch.Tensor) -> torch.Tensor:
        """δᵀ U Uᵀ δ through the whitened residuals."""
        v = self.whiten(delta)
        return torch.sum(v * v)


def _block_neighbor_indices(N: int, b: int, k: int, neighbors: str, X_ordered: torch.Tensor):
    """(NB, k) global indices (−1 padded) of each block's conditioning set,
    on ``X_ordered``'s device."""
    NB = N // b
    dev = X_ordered.device
    if neighbors == "previous":
        idx = (torch.arange(NB, device=dev) * b)[:, None] - k + torch.arange(k, device=dev)
        return torch.where(idx >= 0, idx, torch.full_like(idx, -1))
    if neighbors != "nearest":
        raise ValueError(f"unknown neighbors: {neighbors!r}")
    Xc = X_ordered.detach().cpu().numpy()  # the host search reads a copy
    nbr = np.full((NB, k), -1, dtype=np.int64)
    for B in range(1, NB):
        lo = B * b
        centroid = Xc[lo:lo + b].mean(axis=0)
        d = ((Xc[:lo] - centroid) ** 2).sum(-1)
        m = min(k, lo)
        nbr[B, :m] = np.sort(np.argpartition(d, m - 1)[:m]) if m < lo else np.arange(lo)[:m]
    return torch.as_tensor(nbr, device=dev)


def _batched_gram(kern: Kernel, A: torch.Tensor, B: torch.Tensor | None = None) -> torch.Tensor:
    """The Grams of a batch of point sets (NB, n, D) [× (NB, m, D)] through
    the kernel's own ``gram``, vmapped over the blocks."""
    if B is None:
        return torch.func.vmap(lambda a: kern.gram(a))(A)
    return torch.func.vmap(lambda a, c: kern.gram(a, c))(A, B)


def block_vecchia_factors(x, nbr: torch.Tensor, b: int, kern: Kernel, jitter: float = 0.0):
    """Per-block (C, Ls_inv) from one batched factorization pass."""
    Xp = as_points(x)
    N, D = Xp.shape
    NB = N // b
    k = nbr.shape[1]
    Xb = Xp[:NB * b].reshape(NB, b, D)
    dtype, dev = Xp.dtype, Xp.device
    eps = torch.finfo(dtype).eps
    eye_k = torch.eye(k, dtype=dtype, device=dev)
    eye_b = torch.eye(b, dtype=dtype, device=dev)

    mask = nbr >= 0
    Xnb = Xp[torch.clamp(nbr, 0, N - 1)]  # (NB, k, D)
    K_nb = torch.where(mask[:, :, None] & mask[:, None, :], _batched_gram(kern, Xnb), eye_k)
    K_nbB = torch.where(mask[:, :, None], _batched_gram(kern, Xnb, Xb), 0.0)  # (NB, k, b)
    K_BB = _batched_gram(kern, Xb) + jitter * eye_b
    L_nb = linalg.cholesky_or_nan(K_nb + 8.0 * eps * eye_k)
    W = torch.cholesky_solve(K_nbB, L_nb)  # K_nb⁻¹ K_{nb,B}
    C = W.transpose(-1, -2)  # (NB, b, k)
    S = linalg.symmetrize(K_BB - K_nbB.transpose(-1, -2) @ W)
    trace = torch.diagonal(K_BB, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    S = S + 8.0 * eps * trace / b * eye_b
    L_S = linalg.cholesky_or_nan(S)
    Ls_inv = torch.linalg.solve_triangular(L_S, eye_b, upper=False)
    return C, Ls_inv


def _build_block_root(nn: BlockNearestNeighbors, fx: FiniteGP):
    Xp = as_points(fx.x)
    N = Xp.shape[0]
    b = nn.block_size
    if N % b:
        raise ValueError(f"block_size={b} must divide N={N} (pad the data or change b)")
    if nn.ordering == "natural":  # no permutation to copy from the host
        order = torch.arange(N, device=Xp.device)
    else:
        order = torch.as_tensor(resolve_ordering(Xp, nn.ordering), device=Xp.device)
    Xo = Xp[order]
    nbr = _block_neighbor_indices(N, b, nn.k, nn.neighbors, Xo)
    C, Ls_inv = block_vecchia_factors(Xo, nbr, b, fx.f.kernel)
    return order, Xo, BlockInvRoot(nbr=nbr, C=C, Ls_inv=Ls_inv)


@posterior.register(BlockNearestNeighbors)
def _posterior_block(nn: BlockNearestNeighbors, fx: FiniteGP, y: torch.Tensor, **_):
    """A PosteriorGP over the reordered points with the block root as its
    precision.  The root ignores ``fx``'s noise, as the JAX package's does."""
    order, Xo, rep = _build_block_root(nn, fx)
    delta = y[order] - fx.f.mean(Xo)
    alpha = rep.u_matvec(rep.whiten(delta))
    return PosteriorGP(prior=fx.f, x=Xo, alpha=alpha, rep=rep, delta=delta)


@approx_lml.register(BlockNearestNeighbors)
def _approx_lml_block(nn: BlockNearestNeighbors, fx: FiniteGP, y: torch.Tensor, **_):
    """−(logdet C + N log 2π + δᵀ U Uᵀ δ)/2."""
    order, Xo, rep = _build_block_root(nn, fx)
    delta = y[order] - fx.f.mean(Xo)
    return -(rep.logdet() + y.shape[0] * _LOG2PI + rep.quad(delta)) / 2.0
