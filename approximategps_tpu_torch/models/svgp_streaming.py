"""Streaming SVGP ELBO over a full data set (port of
``approximategps_tpu/models/svgp_streaming.py``: ``streaming_data_term``,
``streaming_elbo`` and ``dp_streaming_elbo``).

The data term is summed block by block, so the (M, N) cross-covariance is
never formed.  The posterior cache comes from ``chol_with_inv`` (the (L, L⁻¹)
kernel of a given matrix on the card) and the S-correction
``S = Lk⁻ᵀ(BBᵀ−I)Lk⁻¹``, formed once outside the loop.  Each block goes
through the fused epilogue ``ops.svgp_epilogue.svgp_data_epilogue``, whose
backward kernel rebuilds K0 on the card, where it serves (``prefer=remat``);
on the card one epilogue call takes as many consecutive blocks as
:func:`_blocks_per_call` allows, so the host issues each call's work once
for them all.  Otherwise the block goes through the plain Gram and
``diag_quad_sym`` under ``torch.utils.checkpoint``, which recomputes the
block's (M, B) Gram in the backward instead of keeping it (the port of
``jax.checkpoint``); there S and the Gram are stored in bf16 under
``config.compute_dtype`` as in the minibatch ELBO.  The epilogue's blocks
are f32 whatever the setting: the JAX package's epilogue stores bf16 only
under its TPU-pass knob ``matmul_precision``, which the port does not
have.
:func:`dp_streaming_elbo` splits the points over the ranks of a data mesh.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..config import kernel_device
from ..core import linalg
from ..core.kernels import as_points
from ..core.quadrature import DefaultExpectationMethod, expected_loglikelihood
from ..ops.svgp_epilogue import epilogue_bwd_scratch
from ..parallel import _comm
from ..parallel.data_parallel import shard_batch
from ..utils.profiling import named_scope
from .svgp import (
    Centered,
    SparseVariationalApproximation,
    _epilogue_mu_var,
    _epilogue_operands,
    _matvec_f32,
    _quad_corr,
    prior_kl,
)

__all__ = ["streaming_elbo", "streaming_data_term", "dp_streaming_elbo"]


def _pad_leading(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the leading axis with copies of the first row (safe kernel
    inputs; padded rows are masked out of every reduction)."""
    if pad == 0:
        return a
    return torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])


def _blocks_fitting(n_blocks: int, block_size: int, budget: int,
                    scratch: Callable[[int], int]) -> int:
    """The most consecutive blocks, at least 1 and at most ``n_blocks``, such
    that ``scratch(j·block_size) <= budget`` for every j up to it (a group
    of fewer blocks, the tail's, fits too)."""
    k = 1
    while k < n_blocks and scratch((k + 1) * block_size) <= budget:
        k += 1
    return k


@functools.lru_cache(maxsize=64)
def _fused_blocks_per_call(n_blocks: int, block_size: int, M: int, D: int,
                           dtype: torch.dtype, device: torch.device) -> int:
    return _blocks_fitting(n_blocks, block_size, M * block_size,
                           lambda b: epilogue_bwd_scratch(b, M, D, dtype, device))


def _blocks_per_call(operands, like: torch.Tensor, n_blocks: int, block_size: int, M: int,
                     D: int) -> int:
    """Blocks of ``block_size`` points a data-term call takes.  On the
    kernel device through the fused epilogue: as many as keep the
    pullback's scratch within the (M, block_size) Gram that the plain route
    forms a block, in the call's dtype.  Elsewhere 1: the checkpointed plain
    route forms that Gram, and the epilogue's CPU version forms K0 in
    full."""
    if operands is None or not kernel_device(like):
        return 1
    return _fused_blocks_per_call(n_blocks, block_size, M, D, like.dtype, like.device)


def streaming_data_term(sva: SparseVariationalApproximation, lik, x: torch.Tensor,
                        y: torch.Tensor, block_size: int = 8192, quadrature=None,
                        remat: bool = True, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Σᵢ E_{q(fᵢ)}[log p(yᵢ|fᵢ)] summed in blocks of ``block_size``: the data
    term alone (no ``num_data`` scale, no KL).

    N need not be a multiple of ``block_size``: the tail block is padded
    with copies of the first point and masked out of the sum.  ``mask``
    (optional, (N,), 0/1 or bool) weights the points further.

    ``block_size`` bounds the memory a call takes to O(M·block_size): on
    the checkpointed plain route a call is one block and its (M, B) Gram;
    through the fused epilogue on the card a call takes consecutive blocks
    while the pullback's scratch stays within that Gram's size
    (:func:`_blocks_per_call`).  Under a profiler session each call is a
    ``streaming.chunk`` span."""
    if quadrature is None:
        quadrature = DefaultExpectationMethod()
    fz = sva.fz
    prior = fz.f
    m = sva.q.mean
    Kuu_L, Lk_inv = linalg.chol_with_inv(fz.cov())
    if isinstance(sva.parametrization, Centered):
        B = Lk_inv @ sva.q.scale_tril
        alpha = Lk_inv.T @ (Lk_inv @ (m - fz.mean()))
    else:
        alpha = Lk_inv.T @ m
        B = sva.q.scale_tril
    # one (M, B) product a block for the variances, S formed once; exactly
    # symmetric, since the epilogue kernel reads only its upper triangle
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    S_corr = linalg.symmetrize(Lk_inv.T @ ((B @ B.T - eye) @ Lk_inv))

    x = as_points(x)
    n = y.shape[0]
    block_size = min(block_size, n)
    pad = (-n) % block_size
    w = torch.ones((n,), dtype=m.dtype, device=y.device) if mask is None else \
        torch.as_tensor(mask, dtype=m.dtype, device=y.device)
    if pad:
        x = _pad_leading(x, pad)
        y = _pad_leading(y, pad)
        w = torch.cat([w, torch.zeros((pad,), dtype=w.dtype, device=w.device)])
    z = fz.x

    # the fused epilogue where it serves: its residuals are the block's
    # inputs, so the block needs no checkpoint
    operands = _epilogue_operands(prior, z, alpha, S_corr, prefer=remat)

    def block_ell(xi, yi, wi, alpha, S_corr):
        if operands is not None:
            mu, var = _epilogue_mu_var(prior, xi, operands)
        else:
            Kuf = prior.cov(z, xi)  # (M, B) Gram
            mu = prior.mean(xi) + _matvec_f32(Kuf.T, alpha)
            var = (prior.var(xi) + _quad_corr(S_corr, Kuf)).to(Kuf.dtype)
        ell = expected_loglikelihood(quadrature, lik, mu, var, yi)
        return torch.sum(ell * wi)

    n_blocks = (n + pad) // block_size
    step = block_size * _blocks_per_call(operands, S_corr, n_blocks, block_size, m.shape[-1],
                                         x.shape[1])
    total = torch.zeros((), dtype=m.dtype, device=y.device)
    for start in range(0, n + pad, step):
        args = (x[start:start + step], y[start:start + step], w[start:start + step], alpha,
                S_corr)
        with named_scope("streaming.chunk"):
            if remat and operands is None:
                total = total + checkpoint(block_ell, *args, use_reentrant=False)
            else:
                total = total + block_ell(*args)
    return total


def streaming_elbo(sva: SparseVariationalApproximation, lik, x: torch.Tensor, y: torch.Tensor,
                   block_size: int = 8192, num_data: int | None = None, quadrature=None,
                   remat: bool = True) -> torch.Tensor:
    """ELBO over the full data set, summed in blocks of ``block_size``: the
    same value as ``elbo(sva, lfx, y, num_data=...)`` with O(M·block)
    memory instead of O(M·N) (how a call reads ``block_size``:
    :func:`streaming_data_term`)."""
    total_ell = streaming_data_term(sva, lik, x, y, block_size=block_size,
                                    quadrature=quadrature, remat=remat)
    n = y.shape[0]
    scale = 1.0 if num_data is None else num_data / n
    return total_ell * scale - prior_kl(sva)


def dp_streaming_elbo(sva: SparseVariationalApproximation, lik, x: torch.Tensor,
                      y: torch.Tensor, mesh, block_size: int = 8192,
                      num_data: int | None = None, quadrature=None,
                      remat: bool = True) -> torch.Tensor:
    """:func:`streaming_elbo` with the points split over the ranks of
    ``mesh`` (a :class:`~approximategps_tpu_torch.parallel.DataMesh`): each
    rank streams its share of (x, y), the same on every rank, the shares'
    data terms are summed over the ranks and the KL is subtracted once.
    Differentiable: every rank gets the same gradient, the data term's
    summed over the ranks once.

    N need not divide the mesh size: the points are padded to a multiple
    of it with copies of the first point, which the mask takes out of the
    sum."""
    n = y.shape[0]
    pad = (-n) % mesh.size
    w = torch.ones((n,), dtype=sva.q.mean.dtype, device=y.device)
    x = as_points(x)
    if pad:
        x = _pad_leading(x, pad)
        y = _pad_leading(y, pad)
        w = torch.cat([w, torch.zeros((pad,), dtype=w.dtype, device=w.device)])
    sl = shard_batch(mesh, n)
    # the data term is this rank's share: its inputs' gradients are summed
    # over the ranks; the KL below is computed once on every rank
    ell = streaming_data_term(
        _comm.replicate_tree(mesh, sva), _comm.replicate_tree(mesh, lik),
        _comm.replicate(mesh, x)[sl], _comm.replicate(mesh, y)[sl],
        block_size=min(block_size, sl.stop - sl.start), quadrature=quadrature, remat=remat,
        mask=w[sl])
    total_ell = _comm.sum_over_ranks(mesh, ell)
    scale = 1.0 if num_data is None else num_data / n
    return total_ell * scale - prior_kl(sva)
