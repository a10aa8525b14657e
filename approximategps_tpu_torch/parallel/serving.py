"""Posterior serving split over the ranks of a data mesh (port of
``approximategps_tpu/parallel/serving.py``).

The posterior's cache (M-sized arrays) is on every rank; the test points
are padded to a multiple of the mesh size and split evenly, and each rank
sweeps its share through ``predict_blocks`` (for an SVGP posterior, the
fused epilogue kernel a block on the card).  The ranks' shares are then
gathered, so that every rank returns the whole (mean, var), as the JAX
call returns global arrays.
"""

from __future__ import annotations

import torch

from ..core.kernels import as_points
from ._comm import gather_rows
from .data_parallel import shard_batch

__all__ = ["dp_predict_blocks"]


def dp_predict_blocks(f_post, xs, mesh, block_size: int = 16384):
    """(mean, var) of ``f_post`` at ``xs`` over the ranks of ``mesh``.

    ``f_post`` is any posterior with ``predict_blocks`` (the blocked sweep)
    or, failing that, ``mean_and_var``; it must be the same on every rank
    (built from replicated parameters).  ``xs`` is padded with copies of its
    first point to a multiple of the mesh size (the padded rows are computed
    and dropped); each rank sweeps its ceil(n / size) points in blocks of at
    most ``block_size``."""
    X = as_points(xs).to(mesh.device)
    n = X.shape[0]
    pad = (-n) % mesh.size
    if pad:
        X = torch.cat([X, X[:1].expand(pad, X.shape[1])])
    sl = shard_batch(mesh, n)
    x_loc = X[sl]
    if hasattr(f_post, "predict_blocks"):
        mu, var = f_post.predict_blocks(x_loc, block_size=min(block_size, x_loc.shape[0]))
    else:
        mu, var = f_post.mean_and_var(x_loc)
    return gather_rows(mesh, mu)[:n], gather_rows(mesh, var)[:n]
