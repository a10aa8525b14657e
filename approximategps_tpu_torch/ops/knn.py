"""Blocked k-nearest-neighbour search on the device (port of
``approximategps_tpu/ops/knn.py::knn_search``).

Plain PyTorch, not a kernel: the JAX package runs it through XLA.  The
Vecchia serving path (``models.vecchia.predict_knn``) needs, for each test
point, its k nearest training points.  Two tiers:

- **Blocked scan** (any dimension): (test tile, training tile) squared
  distances (``core.kernels.pairwise_sq_dist``: the |x|²-identity on large
  tiles, exact differences on small ones), a per-tile top-k by exact
  segmented pruning, merged into a running best-k.  Peak memory is one
  (test_block, train_block) tile.
- **Grid buckets** (D ≤ 3): training points sorted into a G^D grid, each test
  point gathers the 3^D neighbouring cells (contiguous ranges of the sorted
  order), with the static G, row count ``nblk`` and capacity of the JAX
  package, so that both packages gather the same candidates and certify the
  same tiles.  A tile is certified when every point's k-th distance is within
  the one-ring guarantee radius and no range overflowed its capacity; a tile
  that is not falls back to the scan.  Eager PyTorch decides that on the
  host: one sync a test tile, counted in ``stats``.

Indices are int64.
"""

from __future__ import annotations

import itertools
import math
import warnings

import torch

from ..core.kernels import as_points, pairwise_sq_dist

__all__ = ["knn_search", "stats", "reset_stats"]

_SEG = 64  # segment length of the scan's pruned top-k
_LANE = 128  # width of the JAX package's gathered rows; sets nblk and capacity

# what the searches of a run did: test tiles, host syncs of the grid tier's
# certificate, and tiles that fell back to the scan
stats = {"tiles": 0, "host_syncs": 0, "fallbacks": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _tile_topk(d2: torch.Tensor, k: int):
    """(values, tile-local indices) of the k smallest entries of each row.

    Exact segmented pruning: the k segments with the smallest minimum
    contain every one of the k smallest entries (an entry's segment minimum
    is at most the entry, which is at most the k-th smallest value), so the
    top-k runs over k·64 gathered candidates instead of the tile's width.
    Exact up to ties at a segment boundary."""
    rows, tb = d2.shape
    if tb % _SEG or tb < 4 * k * _SEG:
        return torch.topk(d2, k, dim=1, largest=False)
    d2r = d2.reshape(rows, tb // _SEG, _SEG)
    _, sidx = torch.topk(d2r.amin(dim=2), k, dim=1, largest=False)
    cand = torch.gather(d2r, 1, sidx[:, :, None].expand(rows, k, _SEG))
    vals, jloc = torch.topk(cand.reshape(rows, k * _SEG), k, dim=1, largest=False)
    j = torch.gather(sidx, 1, torch.div(jloc, _SEG, rounding_mode="floor")) * _SEG + jloc % _SEG
    return vals, j


def _scan_tile(Q: torch.Tensor, Xa: torch.Tensor, k: int, train_block: int):
    """The blocked scan for one test tile Q: (idx, d2), ascending."""
    best_d2 = best_idx = None
    for base in range(0, Xa.shape[0], train_block):
        Xt = Xa[base:base + train_block]
        vals, j = _tile_topk(pairwise_sq_dist(Q, Xt), min(k, Xt.shape[0]))
        j = j + base
        if best_d2 is None:
            cand_d2, cand_idx = vals, j
        else:
            cand_d2 = torch.cat([best_d2, vals], dim=1)
            cand_idx = torch.cat([best_idx, j], dim=1)
        best_d2, pos = torch.topk(cand_d2, min(k, cand_d2.shape[1]), dim=1, largest=False)
        best_idx = torch.gather(cand_idx, 1, pos)
    return best_idx, best_d2


def knn_search(Xtrain, Xtest, k: int, train_block: int = 65536, test_block: int = 4096,
               mode: str = "auto"):
    """Indices (int64) and squared distances of the k nearest training points
    of each test point, (N*, k) each, ascending by distance.

    ``mode``: "scan" forces the blocked sweep, "grid" the bucketed spatial
    tier (D ≤ 3; uncertified tiles still fall back to the scan), "auto"
    takes the grid for spatial problems large enough that the O(N) sweep per
    point dominates (D ≤ 3, N ≥ 2¹⁷ and N ≥ 32k).  Exact up to distance
    ties."""
    Xa = as_points(Xtrain)
    Xb = as_points(Xtest)
    n, d = Xa.shape
    m = Xb.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} training points")
    if mode not in ("auto", "grid", "scan"):
        raise ValueError(f"unknown knn mode: {mode!r}")
    if mode == "grid" and d > 3:
        raise ValueError(f"knn mode='grid' supports spatial inputs with d <= 3, got d={d}")
    use_grid = mode == "grid" or (mode == "auto" and d <= 3 and n >= (1 << 17) and n >= 32 * k)
    grid_tile = None
    if use_grid:
        grid_tile = _make_grid_tile(Xa, k)
        if grid_tile is None and mode == "grid":
            warnings.warn(
                "knn mode='grid' was forced but no useful grid exists for this problem "
                f"(n={n}, d={d}, k={k}); falling back to the blocked scan",
                RuntimeWarning, stacklevel=2)

    sb = min(test_block, m)
    idx_parts, d2_parts = [], []
    for i0 in range(0, m, sb):
        Q = Xb[i0:i0 + sb]
        rows = Q.shape[0]
        if rows < sb:
            # pad with copies of a real test point, as the JAX package does, so
            # that the padding never fails the certificate on its own
            Q = torch.cat([Q, Xb[:1].expand(sb - rows, d)])
        stats["tiles"] += 1
        res = None
        if grid_tile is not None:
            idx_g, d2_g, certified = grid_tile(Q)
            stats["host_syncs"] += 1
            if bool(certified):
                res = (idx_g, d2_g)
            else:
                stats["fallbacks"] += 1
        if res is None:
            res = _scan_tile(Q, Xa, k, train_block)
        idx_parts.append(res[0][:rows])
        d2_parts.append(res[1][:rows])
    if not idx_parts:
        return (torch.empty((0, k), dtype=torch.int64, device=Xa.device),
                Xa.new_empty((0, k)))
    return torch.cat(idx_parts), torch.cat(d2_parts)


def _make_grid_tile(Xa: torch.Tensor, k: int):
    """The bucketed-grid search of one test tile, or None where no useful
    grid exists.  The closure maps a (sb, d) tile to ``(idx, d2,
    certified)``, ``certified`` a 0-dim bool tensor on the device.

    G cells a dimension (from n and a target occupancy of max(2k, 64)
    points), cell extents h_j = span_j / G; points sorted by cell id with the
    last dimension the minor key, so the three cells along it in any of the
    3^(d−1) neighbouring rows are one contiguous range [s, e) of the sorted
    order.  Each range is read as ``nblk`` 128-wide rows of that order: the
    JAX package's layout, kept so that the candidate set (and so the
    certificate) is the same.  Exact when d_k ≤ min_j h_j (every cell not
    searched differs by at least 2 indices in some dimension) and no range
    ran past its rows."""
    n, d = Xa.shape
    occupancy = max(2 * k, 64)
    G = max(int(round((n / occupancy) ** (1.0 / d))), 1)
    if G < 4:
        return None
    ncells = G ** d
    nblk = math.ceil(2 * 3 * (n / ncells) / _LANE) + 1
    n_rows = 3 ** (d - 1)
    C = n_rows * nblk * _LANE  # candidate slots a test point
    if C >= n or C < k:
        return None

    dtype, dev = Xa.dtype, Xa.device
    big = torch.finfo(dtype).max
    lo = Xa.amin(dim=0)
    hi = Xa.amax(dim=0)
    spread = hi > lo
    # a constant coordinate gets unit extent: every point in cell 0 there
    h = torch.where(spread, hi - lo, torch.ones_like(lo)) / G

    def cells(P):  # (rows, d) → (rows, d) int64 cell indices, clipped
        return torch.clamp(torch.floor((P - lo) / h).to(torch.int64), 0, G - 1)

    weights = torch.tensor([G ** (d - 1 - j) for j in range(d)], dtype=torch.int64, device=dev)
    cid = (cells(Xa) * weights).sum(dim=1)
    order = torch.argsort(cid)
    starts = torch.searchsorted(cid[order], torch.arange(ncells + 1, dtype=torch.int64, device=dev))
    n128 = -(-n // _LANE) * _LANE
    nrb = n128 // _LANE
    sorted_pts = torch.cat([Xa[order], torch.full((n128 - n, d), big, dtype=dtype, device=dev)])
    order_pad = torch.cat([order, torch.zeros(n128 - n, dtype=torch.int64, device=dev)])
    # squared guarantee radius over the dimensions that vary (a constant one
    # never separates cells); all constant: every point coincides
    guard2 = torch.where(spread, h, torch.full_like(h, math.inf)).amin() ** 2
    offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=d - 1)),
                           dtype=torch.int64, device=dev).reshape(n_rows, d - 1)
    lane = torch.arange(nblk * _LANE, dtype=torch.int64, device=dev)

    def grid_tile(Q):
        sb = Q.shape[0]
        tc = cells(Q)  # (sb, d)
        x0 = torch.clamp(tc[:, d - 1] - 1, min=0)
        x1 = torch.clamp(tc[:, d - 1] + 1, max=G - 1)
        coord = tc[:, None, :d - 1] + offsets[None]  # (sb, n_rows, d-1)
        ok = ((coord >= 0) & (coord < G)).all(dim=2)
        base = (torch.clamp(coord, 0, G - 1) * weights[None, None, :d - 1]).sum(dim=2)
        s = starts[base + x0[:, None]]  # (sb, n_rows): window [s, e) of the order
        e = starts[base + x1[:, None] + 1]
        first = torch.div(s, _LANE, rounding_mode="floor") * _LANE
        pos = first[:, :, None] + lane  # (sb, n_rows, nblk·128) sorted positions
        valid = (pos >= s[:, :, None]) & (pos < e[:, :, None]) & ok[:, :, None]
        pos = pos.reshape(sb, C)
        cand = sorted_pts[torch.clamp(pos, max=n128 - 1)]  # (sb, C, d)
        diff = cand - Q[:, None, :]
        d2 = torch.where(valid.reshape(sb, C), torch.sum(diff * diff, dim=2),
                         torch.full((), big, dtype=dtype, device=dev))
        d2k, jj = torch.topk(d2, k, dim=1, largest=False)
        flat = torch.gather(pos, 1, jj)
        idx = order_pad[torch.clamp(flat, max=n128 - 1)]
        # a range overflows when [s, e) runs past its nblk gathered rows
        overflow = (ok & (e > first + nblk * _LANE)).any(dim=1)
        certified = ((d2k[:, k - 1] <= guard2) & ~overflow).all()
        return idx, d2k, certified

    return grid_tile
