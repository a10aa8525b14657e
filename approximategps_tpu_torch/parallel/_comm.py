"""Collectives that autograd takes through without a world-size factor.

Every rank of a :class:`~approximategps_tpu_torch.parallel.DataMesh` holds
the same replicated values and computes its own share of the work on them.
``torch.distributed.nn.functional``'s collectives sum the cotangents over
the ranks in their backward, which here would count a replicated loss once
a rank.  These are the conjugate pairs instead:

- :func:`replicate`: identity forward, all-reduce-sum backward.  Applied to
  every floating leaf that enters a rank's share of the work, so that each
  leaf's gradient is the sum of the ranks' shares.
- :func:`sum_over_ranks`: all-reduce-sum forward, identity backward, for
  the ranks' partial sums.
- :func:`gather_rows`: all-gather of equal row bands forward; the backward
  returns this rank's slice of the replicated cotangent, unreduced.

What is computed once on replicated values (a KL term, a noise term) takes
none of them.  A replicated result is built by all-gather (a copy), so it is
bitwise equal on every rank, and every rank takes the same branch on it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["replicate", "replicate_tree", "sum_over_ranks", "gather_rows", "broadcast",
           "map_tensors"]


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        return None, g


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh, ctx.rows = mesh, t.shape[0]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.rank * ctx.rows
        return None, g[r0:r0 + ctx.rows]


def replicate(mesh, t):
    """``t`` itself in value; its gradient summed over the ranks."""
    if not (isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
            and torch.is_grad_enabled()):
        return t
    return _Replicate.apply(mesh, t)


def sum_over_ranks(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, the same on every rank; each rank's
    ``t`` gets the cotangent unchanged."""
    return _SumOverRanks.apply(mesh, t)


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' row bands ``t`` (each of the same shape) stacked in rank
    order; the backward hands each rank its band's rows of the cotangent."""
    return _GatherRows.apply(mesh, t)


def map_tensors(fn, obj):
    """``obj`` with ``fn`` applied to each tensor in it: through dicts,
    lists, tuples (named too) and dataclasses (their init fields)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return type(obj)((k, map_tensors(fn, v)) for k, v in obj.items())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def replicate_tree(mesh, obj):
    """:func:`replicate` on each floating tensor of ``obj`` that carries a
    gradient; ``obj`` itself when autograd records nothing."""
    if not torch.is_grad_enabled():
        return obj
    return map_tensors(lambda t: replicate(mesh, t), obj)


def broadcast(mesh, t: torch.Tensor) -> torch.Tensor:
    """A copy of rank 0's ``t`` on ``mesh.device`` (no gradient)."""
    out = t.detach().to(mesh.device).contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return out
