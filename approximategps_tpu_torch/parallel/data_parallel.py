"""Data-parallel training over ``torch.distributed`` (port of
``approximategps_tpu/parallel/data_parallel.py``).

The ELBO's data term is a sum of independent per-point expectations, so it
splits over the points: every process (rank) holds the parameters, takes
its share of the batch, and the shares' values and gradients are summed
over the ranks.  The JAX package runs one controller over a device mesh
and lets XLA insert the sums; here each rank is its own process with one
device, and the sums are explicit collectives (``parallel/_comm.py``).

A run starts one process a device, e.g. ``torchrun --nproc_per_node=4
train.py``, and each calls :func:`data_mesh`.  Differences from the JAX
package: the ``DataMesh``'s process group takes the place of
``axis_name``; there is no ``donate`` (the optimisers update in place); and
:func:`make_dp_elbo` evaluates the function on each rank's share of the
batch, not on the whole batch (see its contract).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..utils.training import _leaves
from . import _comm

__all__ = [
    "DataMesh",
    "data_mesh",
    "shard_batch",
    "replicated",
    "make_dp_elbo",
    "make_dp_train_step",
]


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """The ranks of a process group along one data axis: this process's
    ``rank`` of ``size``, and the ``device`` its tensors live on."""

    group: Any
    rank: int
    size: int
    device: torch.device


def data_mesh(group=None, device=None) -> DataMesh:
    """The data axis over ``group`` (the default process group when None).

    With no process group yet, one is started from the environment that
    ``torchrun`` sets (NCCL on a CUDA device, gloo on the CPU).  ``device``
    defaults to ``cuda:<LOCAL_RANK>``, which becomes the current device;
    the CPU only when asked (``device="cpu"``, with a gloo group)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device; pass device='cpu' for a gloo world")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "data_mesh: no process group; start the processes with torchrun "
                "(torchrun --nproc_per_node=N script.py) or call "
                "torch.distributed.init_process_group first")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    group = dist.group.WORLD if group is None else group
    return DataMesh(group, dist.get_rank(group), dist.get_world_size(group), device)


def shard_batch(mesh: DataMesh, n: int, pad: bool = True) -> slice:
    """This rank's rows of a leading axis of ``n``.

    ``pad=True``: the axis padded to a multiple of the mesh size and split
    evenly, ceil(n / size) rows a rank (the rows from ``n`` on are the
    caller's padding).  ``pad=False``: ``n`` split as evenly as it goes,
    the first ``n % size`` ranks one row more, nothing padded."""
    if pad:
        rows = -(-n // mesh.size)
        return slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    base, extra = divmod(n, mesh.size)
    start = mesh.rank * base + min(mesh.rank, extra)
    return slice(start, start + base + (mesh.rank < extra))


def replicated(mesh: DataMesh, tree):
    """Rank 0's tensors of ``tree`` (dicts, lists, tuples, dataclasses) on
    every rank, on ``mesh.device``: copies without a gradient."""
    return _comm.map_tensors(lambda t: _comm.broadcast(mesh, t), tree)


def _on_device(mesh: DataMesh, t):
    return t.to(mesh.device) if isinstance(t, torch.Tensor) else t


def make_dp_elbo(elbo_fn: Callable, mesh: DataMesh):
    """``run(params, x, y)``: ``elbo_fn(params, x_batch, y_batch)`` over the
    batch (x, y), the same on every rank, its points split over the ranks.

    Each rank evaluates ``elbo_fn`` on its share of n_r of the n points,
    unpadded, and the result is the count-weighted sum Σ_r (n_r / n)·f_r,
    differentiable in the parameters (and in x and y): each rank's
    gradient is the same, summed over the ranks once.

    Contract: exact for functions of the form a·mean(per-point terms) +
    (terms of the parameters alone), which is every ``elbo(..., num_data=N)``
    (N/B·Σ ell − KL).  ``elbo`` with ``num_data=None`` sums its points
    without the mean, and no combination of the ranks' values gives the
    JAX package's value for it.  Needs n ≥ the mesh size."""

    def run(params, x, y):
        n = y.shape[0]
        if n < mesh.size:
            raise ValueError(f"make_dp_elbo: {n} points for {mesh.size} ranks")
        sl = shard_batch(mesh, n, pad=False)
        p = _comm.replicate_tree(mesh, _comm.map_tensors(lambda t: _on_device(mesh, t), params))
        xr = _comm.replicate(mesh, _on_device(mesh, x))[sl]
        yr = _comm.replicate(mesh, _on_device(mesh, y))[sl]
        f_r = elbo_fn(p, xr, yr)
        return _comm.sum_over_ranks(mesh, f_r * ((sl.stop - sl.start) / n))

    return run


def make_dp_train_step(loss_fn: Callable, optimizer: Callable | None, mesh: DataMesh):
    """``step(params, x, y) -> (params, loss)``: one optimiser step on
    ``loss_fn(params, x_batch, y_batch)`` (e.g. −``elbo``), its value and
    gradient taken as :func:`make_dp_elbo` takes them.

    ``params`` is a dict, a tuple of leaf tensors or an ``SVGPParams``; its
    leaves are updated in place, as ``adam_fit`` updates them.  At the
    first call (and whenever other leaves are passed) they take rank 0's
    values and get their optimiser: ``optimizer(leaves)``, or
    ``torch.optim.Adam(leaves)`` when None; it is ``step.optimizer``.  Every rank applies the same summed gradient, so the
    parameters stay bitwise equal across the ranks."""
    dp_loss = make_dp_elbo(loss_fn, mesh)

    def step(params, x, y):
        leaves = _leaves(params)
        if [id(t) for t in leaves] != step.leaf_ids:
            with torch.no_grad():
                for t in leaves:
                    dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
            for t in leaves:
                t.requires_grad_(True)
            step.optimizer = (optimizer(leaves) if optimizer is not None
                              else torch.optim.Adam(leaves))
            step.leaf_ids = [id(t) for t in leaves]
        step.optimizer.zero_grad(set_to_none=True)
        loss = dp_loss(params, x, y)
        loss.backward()
        step.optimizer.step()
        return params, loss.detach()

    step.leaf_ids, step.optimizer = None, None
    return step
