"""Checkpoint and resume for trees of tensors (port of
``approximategps_tpu/utils/checkpoint.py``): hyperparameters, q's m and L,
optimizer state, a Newton-mode cache.

The JAX package's directory layout: one file a step,
``ckpt_dir/ckpt_<step, 9 digits>``, written to a ``.tmp`` name and then
moved into place, the newest step found by listing the directory.  The
bytes are ``torch.save``'s (so the suffix is ``.pt``, not ``.msgpack``):
the tree's leaves in order, on the host; ``restore_checkpoint`` loads them
with ``weights_only=True`` and puts them back into the structure of a
template tree, each on its template leaf's device and in its dtype.  A tree
is tensors, numbers and numpy arrays in dicts, lists, tuples and named
tuples.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Any

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "AsyncCheckpointer",
]

_PREFIX, _SUFFIX = "ckpt_", ".pt"


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{_PREFIX}{step:09d}{_SUFFIX}")


def _leaves(tree) -> list:
    """The tree's leaves in order: dict values by sorted key, then lists and
    tuples (named tuples too) by position."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with the next leaves of the iterator
    ``leaves`` in its places, each tensor on its template leaf's device
    and in its dtype."""
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return type(template)((k, vals[k]) for k in template)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    leaf = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(leaf).to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return torch.as_tensor(leaf).numpy().astype(template.dtype)
    return leaf


def _to_host(leaf):
    """A leaf as ``torch.save`` keeps it with ``weights_only`` loading: a
    tensor copied to the host (numpy arrays become tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf))
    return leaf


def _write(ckpt_dir: str, host_leaves: list, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save({"leaves": host_leaves}, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, target: Any, step: int) -> str:
    """Write the tree ``target`` to ``ckpt_dir/ckpt_<step>.pt``; returns the
    path."""
    return _write(ckpt_dir, [_to_host(leaf) for leaf in _leaves(target)], step)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[len(_PREFIX):-len(_SUFFIX)]) for name in os.listdir(ckpt_dir)
             if name.startswith(_PREFIX) and name.endswith(_SUFFIX)]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any, step: int | None = None) -> Any:
    """Restore a tree saved by :func:`save_checkpoint` (the newest step by
    default) into the structure of ``target`` (e.g. freshly initialised
    parameters)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    saved = torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)["leaves"]
    n = len(_leaves(target))
    if len(saved) != n:
        raise ValueError(f"checkpoint has {len(saved)} leaves, the target {n}")
    return _unflatten(target, iter(saved))


class AsyncCheckpointer:
    """Asynchronous checkpointing: ``save()`` copies the tree's tensors to
    the host on the caller's thread (tensors are mutable, so the training
    loop may change them as soon as ``save`` returns) and hands the copy to
    a background thread that writes it, so the disk write overlaps
    training.  The format is :func:`save_checkpoint`'s (restore with
    :func:`restore_checkpoint`).

    At most ``max_pending`` saves are in flight; one more blocks until a
    slot frees.  ``wait()`` makes every write durable; the context-manager
    form does so on exit."""

    def __init__(self, ckpt_dir: str, max_pending: int = 1):
        self.ckpt_dir = ckpt_dir
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []
        self._max_pending = max(1, int(max_pending))

    def _drain(self, keep: int):
        while len(self._pending) > keep:
            self._pending.pop(0).result()  # re-raises the writer's exception

    def save(self, target: Any, step: int):
        """Schedule a checkpoint of ``target`` at ``step``."""
        self._drain(self._max_pending - 1)
        host_leaves = [_to_host(leaf) for leaf in _leaves(target)]
        fut = self._pool.submit(_write, self.ckpt_dir, host_leaves, step)
        self._pending.append(fut)
        return fut

    def wait(self):
        """Block until every scheduled checkpoint is on disk."""
        self._drain(0)

    def close(self):
        self.wait()
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
