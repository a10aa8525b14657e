"""Minibatch data loading (port of ``approximategps_tpu/utils/data.py``):
batches are cut on the device from device-resident tensors with a
permutation drawn each epoch from a ``torch.Generator``, with no copy
through the host."""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

__all__ = ["minibatch_iterator", "epoch_batches"]


def _permutation(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """A permutation of n from ``generator`` (drawn on its own device),
    on ``device``."""
    return torch.randperm(n, generator=generator, device=generator.device).to(device)


def minibatch_iterator(
    generator: torch.Generator,
    arrays: Sequence[torch.Tensor],
    batch_size: int,
    epochs: int | None = None,
    shuffle: bool = True,
    drop_remainder: bool = True,
) -> Iterator[tuple[torch.Tensor, ...]]:
    """Yield tuples of aligned minibatches, reshuffled every epoch from
    ``generator`` (put it on the data's device).  ``epochs=None`` iterates
    forever (use with ``itertools.islice`` or a step-counted loop)."""
    n = arrays[0].shape[0]
    if not drop_remainder and n % batch_size != 0:
        raise ValueError("non-multiple batch sizes require drop_remainder=True")
    device = arrays[0].device
    n_batches = n // batch_size
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = _permutation(generator, n, device) if shuffle else torch.arange(n, device=device)
        for b in range(n_batches):
            idx = perm[b * batch_size:(b + 1) * batch_size]
            yield tuple(a[idx] for a in arrays)
        epoch += 1


def epoch_batches(generator: torch.Generator, n: int, batch_size: int,
                  device=None) -> torch.Tensor:
    """A (n_batches, batch_size) permutation index tensor for one epoch, on
    ``device`` (the generator's by default)."""
    perm = _permutation(generator, n, generator.device if device is None else device)
    n_batches = n // batch_size
    return perm[:n_batches * batch_size].reshape(n_batches, batch_size)
