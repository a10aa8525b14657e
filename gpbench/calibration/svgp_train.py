"""Calibration of the ``svgp_train`` loop: a step that returns its state
unchanged, and half of the batch left out (of the minibatch, or with
``batch`` "all" of the full-data ELBO)."""

from __future__ import annotations

import torch

import approximategps_tpu_torch as tgp
from gpbench.calibration import patched
from gpbench.harness import judge

WINDOW = False


def unchanged():
    """A step that returns its state unchanged: Adam computes its update and
    its moments, and the leaves are put back as they were."""
    step = torch.optim.Adam.step

    def broken(self, closure=None):
        leaves = [p for group in self.param_groups for p in group["params"]]
        kept = [p.detach().clone() for p in leaves]
        out = step(self, closure)
        with torch.no_grad():
            for p, k in zip(leaves, kept):
                p.copy_(k)
        return out

    return patched(torch.optim.Adam, "step", broken)


def half_minibatch():
    """Half of the minibatch left out, the mean taken over the rest."""
    elbo = tgp.elbo

    def broken(sva, lfx, y, num_data=None, quadrature=None):
        h = y.shape[0] // 2
        return elbo(sva, lfx.f(lfx.x[:h], lfx.noise), y[:h], num_data=num_data,
                    quadrature=quadrature)

    return patched(tgp, "elbo", broken)


def half_fullbatch():
    """Half of the data left out of the full-data ELBO, the mean taken over
    the rest."""
    streaming = tgp.streaming_elbo

    def broken(sva, lik, x, y, block_size=8192, num_data=None, quadrature=None, remat=True):
        h = y.shape[0] // 2
        return streaming(sva, lik, x[:h], y[:h], block_size=block_size,
                         num_data=y.shape[0] if num_data is None else num_data,
                         quadrature=quadrature, remat=remat)

    return patched(tgp, "streaming_elbo", broken)


def faults(mix: dict) -> dict:
    half = half_fullbatch if mix["batch"] == "all" else half_minibatch
    return {"unchanged": unchanged, half.__name__: half}


def as_outputs(result: dict) -> dict:
    return result


def numbers(outputs: dict, truth: dict) -> dict:
    """The run's numbers, and each leaf's gaps for the look at a seed that
    reads far from the others."""
    return {**judge.train_numbers(outputs, truth),
            "grad_leaves": judge.leaf_gaps(outputs["grad1"], truth["grad1"], list(truth["grad1"])),
            "step_leaves": judge.leaf_gaps(outputs["delta"], truth["delta"], list(truth["delta"]))}
