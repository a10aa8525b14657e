"""The numbers that decide ``correct``: each the gap between what the timed
path produced and what the plain reference works out from the same inputs,
held against the cell's limits (``limits/<cell>.json``).

Training (the first three steps that set-up drove through the window's own
call): ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, by the worst leaf, the gap between the norms of the first
gradient as the optimizer got it (Adam's first moment after step 1 over
1 − β₁) and the reference's, over the larger of that leaf's reference norm
and the median leaf's; ``step_gap``, the same gap of the parameters' change
over the three steps, for the median leaf, leaving out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone).  The change is read at the median leaf because the
worst leaf's swings from seed to seed: Adam moves each element by about
its learning rate whatever its gradient's size, so an inducing point's
coordinate whose gradient lies near zero changes sign with rounding by the
second step (PERF.md §2).
Answers (prediction): ``mean_gap`` and ``var_gap``, the widest gap of a
sampled answer's mean over the prior standard deviation and of its
variance over the prior variance."""

from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """leaf → the gap of the norms over the larger of the leaf's reference
    norm and the median leaf's."""
    r = {k: _norm(ref[k]) for k in keep}
    med = statistics.median(r.values())
    return {k: abs(_norm(prog[k]) - r[k]) / max(r[k], med, 1e-300) for k in keep}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the first steps' losses),
    ``grad1`` (leaf → the first gradient) and ``delta`` (leaf → the change
    of the parameters over the compared steps)."""
    loss_gap = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(prog["losses"], ref["losses"], strict=True))
    leaves = list(ref["grad1"])
    gnorm = {k: _norm(ref["grad1"][k]) for k in leaves}
    med = statistics.median(gnorm.values())
    moving = [k for k in leaves if gnorm[k] >= NOUGHT * med]
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(prog["grad1"], ref["grad1"], leaves).values()),
            "step_gap": statistics.median(leaf_gaps(prog["delta"], ref["delta"],
                                                    moving).values())}


def answer_numbers(mu, var, mu_ref, var_ref, prior_var: float) -> dict:
    return {"mean_gap": float((mu.double() - mu_ref.double()).abs().max()) / prior_var ** 0.5,
            "var_gap": float((var.double() - var_ref.double()).abs().max()) / prior_var}


def held(numbers: dict, limits: dict) -> dict:
    """name → [value, limit] for every limit; a number that is missing or
    not finite is None, and fails its limit."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = [value if value is not None and math.isfinite(value) else None, limit]
    return out


def all_within(checks: dict) -> bool:
    return all(value is not None and value <= limit for value, limit in checks.values())
