"""Calibration of the ``svgp_predict`` loop: one answer altered where it is
produced."""

from __future__ import annotations

from approximategps_tpu_torch.models import svgp
from gpbench.calibration import patched
from gpbench.harness import judge

WINDOW = True


def altered_answer():
    """One answer altered where it is produced: the first point of every
    request gets the prior's mean and variance."""
    predict = svgp.SVGPPosterior.predict_blocks

    def broken(self, xs, block_size=16384):
        mu, var = predict(self, xs, block_size=block_size)
        mu, var = mu.clone(), var.clone()
        mu[0] = 0.0
        var[0] = self.prior.var(xs[:1])[0]
        return mu, var

    return patched(svgp.SVGPPosterior, "predict_blocks", broken)


def faults(mix: dict) -> dict:
    return {"altered_answer": altered_answer}


def as_outputs(result: dict) -> dict:
    return {"mu": result["mu"], "var": result["var"]}


def numbers(outputs: dict, truth: dict) -> dict:
    return judge.answer_numbers(outputs["mu"], outputs["var"], truth["mu"], truth["var"],
                                truth["prior_var"])
