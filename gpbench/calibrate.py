#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process on the card (the benchmark's own runs do not run this):

    python3 gpbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults 1,2,3] [--twin 1] [--seconds S] [--out FILE]

For each of ``--seeds``: the cell's set-up (and, for a cell of answers, a
window of ``--seconds``) through the program, then the plain reference in
float64 on the same inputs, and the numbers the run would compare (the
lower readings).  For each of ``--control``: the reference in the step
below the configuration's precision (float32, products in TF32) put in the
program's place (the control's readings).  For each of ``--faults``: the
program again with each fault of the cell's kind planted underneath
(``FAULTS``), against the same float64 reference.  For each of ``--twin``:
the reference in the configuration's own float32 (no TF32) in the
program's place, to tell a gap that float32 arithmetic gives the
algorithm itself from one of the program's.  Prints one JSON line a
reading and writes all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import approximategps_tpu_torch as tgp  # noqa: E402
from approximategps_tpu_torch.models import svgp  # noqa: E402
from gpbench.harness import judge, spec  # noqa: E402


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


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


FAULTS = {
    "svgp_train": {"unchanged": unchanged, "half_minibatch": half_minibatch,
                   "half_fullbatch": half_fullbatch},
    "svgp_predict": {"altered_answer": altered_answer},
}


def faults_for(mix: dict) -> dict:
    found = dict(FAULTS[mix["loop"]])
    if mix["loop"] == "svgp_train":
        found.pop("half_minibatch" if mix["batch"] == "all" else "half_fullbatch")
    return found


def program_run(loop, cfg, mix, seed, dev, seconds):
    """(inputs, outputs) of one run of the program's path: set-up, and a
    window where the cell's results come out of it."""
    run = loop.Run(cfg, mix, seed, dev)
    if mix["loop"] == "svgp_predict":
        run.window(time.perf_counter() + seconds)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    inputs, outputs = run.inputs(), run.outputs()
    run.free()
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return inputs, outputs


def as_outputs(mix: dict, r: dict) -> dict:
    return r if mix["loop"] != "svgp_predict" else {"mu": r["mu"], "var": r["var"]}


def numbers(mix, outputs, truth) -> dict:
    """The run's numbers; for training also each leaf's gaps, for the look
    at a seed that reads far from the others."""
    if mix["loop"] == "svgp_predict":
        return judge.answer_numbers(outputs["mu"], outputs["var"], truth["mu"], truth["var"],
                                    truth["prior_var"])
    return {**judge.train_numbers(outputs, truth),
            "grad_leaves": judge.leaf_gaps(outputs["grad1"], truth["grad1"], list(truth["grad1"])),
            "step_leaves": judge.leaf_gaps(outputs["delta"], truth["delta"], list(truth["delta"]))}


def calibrate(cell: str, seeds, control, faults, seconds: float, dev, overrides=None,
              emit=print, twin=()) -> list[dict]:
    overrides = overrides or {}
    bspec = spec.load_spec()
    wl = spec.workload(bspec, cell)
    cfg = {**spec.config(bspec, wl["config"]), **overrides.get("config", {})}
    mix = {**spec.traffic(wl["traffic"]), **overrides.get("traffic", {})}
    loop = spec.loop_module(mix["loop"])
    ref = spec.reference_module(cfg["model"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []

    def record(kind, seed, nums):
        row = {"cell": cell, "kind": kind, "seed": seed, **nums}
        readings.append(row)
        emit(json.dumps(row))

    for seed in sorted(set(seeds) | set(control) | set(faults) | set(twin)):
        inputs, outputs = program_run(loop, cfg, mix, seed, dev, seconds)
        truth = loop.reference(ref, cfg, mix, inputs, ref.TRUTH)
        if seed in seeds:
            nums = numbers(mix, outputs, truth)
            record("sound", seed, nums)
        if seed in control:
            low = loop.reference(ref, cfg, mix, inputs, ref.CONTROL)
            record("control", seed, numbers(mix, as_outputs(mix, low), truth))
        if seed in twin:
            same = loop.reference(ref, cfg, mix, inputs, ref.Arith(torch.float32, False))
            record("twin:f32", seed, numbers(mix, as_outputs(mix, same), truth))
        del outputs
        if seed in faults:
            for name, fault in faults_for(mix).items():
                with fault():
                    broken_inputs, broken = program_run(loop, cfg, mix, seed, dev, seconds)
                if mix["loop"] == "svgp_predict":
                    # a window serves other requests each time: judge them by their own truth
                    truth = loop.reference(ref, cfg, mix, broken_inputs, ref.TRUTH)
                record(f"fault:{name}", seed, numbers(mix, broken, truth))
    return readings


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--twin", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings = calibrate(args.workload, ints(args.seeds), ints(args.control), ints(args.faults),
                         args.seconds, torch.device("cuda:0"), twin=ints(args.twin))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in readings))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
