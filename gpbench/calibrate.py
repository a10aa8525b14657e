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
program again with each fault of the cell's loop planted underneath
(``calibration/<loop>.py``), against the same float64 reference.  For
each of ``--twin``: the reference in the configuration's own float32 (no
TF32) in the program's place, to tell a gap that float32 arithmetic gives
the algorithm itself from one of the program's.  Prints one JSON line a
reading and writes all of them to ``--out``.

Everything that depends on the cell's loop comes from
``calibration/<loop>.py`` (see ``gpbench/calibration/__init__.py``); of
the configuration's reference ``reference/<model>.py`` it takes
``TRUTH``, ``CONTROL`` and ``Arith(dtype, tf32)``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpbench.harness import spec  # noqa: E402

CALIBRATION = ROOT / "gpbench" / "calibration"


def calibration_module(loop: str):
    """``calibration/<loop>.py``: the loop's faults, ``WINDOW``,
    ``as_outputs`` and ``numbers``, found by the loop's name as
    ``spec.loop_module`` finds the loop."""
    if not (CALIBRATION / f"{loop}.py").exists():
        raise FileNotFoundError(f"loop {loop!r} has no calibration: add "
                                f"gpbench/calibration/{loop}.py")
    return importlib.import_module(f"gpbench.calibration.{loop}")


def faults_for(mix: dict) -> dict:
    return calibration_module(mix["loop"]).faults(mix)


def program_run(loop, cal, cfg, mix, seed, dev, seconds):
    """(inputs, outputs) of one run of the program's path: set-up, and a
    window where the loop's outputs come out of one."""
    run = loop.Run(cfg, mix, seed, dev)
    if cal.WINDOW:
        run.window(time.perf_counter() + seconds)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    inputs, outputs = run.inputs(), run.outputs()
    run.free()
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return inputs, outputs


def calibrate(cell: str, seeds, control, faults, seconds: float, dev, overrides=None,
              emit=print, twin=()) -> list[dict]:
    overrides = overrides or {}
    bspec = spec.load_spec()
    wl = spec.workload(bspec, cell)
    cfg = {**spec.config(bspec, wl["config"]), **overrides.get("config", {})}
    mix = {**spec.traffic(wl["traffic"]), **overrides.get("traffic", {})}
    loop = spec.loop_module(mix["loop"])
    cal = calibration_module(mix["loop"])
    ref = spec.reference_module(cfg["model"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []

    def record(kind, seed, nums):
        row = {"cell": cell, "kind": kind, "seed": seed, **nums}
        readings.append(row)
        emit(json.dumps(row))

    for seed in sorted(set(seeds) | set(control) | set(faults) | set(twin)):
        inputs, outputs = program_run(loop, cal, cfg, mix, seed, dev, seconds)
        truth = loop.reference(ref, cfg, mix, inputs, ref.TRUTH)
        if seed in seeds:
            record("sound", seed, cal.numbers(outputs, truth))
        if seed in control:
            low = loop.reference(ref, cfg, mix, inputs, ref.CONTROL)
            record("control", seed, cal.numbers(cal.as_outputs(low), truth))
        if seed in twin:
            same = loop.reference(ref, cfg, mix, inputs, ref.Arith(torch.float32, False))
            record("twin:f32", seed, cal.numbers(cal.as_outputs(same), truth))
        del outputs
        if seed in faults:
            for name, fault in cal.faults(mix).items():
                with fault():
                    broken_inputs, broken = program_run(loop, cal, cfg, mix, seed, dev, seconds)
                if cal.WINDOW:
                    # a window serves other requests each time: judge them by their own truth
                    truth = loop.reference(ref, cfg, mix, broken_inputs, ref.TRUTH)
                record(f"fault:{name}", seed, cal.numbers(broken, truth))
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
