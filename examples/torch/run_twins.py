#!/usr/bin/env python
"""Runs the PyTorch twins of the ten examples, each with its own asserts
live: at ``scripts/run_examples.py``'s reduced sizes (its ``RUNS`` table,
read from that file) or, with ``--full``, at each twin's own default sizes.

    python3 examples/torch/run_twins.py [--full] [--cpu] [a b c ...]

Prints each twin's seconds.  On the card by default; ``--cpu`` runs them on
the CPU.  Exits non-zero if a twin fails."""

import argparse
import ast
import importlib.util
import sys
import time
from pathlib import Path

import _common  # puts the repository root on the import path
import torch


def _run_examples_table() -> dict:
    """``scripts/run_examples.py``'s ``RUNS`` ({name: (module, kwargs)}),
    parsed from its source: running that script would import the JAX
    examples."""
    src = (Path(_common.ROOT) / "scripts" / "run_examples.py").read_text()
    (node,) = [n for n in ast.parse(src).body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "RUNS"]
    return eval(ast.get_source_segment(src, node.value), {"__builtins__": {}, "dict": dict})


# (module, kwargs): the twin of each example and its reduced size
RUNS = _run_examples_table()


def load(name: str):
    """Twin ``name``'s module, loaded from its file under a name of its own
    (the JAX examples' modules have the same names)."""
    mod_name = RUNS[name][0]
    key = f"torch_twin_{mod_name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, Path(__file__).parent / f"{mod_name}.py")
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


def run(name: str, full: bool = False, device=None, sync=None, **cut) -> float:
    """Seconds one twin takes, its asserts live (a failed assert raises),
    at the reduced size (``cut`` smaller still) or its own."""
    mod, kwargs = load(name), RUNS[name][1]
    t0 = time.perf_counter()
    mod.main(**({} if full else {**kwargs, **cut}), device=device)
    if sync is not None:
        sync()
    return time.perf_counter() - t0


def run_on_cpu(name: str, **cut) -> float:
    """:func:`run` on the CPU in one thread, the thread count restored
    after; raises if the twin leaves the port's config changed."""
    from approximategps_tpu_torch.config import config

    threads, before = torch.get_num_threads(), dict(vars(config))
    torch.set_num_threads(1)
    try:
        sec = run(name, device="cpu", **cut)
    finally:
        torch.set_num_threads(threads)
    if dict(vars(config)) != before:
        raise RuntimeError(f"twin {name} left the port's config changed")
    return sec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(RUNS))
    ap.add_argument("--full", action="store_true", help="each twin's own default sizes")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    failed = []
    for name in args.names:
        try:
            s = run(name, args.full, "cpu" if args.cpu else None)
            print(f"--- twin {name} ({RUNS[name][0]}) ok in {s:.1f} s", flush=True)
        except AssertionError as e:
            failed.append(name)
            print(f"--- twin {name} ({RUNS[name][0]}) FAILED its assert: {e!r}", flush=True)
    print(f"twins {'/'.join(args.names)}: " + (f"failed {failed}" if failed else "ok"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
