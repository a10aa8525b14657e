#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``approximategps_tpu_torch``.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the cell
asks for.  Prints, as the last line of standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit), and the same checks as the last lines of standard
error.  Exits non-zero, printing no result, without the devices, when a
module of JAX or of the JAX package was loaded, or on any error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache at a fixed path inside the checkout; no library may load JAX
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".gpbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpbench.harness import runner

    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 t_start=T_START)
    except runner.NoChip as err:
        print(f"gpbench: {err}", file=sys.stderr)
        return 2
    bad = runner.forbidden_modules()
    if bad:
        print(f"gpbench: modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result, allow_nan=False, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
