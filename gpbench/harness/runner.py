"""One run of one cell: set-up, the measured window (traced or not), the
end-to-end or per-layer metrics, and the comparison with the plain
reference once the window has closed and the program's state is freed."""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from . import judge, spec, trace

# modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "approximategps_tpu")


class NoChip(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


def forbidden_modules() -> list[str]:
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _merge(base: dict, extra: dict | None) -> dict:
    return base if not extra else {**base, **extra}


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *, t_start: float,
             device: str | None = None, require_chip: bool = True, overrides: dict | None = None,
             log=sys.stderr) -> dict:
    """The result line of one run.  ``device``, ``require_chip`` and
    ``overrides`` ({"config": {...}, "traffic": {...}}, merged over the
    files) serve the CPU tests alone; the command line never sets them."""
    overrides = overrides or {}
    bspec = spec.load_spec()
    wl = spec.workload(bspec, cell)
    cfg = _merge(spec.config(bspec, wl["config"]), overrides.get("config"))
    mix = _merge(spec.traffic(wl["traffic"]), overrides.get("traffic"))
    limits = spec.limits(cell)
    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < wl["chips"]):
        raise NoChip(f"cell {cell} needs {wl['chips']} CUDA device(s); "
                     f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                     f"device_count() = {torch.cuda.device_count()}")
    dev = torch.device(device or "cuda:0")
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = spec.loop_module(mix["loop"])
    marks = [("imports", time.perf_counter())]

    run = loop.Run(cfg, mix, seed, dev)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    marks += run.marks + [("set-up", t_start + setup_s)]

    prof = trace.start(dev) if traced else None
    t0 = time.perf_counter()
    run.window(t0 + seconds)
    sync(dev)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = run.finish(window_s)
    card = power_limit() if dev.type == "cuda" else "cpu"

    if traced:
        tr = trace.reduce(prof, window_s)
        del prof
        view = LayerView(cell, cfg, mix, done, tr)
        metrics = {}
        for m in spec.per_layer(bspec, cell):
            value = spec.reader(m["name"]).read(view)
            if value is None:
                print(f"gpbench: {m['name']} found nothing to read", file=log)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in spec.end_to_end(bspec, cell):
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": done["e2e"][m["name"]], "unit": m["unit"]}

    # the reference runs once the window has closed, the peak has been read
    # and the program's state is freed
    inputs, outputs = run.inputs(), run.outputs()
    run.free()
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = loop.compare(spec.reference_module(cfg["model"]), cfg, mix, inputs, outputs)
    ref_s = time.perf_counter() - t_ref
    checks = judge.held(numbers, limits)
    correct = judge.all_within(checks) and done["failed"] == 0

    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": wl["chips"], "memory_peak_bytes": memory_peak, "card": card}
    result = {"correct": correct, "attempted": done["attempted"], "failed": done["failed"],
              "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    print("gpbench: set-up stages (s from the start): "
          + ", ".join(f"{name} {t - t_start:.3f}" for name, t in marks), file=log)
    print(f"gpbench: {cell} seed {seed}: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"reference {ref_s:.3f} s, {card}", file=log)
    for name, (value, limit) in checks.items():
        print(f"{name} {value!r} limit {limit!r}", file=log)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    return result


class LayerView:
    """What a per-layer reader reads: the cell, its configuration and mix,
    the window's counts from the loop (``done``: steps or requests, FLOPs,
    counters, launch shapes) and the trace."""

    def __init__(self, cell: str, cfg: dict, mix: dict, done: dict, tr: trace.Trace):
        self.cell, self.config, self.traffic, self.done, self.trace = cell, cfg, mix, done, tr

    def share(self, part_s: float) -> float | None:
        """``part_s`` as a percentage of the device's busy time."""
        return 100.0 * part_s / self.trace.busy_s if self.trace.busy_s > 0 else None

    def roofline(self, least_ms: list[float], launches_s: list[float]) -> float | None:
        """Σ least time ÷ Σ device time over the window's launches of one
        kernel; None where the trace holds none of them.  The loop counts
        the launches it made; a trace that finds another number says so."""
        if not launches_s or not least_ms:
            return None
        if len(launches_s) != len(least_ms):
            print(f"gpbench: {len(launches_s)} launches in the trace, {len(least_ms)} made",
                  file=sys.stderr)
        return 100.0 * (sum(least_ms) / 1e3) / sum(launches_s)
