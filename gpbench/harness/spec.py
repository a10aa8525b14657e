"""``BENCHMARK.json`` and the files it names, each found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is named in ``configs``; the mix is
``traffic/<mix>.json``, whose ``loop`` names the loop module
``loops/<loop>.py`` that drives the program; the cell's correctness limits
are ``limits/<cell>.json``; a per-layer metric's reader is
``metrics/<metric>.py``, or, where no file has the whole name,
``metrics/<stem>.py`` for the name's part before its first dot (one reader
serves ``device_idle_pct.train`` and ``device_idle_pct.predict``); a
configuration's plain reference is
``reference/<model>.py``.  A later change adds a cell, a mix, a loop, a
metric or a configuration as new files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: dict, name: str) -> dict:
    entry = _named(spec["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def load_module(path: Path, name: str):
    """The module at ``path``, imported under ``name`` (metric files carry
    dots in their names, so they are loaded by path)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def loop_module(kind: str):
    return importlib.import_module(f"gpbench.loops.{kind}")


def reference_module(model: str):
    return importlib.import_module(f"gpbench.reference.{model}")


def reader_path(metric: str) -> Path:
    """The reader of ``metric``: the file with its whole name, else the
    file of its stem."""
    whole = BENCH / "metrics" / f"{metric}.py"
    return whole if whole.exists() else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    path = reader_path(metric)
    return load_module(path, "gpbench_metric_" + path.stem.replace(".", "_"))


def end_to_end(spec: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those with no ``workloads``
    key and those that list it."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(spec: dict, cell: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those with no ``workloads`` key whose ``moves`` metric it reports."""
    reported = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
