"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``approximategps_tpu_torch`` passes,
``approximategps_tpu`` does not), and the reference imports nothing of the
program under test."""

import ast
import json
import shutil
import subprocess
import sys

import pytest
from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "approximategps_tpu"}
BENCH = ROOT / "gpbench"


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_gpbench_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in imported(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_gpbench_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in imported(path):
            top = name.split(".")[0]
            assert top in {"__future__", "dataclasses", "math", "torch", "gpbench"}, (path, name)
            assert top != "gpbench" or name.startswith("gpbench.reference"), (path, name)


def _python(code, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_gpbench_a_run_loads_no_jax_module():
    code = f"""
import sys, json, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
from tiny import TINY
from gpbench.harness import runner, spec
from gpbench import calibrate
b = spec.load_spec()
for c in b["configs"]:
    spec.reference_module(spec.config(b, c["name"])["model"])
for m in b["per_layer"]:
    spec.reader(m["name"])
cell = "svgp_airline.fullbatch"
runner.run_cell(cell, 5, 0.3, True, t_start=time.perf_counter(), device="cpu",
                require_chip=False, overrides=TINY[cell], log=open("/dev/null", "w"))
print(json.dumps(runner.forbidden_modules()))
"""
    assert _python(code) == []


REFERENCES = sorted(p.stem for p in (BENCH / "reference").glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("model", REFERENCES)
def test_gpbench_reference_alone_loads_nothing_of_the_program(model):
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import gpbench.reference.{model}
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("approximategps_tpu_torch", "jax",
                                               "approximategps_tpu"))))
"""
    assert _python(code) == []


def test_gpbench_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload",
                          "svgp_airline.predict", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_gpbench_alone_in_a_directory_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "gpbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload",
                          "svgp_airline.predict", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
