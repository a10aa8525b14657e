"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files and entries alone: in a copy of the benchmark,
add one of each, edit no existing file but BENCHMARK.json's lists, and
run the new cell at a tiny size on the CPU's plain path.  The same for a
cell that brings a loop of its own: the loop, its calibration, its mix,
its limits and its CPU size are new files, and the cell runs correct, and
each of its faults and the control come out not correct."""

import hashlib
import json
import shutil
import subprocess
import sys

from tiny import ROOT

CELL = "svgp_small.minibatch_small"
READER = '''"""steps_in_window: the window's training steps (a count the loop keeps)."""


def read(view):
    return view.done.get("steps")
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "gpbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def copy(tmp_path):
    """A copy of the benchmark beside the program, and its files' digests."""
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "approximategps_tpu_torch").symlink_to(ROOT / "approximategps_tpu_torch")
    return tmp_path / "gpbench", digests(tmp_path)


def last_line(code, cwd):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_gpbench_takes_new_files_and_entries(tmp_path):
    bench, before = copy(tmp_path)

    cfg = json.loads((bench / "configs" / "svgp_airline.json").read_text())
    cfg.update(name="svgp_small", num_data=2000, num_inducing=32)
    (bench / "configs" / "svgp_small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "minibatch_small.json").write_text(json.dumps(
        {"loop": "svgp_train", "batch": 128, "learning_rate": 0.001, "setup_steps": 4}))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"loss_gap": 1e-5, "grad_gap": 1e-4, "step_gap": 1e-5}))
    (bench / "metrics" / "steps_in_window.py").write_text(READER)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "svgp_small", "source": cfg["source"],
                            "file": "gpbench/configs/svgp_small.json", "reduced": [],
                            "why": "a test's configuration"})
    spec["workloads"].append({"name": CELL, "config": "svgp_small", "traffic": "minibatch_small",
                              "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_points_per_s":
            m["workloads"].append(CELL)
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "model",
                              "moves": "train_points_per_s", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys, time
sys.path.insert(0, {str(tmp_path)!r})
from gpbench.harness import runner
print(json.dumps(runner.run_cell({CELL!r}, 11, 0.5, True, t_start=time.perf_counter(),
                                 device="cpu", require_chip=False)))
"""
    result = last_line(code, tmp_path)
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_in_window"]["value"] >= 1
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())


LOOP_CELL = "svgp_airline.minibatch_again"
LOOP = "svgp_train_again"


def test_gpbench_takes_a_cell_with_a_new_loop_as_new_files(tmp_path):
    bench, before = copy(tmp_path)
    (bench / "loops" / f"{LOOP}.py").write_text(
        '"""svgp_train\'s loop under a second name."""\n\n'
        "from gpbench.loops.svgp_train import *  # noqa: F403\n")
    (bench / "calibration" / f"{LOOP}.py").write_text(
        '"""svgp_train\'s calibration under a second name."""\n\n'
        "from gpbench.calibration.svgp_train import *  # noqa: F403\n")
    (bench / "traffic" / "minibatch_again.json").write_text(json.dumps(
        {"loop": LOOP, "batch": 4096, "learning_rate": 0.001, "setup_steps": 4}))
    (bench / "limits" / f"{LOOP_CELL}.json").write_text(json.dumps(
        {"loss_gap": 1e-5, "grad_gap": 1e-4, "step_gap": 1e-5}))
    (bench / "tests" / "tiny" / f"{LOOP_CELL}.json").write_text(json.dumps(
        {"config": {"num_data": 3000, "num_inducing": 64}, "traffic": {"batch": 256}}))

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": LOOP_CELL, "config": "svgp_airline",
                              "traffic": "minibatch_again", "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_points_per_s", "mfu.train"):
            m["workloads"].append(LOOP_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys, time
sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(0, {str(bench / "tests")!r})
import torch
from tiny import SECONDS, TINY
from gpbench import calibrate
from gpbench.harness import judge, runner, spec
cell = {LOOP_CELL!r}

def correct():
    return runner.run_cell(cell, 3_000_000_021, SECONDS, False, t_start=time.perf_counter(),
                           device="cpu", require_chip=False, overrides=TINY[cell])["correct"]

mix = {{**spec.traffic(spec.workload(spec.load_spec(), cell)["traffic"]), **TINY[cell]["traffic"]}}
faults = {{}}
for name, fault in calibrate.faults_for(mix).items():
    with fault():
        faults[name] = correct()
(control,) = [r for r in calibrate.calibrate(cell, [], [3_000_000_021], [], SECONDS,
                                             torch.device("cpu"), overrides=TINY[cell],
                                             emit=lambda _: None) if r["kind"] == "control"]
print(json.dumps({{"sound": correct(), "faults": faults,
                  "control": judge.all_within(judge.held(control, spec.limits(cell)))}}))
"""
    result = last_line(code, tmp_path)
    assert result["sound"]
    assert result["faults"] == {"unchanged": False, "half_minibatch": False}
    assert result["control"] is False
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
