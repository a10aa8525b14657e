"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files and entries alone: in a copy of the benchmark,
add one of each, edit no existing file but BENCHMARK.json's lists, and
run the new cell at a tiny size on the CPU's plain path."""

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


def test_gpbench_takes_new_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "approximategps_tpu_torch").symlink_to(ROOT / "approximategps_tpu_torch")
    before = digests(tmp_path)
    bench = tmp_path / "gpbench"

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
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_in_window"]["value"] >= 1
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
