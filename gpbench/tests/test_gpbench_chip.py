"""Each cell's command on the card: a short run of ``gpbench/run.py`` in a
new process prints a correct result line with the cell's end-to-end
metrics, and a second traced run its per-layer metrics.  Marked ``gpu``;
skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from tiny import ROOT

from gpbench.harness import spec

BSPEC = spec.load_spec()
CELLS = [w["name"] for w in BSPEC["workloads"]]


def run(cell, traced):
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", cell, "--seed",
                          "4000000007", "--seconds", "3", "--trace", str(int(traced))],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_gpbench_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run(cell, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(BSPEC, cell)}
    t = run(cell, True)
    assert t["correct"], t["checks"]
    assert set(t["metrics"]) == {m["name"] for m in spec.per_layer(BSPEC, cell)}
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
    assert all(v["value"] <= 100 for k, v in t["metrics"].items() if v["unit"] == "%")
