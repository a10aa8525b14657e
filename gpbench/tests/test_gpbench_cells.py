"""Each cell's mix at a tiny size on the CPU, through the program's plain
path, against the plain reference: a sound run comes out correct; each
fault the cell can have, planted underneath the timed path, and the
control (the reference in TF32 in the program's place) come out not
correct.  The harness's look for a chip is skipped.  A cell without its
CPU size (``tiny/<cell>.json``) or its loop's calibration
(``calibration/<loop>.py``) fails its own cases, each naming the file to
add, and leaves the other cells' cases to run."""

import time

import pytest

from tiny import SECONDS, TINY

from gpbench import calibrate
from gpbench.harness import judge, runner, spec

BSPEC = spec.load_spec()
CELLS = [w["name"] for w in BSPEC["workloads"]]
SEED = 3_000_000_019  # more than 31 bits: seeds run past a signed int32


def run(cell, traced=False):
    return runner.run_cell(cell, SEED, SECONDS, traced, t_start=time.perf_counter(),
                           device="cpu", require_chip=False, overrides=TINY[cell])


def mix_of(cell):
    tiny = TINY[cell]
    return {**spec.traffic(spec.workload(BSPEC, cell)["traffic"]), **tiny["traffic"]}


def fault_names(cell):
    """The cell's faults, found while the module is collected; a cell whose
    files are missing gets one case, which raises the error again."""
    if cell not in TINY:
        return ["missing_file"]
    try:
        return list(calibrate.faults_for(mix_of(cell)))
    except FileNotFoundError:
        return ["missing_file"]


@pytest.mark.parametrize("cell", CELLS)
def test_gpbench_cell_is_correct_on_the_plain_path(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    wanted = {m["name"] for m in spec.end_to_end(BSPEC, cell)}
    assert set(r["metrics"]) == wanted
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(spec.limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_gpbench_traced_run_reads_no_device_metric_off_the_card(cell):
    r = run(cell, traced=True)
    assert r["correct"]
    assert "busy_s" in r["device"] and "breakdown" in r
    assert not any(k.startswith(("device_idle", "mfu")) or "roofline" in k for k in r["metrics"])


FAULT_CASES = [(cell, name) for cell in CELLS for name in fault_names(cell)]


@pytest.mark.parametrize("cell, fault", FAULT_CASES, ids=lambda v: v)
def test_gpbench_fault_comes_out_not_correct(cell, fault):
    with calibrate.faults_for(mix_of(cell))[fault]():
        r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_gpbench_control_comes_out_not_correct(cell):
    import torch

    readings = calibrate.calibrate(cell, [], [SEED], [], SECONDS, torch.device("cpu"),
                                   overrides=TINY[cell], emit=lambda _: None)
    (control,) = [r for r in readings if r["kind"] == "control"]
    checks = judge.held(control, spec.limits(cell))
    assert not judge.all_within(checks), checks
