"""BENCHMARK.json against the benchmark's contract: keys, names, units,
the files each entry names (with each cell's CPU size and its loop's
calibration), the cells' metrics and the check's time."""

import json
import re

import pytest

from tiny import ROOT

from gpbench import calibrate
from gpbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"_dim$|_rank$|hidden|intermediate|latent|state|projection|head|expansion")

BSPEC = spec.load_spec()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_gpbench_top_level_keys_and_command():
    assert set(BSPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BSPEC["paths"] == ["gpbench"]
    assert BSPEC["command"] == ["python3", "gpbench/run.py"]
    assert all(line(w) for w in BSPEC["command"])
    assert isinstance(BSPEC["run_seconds"], int) and 1 <= BSPEC["run_seconds"] <= 51
    assert len(json.dumps(BSPEC)) <= 64 * 1024


def test_gpbench_check_fits_its_time_with_all_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BSPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BSPEC["configs"], ids=lambda e: e["name"])
def test_gpbench_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line(entry["source"]) and line(entry["why"])
    assert entry["file"].startswith("gpbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert (ROOT / "gpbench" / "reference" / f"{cfg['model']}.py").exists()
    assert any(w["config"] == entry["name"] for w in BSPEC["workloads"])


@pytest.mark.parametrize("wl", BSPEC["workloads"], ids=lambda w: w["name"])
def test_gpbench_workload_entry_and_its_files(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"]) and line(wl["why"])
    assert wl["chips"] == 1
    mix = spec.traffic(wl["traffic"])
    assert (ROOT / "gpbench" / "loops" / f"{mix['loop']}.py").exists()
    limits = spec.limits(wl["name"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in spec.end_to_end(BSPEC, wl["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BSPEC, wl["name"])
    assert layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("wl", BSPEC["workloads"], ids=lambda w: w["name"])
def test_gpbench_cell_has_its_cpu_size_and_its_loop_its_calibration(wl):
    tiny = ROOT / "gpbench" / "tests" / "tiny" / f"{wl['name']}.json"
    assert tiny.exists(), f"no {tiny.relative_to(ROOT)}"
    assert set(json.loads(tiny.read_text())) <= {"config", "traffic"}
    loop = spec.traffic(wl["traffic"])["loop"]
    cal = ROOT / "gpbench" / "calibration" / f"{loop}.py"
    assert cal.exists(), f"no {cal.relative_to(ROOT)}"
    module = calibrate.calibration_module(loop)
    assert isinstance(module.WINDOW, bool)
    assert all(callable(getattr(module, f)) for f in ("faults", "as_outputs", "numbers"))


def test_gpbench_cells_are_unique_pairs():
    names = [w["name"] for w in BSPEC["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in BSPEC["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    assert 1 <= len(names) <= 24


@pytest.mark.parametrize("m", BSPEC["end_to_end"] + BSPEC["per_layer"], ids=lambda m: m["name"])
def test_gpbench_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    cells = {w["name"] for w in BSPEC["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in BSPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"])
        assert m["moves"] in {e["name"] for e in BSPEC["end_to_end"]}
        assert spec.reader_path(m["name"]).exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_gpbench_names_are_unique_and_setup_s_is_there():
    metrics = [m["name"] for m in BSPEC["end_to_end"] + BSPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    configs = [c["name"] for c in BSPEC["configs"]]
    assert len(set(configs)) == len(configs)
    setup = [m for m in BSPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
