"""The readers of the program's spans (``harness/spans.py`` and the
``program_span`` metrics) on a synthetic trace and synthetic spans: launch
calls outside the spans are not counted, the idle shares add up to the
idle gaps' total, and a reader finds nothing without spans.  Then each
cell's tiny traced run off the card: the program records its spans there,
and with no device operation the readers return None."""

import threading
import time
from types import SimpleNamespace

import pytest

from tiny import SECONDS, TINY

from approximategps_tpu_torch.utils import profiling
from gpbench.harness import runner, spec, trace

BSPEC = spec.load_spec()
SPAN_METRICS = [m for m in BSPEC["per_layer"] if m["source"] == "program_span"]
BASE = 1_700_000_000_000  # µs; its ns stay below 2**53, so they convert exactly
MAIN = threading.main_thread().ident


def at(t):
    return float(BASE + t)


def span(name, s, e, tid=MAIN):
    return (name, tid, (BASE + s) * 1000, (BASE + e) * 1000)


def view(device, host, window_us=1000.0):
    dev = sorted((at(s), at(e), "k") for s, e in device)
    hst = sorted((at(s), at(s) + 2.0, name) for s, name in host)
    return SimpleNamespace(trace=trace.Trace(dev, hst, window_us / 1e6))


def read(name, v):
    return spec.reader(name).read(v)


# two full-data steps: each tiled by forward, backward and update
TRAIN_SPANS = [span("adam_fit.step", 110, 400), span("adam_fit.forward", 110, 200),
               span("adam_fit.backward", 200, 330), span("adam_fit.update", 330, 400),
               span("adam_fit.step", 510, 800), span("adam_fit.forward", 510, 600),
               span("adam_fit.backward", 600, 730), span("adam_fit.update", 730, 800),
               # another thread's span, one begun before the trace and one long gone
               span("adam_fit.step", 0, 1000, tid=MAIN + 1), span("adam_fit.step", 30, 45),
               span("adam_fit.step", -900, -800)]
TRAIN_DEVICE = [(50, 60), (120, 150), (160, 190), (210, 300), (340, 350), (380, 390),
                (450, 470), (520, 560), (610, 700), (740, 790), (900, 950)]
# five launch calls in the first step, three in the second, three outside
TRAIN_HOST = [(40, "cudaLaunchKernel"), (115, "cudaLaunchKernel"), (155, "cudaMemsetAsync"),
              (205, "cudaLaunchKernelExC"), (335, "cudaLaunchKernel"), (375, "cudaMemcpyAsync"),
              (390, "cudaFuncGetAttributes"), (445, "cudaLaunchKernel"),
              (515, "cudaLaunchKernel"), (605, "cudaLaunchKernel"), (735, "cudaLaunchKernel"),
              (895, "cudaLaunchKernel"), (955, "cudaStreamSynchronize")]
# gaps 60-120, 150-160, 190-210, 300-340, 350-380, 390-450, 470-520, 560-610,
# 700-740, 790-900: 470 µs of the 1000
TRAIN_READINGS = {"launches_per_step.train": 4.0, "host_us_per_launch.train": 580.0 / 8,
                  "idle_in_forward_pct.train": 8.0, "idle_in_backward_pct.train": 8.0,
                  "idle_in_update_pct.train": 7.0, "idle_outside_spans_pct.train": 24.0}

# one request of 2.5 blocks; a second request begun before the trace
PREDICT_SPANS = [span("predict_blocks", 100, 420), span("predict.block", 110, 200),
                 span("predict.block", 200, 300), span("predict.block", 300, 380),
                 span("predict_blocks", 5, 60), span("predict.block", 20, 40)]
PREDICT_DEVICE = [(30, 50), (120, 180), (210, 290), (320, 370), (400, 410), (600, 700)]
PREDICT_HOST = [(10, "cudaLaunchKernel"), (115, "cudaLaunchKernel"),
                (205, "cudaLaunchKernel"), (305, "cudaMemsetAsync"),
                (310, "cudaLaunchKernel"), (395, "cudaLaunchKernel"),
                (590, "cudaLaunchKernel"), (710, "cudaEventRecord")]
# gaps 50-120, 180-210, 290-320, 370-400, 410-600: 350 µs of the 1000, 80 of
# them in blocks, 40 more in the request's own span
PREDICT_READINGS = {"launches_per_block.predict": 5 / 3, "host_us_per_launch.predict": 320 / 5,
                    "idle_in_blocks_pct.predict": 8.0, "idle_outside_spans_pct.predict": 23.0}


@pytest.fixture
def recorded(monkeypatch):
    def use(rows):
        monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    return use


@pytest.mark.parametrize("name", sorted(TRAIN_READINGS) + sorted(PREDICT_READINGS))
def test_gpbench_span_reader_counts_inside_the_spans_alone(name, recorded):
    train = name in TRAIN_READINGS
    recorded(TRAIN_SPANS if train else PREDICT_SPANS)
    v = view(*(TRAIN_DEVICE, TRAIN_HOST) if train else (PREDICT_DEVICE, PREDICT_HOST))
    want = (TRAIN_READINGS if train else PREDICT_READINGS)[name]
    assert read(name, v) == pytest.approx(want, rel=1e-9)


def _gaps_pct(v):
    dev = v.trace.device
    return 100.0 * sum(max(0.0, b[0] - a[1]) for a, b in zip(dev, dev[1:])) / (
        v.trace.window_s * 1e6)


def test_gpbench_span_idle_shares_add_up(recorded):
    recorded(TRAIN_SPANS)
    v = view(TRAIN_DEVICE, TRAIN_HOST)
    parts = ["idle_in_forward_pct.train", "idle_in_backward_pct.train",
             "idle_in_update_pct.train", "idle_outside_spans_pct.train"]
    total = _gaps_pct(v)
    assert sum(read(p, v) for p in parts) == pytest.approx(total, rel=1e-12)
    assert total <= read("device_idle_pct.train", v)
    recorded(PREDICT_SPANS)
    v = view(PREDICT_DEVICE, PREDICT_HOST)
    inside = read("idle_in_blocks_pct.predict", v) + read("idle_outside_spans_pct.predict", v)
    assert inside <= _gaps_pct(v) <= read("device_idle_pct.predict", v)


@pytest.mark.parametrize("case", ["no spans", "spans outside the trace", "another thread",
                                  "no device operation", "a program without spans"])
@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_gpbench_span_reader_finds_nothing(m, case, recorded, monkeypatch):
    rows = TRAIN_SPANS + PREDICT_SPANS
    device = TRAIN_DEVICE
    if case == "no spans":
        rows = []
    elif case == "spans outside the trace":
        rows = [(n, t, s + 5_000_000_000, e + 5_000_000_000) for n, t, s, e in rows]
    elif case == "another thread":
        rows = [(n, MAIN + 7, s, e) for n, _, s, e in rows]
    elif case == "no device operation":
        device = []
    recorded(rows)
    if case == "a program without spans":
        monkeypatch.delattr(profiling, "spans")
    assert read(m["name"], view(device, TRAIN_HOST)) is None


def run(cell):
    return runner.run_cell(cell, 3_000_000_019, SECONDS, True, t_start=time.perf_counter(),
                           device="cpu", require_chip=False, overrides=TINY[cell])


@pytest.mark.parametrize("cell, names", [
    ("svgp_airline.fullbatch", {"adam_fit.step", "adam_fit.forward", "adam_fit.backward",
                                "adam_fit.update"}),
    ("svgp_airline.predict", {"predict_blocks", "predict.block"})])
def test_gpbench_traced_run_records_spans_off_the_card(cell, names):
    profiling.reset_spans()
    r = run(cell)
    assert r["correct"]
    recorded = {name for name, *_ in profiling.spans()}
    assert names <= recorded
    wanted = {m["name"] for m in spec.per_layer(BSPEC, cell) if m["source"] == "program_span"}
    assert wanted and not wanted & set(r["metrics"])
