"""The reader of ``chunks_per_step.train`` on synthetic spans: it counts the
``streaming.chunk`` spans inside the main thread's ``adam_fit.step`` spans
within the trace, and finds nothing in a program that records steps but
no chunk spans."""

import threading
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts the repository on the path)

from approximategps_tpu_torch.utils import profiling
from gpbench.harness import spec, trace

BASE = 1_700_000_000_000  # µs; its ns stay below 2**53, so they convert exactly
MAIN = threading.main_thread().ident
DEVICE = [(120, 150), (210, 300), (520, 560), (610, 700), (900, 950)]
HOST = [(100, "cudaLaunchKernel"), (515, "cudaLaunchKernel"), (955, "cudaStreamSynchronize")]
STEPS = [("adam_fit.step", 110, 400), ("adam_fit.forward", 110, 200),
         ("adam_fit.step", 510, 800), ("adam_fit.forward", 510, 600)]
# three calls of the data term in the first step, two in the second; one
# between the steps, one of another thread, and one of a step begun before
# the trace
CHUNKS = [("streaming.chunk", 112, 140), ("streaming.chunk", 140, 170),
          ("streaming.chunk", 170, 199), ("streaming.chunk", 512, 550),
          ("streaming.chunk", 550, 590), ("streaming.chunk", 450, 460),
          ("streaming.chunk", 520, 530, MAIN + 1), ("streaming.chunk", -50, -40),
          ("adam_fit.step", -60, 20)]


def span(name, s, e, tid=MAIN):
    return (name, tid, (BASE + s) * 1000, (BASE + e) * 1000)


def view():
    dev = sorted((float(BASE + s), float(BASE + e), "k") for s, e in DEVICE)
    hst = sorted((float(BASE + s), float(BASE + s) + 2.0, name) for s, name in HOST)
    return SimpleNamespace(trace=trace.Trace(dev, hst, 1e-3))


@pytest.mark.parametrize("rows, want", [
    (STEPS + CHUNKS, 2.5),
    (STEPS, None),  # a program without the span: the parent of the change that added it
    ([("streaming.chunk", 112, 140)], None),  # chunks but no steps
], ids=["chunks", "no chunk spans", "no steps"])
def test_gpbench_chunks_per_step_counts_calls_inside_steps(rows, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [span(*r) for r in rows])
    got = spec.reader("chunks_per_step.train").read(view())
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))
