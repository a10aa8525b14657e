"""The program's spans (``utils/profiling.py``): ``named_scope`` records
(name, thread ident, start ns, end ns) on the profiler's clock only while a
``torch.profiler`` session is active; ``adam_fit`` and ``predict_blocks``
record their steps and blocks; ``trace`` writes the spans into its Chrome
trace.  The last case, marked ``gpu``, holds a span against a kernel's
device interval in the same profile on the card and skips without one."""

import json
import os
import threading

import pytest
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.utils.profiling import named_scope, reset_spans, spans, trace

SLACK_NS = 1_000_000
STEP_PARTS = ["adam_fit.forward", "adam_fit.backward", "adam_fit.update"]


def _params(M=6, D=2):
    g = torch.Generator().manual_seed(7)
    return {"k": torch.zeros(2, dtype=torch.float64),
            "z": torch.randn((M, D), generator=g, dtype=torch.float64),
            "m": 0.1 * torch.randn((M,), generator=g, dtype=torch.float64),
            "A": torch.eye(M, dtype=torch.float64)}


def _sva(p):
    kernel = torch.nn.functional.softplus(p["k"][0]) * tgp.with_lengthscale(
        tgp.SqExponentialKernel(), torch.nn.functional.softplus(p["k"][1]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
    return tgp.SparseVariationalApproximation(f(p["z"], 1e-6), q), f


def _data(n=40, D=2):
    g = torch.Generator().manual_seed(11)
    x = torch.randn((n, D), generator=g, dtype=torch.float64)
    return x, torch.sin(x[:, 0])


def _fit(steps=3):
    x, y = _data()

    def loss(p, xb, yb):
        sva, f = _sva(p)
        return -tgp.elbo(sva, f(xb, 0.1), yb, num_data=x.shape[0])

    return tgp.adam_fit(loss, _params(), [(x, y)] * steps, learning_rate=1e-2)


def _predict(points=20, block_size=8):
    with torch.no_grad():
        post = tgp.posterior(_sva(_params())[0])
    return post.predict_blocks(_data(points)[0], block_size=block_size)


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("entry", [_fit, _predict], ids=["adam_fit", "predict_blocks"])
def test_torch_spans_record_nothing_without_a_profiler(entry):
    reset_spans()
    entry()
    assert spans() == []
    assert named_scope("a") is named_scope("b")
    with named_scope("a"):
        pass
    assert spans() == []


def test_torch_spans_tile_each_adam_fit_step():
    reset_spans()
    with _cpu_profile():
        _, losses = _fit(3)
    assert len(losses) == 3
    main = threading.get_ident()
    rec = spans()
    assert all(tid == main for _, tid, _, _ in rec)
    steps = [(s, e) for name, _, s, e in rec if name == "adam_fit.step"]
    assert len(steps) == 3
    for s, e in steps:
        inside = sorted((a, b, name) for name, _, a, b in rec
                        if name in STEP_PARTS and s <= a and b <= e)
        assert [name for _, _, name in inside] == STEP_PARTS
        assert all(b0 <= a1 for (_, b0, _), (a1, _, _) in zip(inside, inside[1:]))


@pytest.mark.parametrize("points, blocks", [(20, 3), (16, 2), (5, 1)])
def test_torch_spans_one_block_span_a_block(points, blocks):
    """2.5 blocks of 8 points record three ``predict.block`` spans, the
    ragged last one too, inside one ``predict_blocks`` span."""
    reset_spans()
    with _cpu_profile():
        mu, var = _predict(points, 8)
    assert mu.shape == var.shape == (points,)
    rec = spans()
    (call,) = [(s, e) for name, _, s, e in rec if name == "predict_blocks"]
    inner = [(s, e) for name, _, s, e in rec if name == "predict.block"]
    assert len(inner) == blocks
    assert all(call[0] <= s <= e <= call[1] for s, e in inner)


def test_torch_span_encloses_a_labelled_kineto_event():
    """A span stamped on ``time.time_ns`` encloses the kineto event of a
    ``record_function`` range inside it, within 1 ms; the span itself is no
    kineto event."""
    a = torch.randn(128, 128)
    reset_spans()
    with _cpu_profile() as prof:
        with named_scope("agp_span_around"):
            with torch.profiler.record_function("agp_labelled_matmul"):
                (a @ a).sum()
    events = list(prof.profiler.kineto_results.events())
    (ev,) = [e for e in events if e.name() == "agp_labelled_matmul"]
    assert not any(e.name() == "agp_span_around" for e in events)
    (span,) = [(s, e) for name, _, s, e in spans() if name == "agp_span_around"]
    assert span[0] <= ev.start_ns() + SLACK_NS
    assert ev.start_ns() + ev.duration_ns() <= span[1] + SLACK_NS


def test_torch_reset_spans_empties_the_buffer():
    with _cpu_profile():
        with named_scope("agp_one"):
            pass
    assert any(name == "agp_one" for name, *_ in spans())
    reset_spans()
    assert spans() == []


def test_torch_trace_writes_spans_beside_the_ops(tmp_path):
    """``trace`` clears the spans when it starts and writes them into its
    Chrome trace as complete events on the file's base time: the span
    encloses an op recorded inside it."""
    with _cpu_profile():
        with named_scope("agp_before_the_trace"):
            pass
    a = torch.randn(96, 96)
    with trace(str(tmp_path)):
        with named_scope("agp_exported_span"):
            (a @ a).sum()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    with open(tmp_path / path) as fh:
        events = json.load(fh)["traceEvents"]
    assert not any(e.get("name") == "agp_before_the_trace" for e in events)
    (span,) = [e for e in events if e.get("name") == "agp_exported_span"]
    assert span["ph"] == "X" and span["tid"] == threading.get_native_id()
    ops = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert ops
    slack_us = SLACK_NS / 1e3
    assert any(span["ts"] <= op["ts"] + slack_us
               and op["ts"] + op["dur"] <= span["ts"] + span["dur"] + slack_us for op in ops)


@pytest.mark.gpu
def test_torch_span_encloses_its_kernel_on_the_card():
    """Under the CUDA-only profile the benchmark traces with, a span around
    a matmul launched and then synchronised encloses the kernel's device
    interval: the spans' clock is the device trace's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()
    reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            with named_scope(f"agp_kernel_{i}"):
                a @ a
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                     if e.device_type() == cuda and not e.is_user_annotation())
    rec = sorted((s, e) for name, _, s, e in spans() if name.startswith("agp_kernel_"))
    assert len(rec) == 5 and len(kernels) >= 5
    assert not any(e.name().startswith("agp_kernel_") for e in events)
    for s, e in rec:
        inside = [k for k in kernels if s <= k[0] and k[1] <= e]
        assert inside, (s, e, kernels)
