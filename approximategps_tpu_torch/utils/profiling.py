"""Tracing and timing helpers (port of
``approximategps_tpu/utils/profiling.py``) on PyTorch: ``trace`` records a
``torch.profiler`` Chrome trace into a directory, ``named_scope`` is the
program's span, and the timers wait for the card where the output lies on
it.

A span is ``(name, thread ident, start ns, end ns)``: the clock is
``time.time_ns()``, that of the profiler's kineto events, and the thread
is ``threading.get_ident()`` (the native id is a system call, which took
7–15 µs a span on an H100 host).  It records only while a
``torch.profiler`` session is active, into a buffer that ``spans()`` reads
and ``reset_spans()`` empties; otherwise ``named_scope`` returns one shared
no-op context.  Spans are kept out of the kineto trace itself: ``trace``
adds them to the Chrome trace it writes."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["named_scope", "spans", "reset_spans", "StepTimer", "trace", "time_fn"]

# the spans recorded while a profiler session was active, in the order they closed
_spans: list[tuple[str, int, int, int]] = []
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        _spans.append((self.name, threading.get_ident(), self.start, time.time_ns()))


def named_scope(name: str):
    """A span around the ``with`` block, recorded only under an active
    ``torch.profiler`` session (one flag read otherwise)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> list[tuple[str, int, int, int]]:
    """The recorded spans: (name, ``threading.get_ident()``, start ns, end ns)."""
    return list(_spans)


def reset_spans() -> None:
    _spans.clear()


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists and
    dicts."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block_until_ready(out):
    """Wait for the card(s) that hold a tensor of ``out`` (``torch.cuda.
    synchronize``); nothing for CPU tensors.  Returns ``out``."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the host, and the card where there is one) and
    write its Chrome trace to ``log_dir/trace_<ns>.json`` on exit, with the
    block's spans as complete events beside the profiler's.  Clears the
    spans when it starts."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset_spans()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path)


def _add_spans(path: str) -> None:
    """Append the recorded spans to a Chrome trace as complete ("X")
    events, in µs from the file's ``baseTimeNanoseconds``, on the native
    thread ids the profiler's events carry (a thread gone keeps its
    ident)."""
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    native = {t.ident: t.native_id for t in threading.enumerate()}
    doc["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": native.get(ident, ident),
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3}
        for name, ident, start, end in _spans]
    with open(path, "w") as fh:
        json.dump(doc, fh)


class StepTimer:
    """Wall-clock step timer that waits for the card.

    >>> timer = StepTimer()
    >>> for batch in range(3):      # ... each training step:
    ...     _ = timer.tick(out=None)   # pass the step output to wait on it
    >>> sorted(timer.summary())
    ['mean_ms', 'min_ms', 'n', 'p50_ms', 'steps_per_sec']
    """

    def __init__(self):
        self._t0 = None
        self.times: list[float] = []

    def tick(self, out=None) -> float:
        if out is not None:
            _block_until_ready(out)
        now = time.perf_counter()
        dt = 0.0 if self._t0 is None else now - self._t0
        if self._t0 is not None:
            self.times.append(dt)
        self._t0 = now
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        mean = sum(ts) / len(ts)
        return {
            "mean_ms": mean * 1e3,
            "p50_ms": ts[len(ts) // 2] * 1e3,
            "min_ms": ts[0] * 1e3,
            "steps_per_sec": 1.0 / mean,
            "n": len(ts),
        }


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Mean wall seconds a call of ``fn``, waiting for the card's work."""
    for _ in range(warmup):
        out = fn(*args)
    _block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block_until_ready(out)
    return (time.perf_counter() - t0) / iters
