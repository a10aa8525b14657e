"""Tracing and timing helpers (port of
``approximategps_tpu/utils/profiling.py``) on PyTorch: ``trace`` records a
``torch.profiler`` Chrome trace into a directory, ``named_scope`` labels a
region in it (``record_function``), and the timers wait for the card where
the output lies on it."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

__all__ = ["named_scope", "StepTimer", "trace", "time_fn"]

named_scope = torch.profiler.record_function  # label a region in the trace


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
    write its Chrome trace to ``log_dir/trace_<ns>.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


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
