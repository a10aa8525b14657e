"""The program's spans (``approximategps_tpu_torch.utils.profiling.spans``)
joined with the traced window: the launch calls begun inside them and the
device's idle time that falls inside them.

Spans are stamped on ``time.time_ns()``, the clock of the profiler's
kineto events, so a span's ns ÷ 1000 lies on the trace's µs.  Only the
main thread's spans that lie wholly inside the trace's first-to-last event
are kept.  A launch call is a host event named in ``LAUNCHES``; the
device's idle time is the gaps between consecutive device operations, as
``Trace.breakdown`` reckons them.  ``join`` returns None where the
program records no spans (a program without them, or a trace without the
device's operations), and the readers then read nothing."""

from __future__ import annotations

import bisect
import threading

LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync",
                      "cudaMemcpyAsync"})
# the span a step or a request is, by the entry point that records it
OUTER = ("adam_fit.step", "predict_blocks")


class Joined:
    """The kept spans, as (start µs, end µs, name) sorted by start, the
    starts of the window's launch calls, the device's idle gaps as
    (start µs, end µs) and the window in µs."""

    def __init__(self, spans: list, launch_starts: list, gaps: list, window_us: float):
        self.spans, self.launch_starts, self.gaps = spans, launch_starts, gaps
        self.window_us = window_us

    def named(self, name: str) -> list:
        return [(s, e) for s, e, n in self.spans if n == name]

    def outer(self) -> str | None:
        """The name of the outer span of a step or a request, the first of
        ``OUTER`` that the window holds."""
        found = {n for _, _, n in self.spans}
        return next((name for name in OUTER if name in found), None)

    def inside(self, inner: list, outer: list) -> list:
        """The intervals of ``inner`` that lie wholly inside one of the
        disjoint ``outer``."""
        outer = _union(outer)
        starts = [s for s, _ in outer]
        out = []
        for s, e in inner:
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and e <= outer[k][1]:
                out.append((s, e))
        return out

    def launches_in(self, intervals: list) -> int:
        """Launch calls begun inside the disjoint ``intervals``."""
        starts = self.launch_starts
        return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
                   for s, e in _union(intervals))

    def idle_pct(self, intervals: list) -> float:
        """The device's idle time inside ``intervals`` as a percentage of the
        window."""
        return 100.0 * _overlap(_union(self.gaps), _union(intervals)) / self.window_us

    def idle_total_pct(self) -> float:
        return 100.0 * sum(e - s for s, e in self.gaps) / self.window_us


def join(view) -> Joined | None:
    """The program's spans joined with ``view.trace``; None where the trace
    holds no device operation or the program recorded no span in it.
    Joined once a view, for all its readers."""
    if not hasattr(view, "_spans_joined"):
        view._spans_joined = _join(view)
    return view._spans_joined


def _join(view) -> Joined | None:
    try:
        from approximategps_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    tr = view.trace
    if not tr.device or tr.window_s <= 0:
        return None
    events = tr.device + tr.host
    first, last = min(s for s, _, _ in events), max(e for _, e, _ in events)
    main = threading.main_thread().ident
    kept = sorted((s / 1e3, e / 1e3, name) for name, tid, s, e in spans()
                  if tid == main and first <= s / 1e3 and e / 1e3 <= last)
    if not kept:
        return None
    launch_starts = [s for s, _, name in tr.host if name in LAUNCHES]
    gaps = [(a_end, b_start) for (_, a_end, _), (b_start, _, _) in zip(tr.device, tr.device[1:])
            if b_start > a_end]
    return Joined(kept, launch_starts, gaps, tr.window_s * 1e6)


def _union(intervals: list) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
