"""The traced window: ``torch.profiler`` over the window, reduced to the
device's operations and the host's (on the card, its CUDA runtime calls),
the device's busy seconds, a breakdown of the longest device operations
and of the idle time by what the host was doing, and helpers that the
per-layer readers use."""

from __future__ import annotations

import bisect
import re

import torch

_CUDA = torch.autograd.DeviceType.CUDA


class Trace:
    """Device and host events of the window as (start µs, end µs, name),
    sorted by start, and the window's length in seconds."""

    def __init__(self, device: list, host: list, window_s: float):
        self.device = device
        self.host = host
        self.window_s = window_s
        self.busy_s = _union_us(device) / 1e6

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name in self.device if rx.search(name)) / 1e6

    def launches(self, core: str, lead: str | None = None,
                 tail: str | None = None) -> list[float]:
        """The device seconds of each launch of a hand-written kernel, in
        order.  A launch is a run of ``core`` operations back to back, with
        the ``lead`` operations directly before it (the same C call issues
        them) and the ``tail`` operations after it, up to the next lead or
        core; other operations in between are not counted."""
        rx_core = re.compile(core)
        rx_lead = re.compile(lead) if lead else None
        rx_tail = re.compile(tail) if tail else None
        out: list[float] = []
        pending, prev, open_ = 0.0, "", False
        for s, e, name in self.device:
            d = (e - s) / 1e6
            if rx_core.search(name):
                if prev == "core":
                    out[-1] += d
                else:
                    out.append(pending + d)
                pending, prev, open_ = 0.0, "core", True
            elif rx_lead is not None and rx_lead.search(name):
                pending = pending + d if prev == "lead" else d
                prev, open_ = "lead", False
            elif rx_tail is not None and open_ and rx_tail.search(name):
                out[-1] += d
                prev = "tail"
            else:
                pending, prev = 0.0, "other"
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between device operations by the longest host operation begun in
        each gap (what the host was doing while the card waited)."""
        by_name: dict[str, float] = {}
        for s, e, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        starts = [h[0] for h in self.host]
        idle: dict[str, float] = {}
        for (_, a_end, _), (b_start, _, _) in zip(self.device, self.device[1:]):
            gap = b_start - a_end
            if gap <= 0:
                continue
            inside = self.host[bisect.bisect_left(starts, a_end):bisect.bisect_left(starts,
                                                                                    b_start)]
            what = max(inside, key=lambda h: h[1] - h[0])[2] if inside else "(no host operation)"
            idle[what] = idle.get(what, 0.0) + gap / 1e6

        def ranked(d):
            return [[name[:160], secs] for name, secs in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]

        return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}


def _union_us(events: list) -> float:
    total, end = 0.0, float("-inf")
    for s, e, _ in events:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def start(dev: torch.device):
    """The profiler over the window.  On the card it records the device's
    activity alone (kernels, copies, memsets, and the CUDA runtime calls
    that launched them, which label the idle gaps).  Recording every host
    operator as well cut the traced window's rate to 0.55–0.76 of the
    untraced one in the host-paced cells on an H100, against 0.62–0.90
    without them: the traced idle share and rates hold the profiler's
    cost, the less of it the better."""
    acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def reduce(prof, window_s: float) -> Trace:
    events = list(prof.profiler.kineto_results.events())
    # a record_function range's shadow on the device's timeline spans its
    # kernels and the gaps between them: it is no operation
    ranges = {ev.name() for ev in events if ev.is_user_annotation()}
    device, host = [], []
    for ev in events:
        start_us = ev.start_ns() / 1e3
        span = (start_us, start_us + ev.duration_ns() / 1e3, ev.name())
        if ev.device_type() != _CUDA:
            host.append(span)
        elif ev.name() not in ranges:
            device.append(span)
    device.sort()
    host.sort()
    return Trace(device, host, window_s)
