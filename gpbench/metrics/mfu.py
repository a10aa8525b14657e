"""mfu.<part>: the window's FLOPs, counted from the shapes of its training
steps or requests (``counts/flops.py``), over the window on the host clock
and the card's dense TF32 peak.  It is read in the traced run, so the
profiler's cost lies inside its window."""

from gpbench.counts.bounds import PEAK_TF32


def read(view):
    flops = view.done.get("flops")
    if not flops or view.trace.busy_s <= 0:
        return None
    return 100.0 * flops / view.trace.window_s / PEAK_TF32
