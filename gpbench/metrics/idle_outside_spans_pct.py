"""idle_outside_spans_pct.<part>: the device's idle time while the main
thread was in none of the program's spans (the harness's feed, the
client's events, copies, checks and waits), as a percentage of the traced
window: the idle gaps' total less their part inside the spans' union."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    if j is None:
        return None
    return j.idle_total_pct() - j.idle_pct([(s, e) for s, e, _ in j.spans])
