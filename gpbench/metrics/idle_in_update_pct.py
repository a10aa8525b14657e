"""idle_in_update_pct.<part>: the device's idle time while the main thread
was inside the program's ``adam_fit.update`` spans, as a percentage of the
traced window."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    inside = j.named("adam_fit.update") if j else []
    return j.idle_pct(inside) if inside else None
