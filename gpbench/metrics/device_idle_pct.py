"""device_idle_pct.<part>: the device's idle share of the traced window,
100·(1 − busy ÷ window), busy the union of the device's operations in the
profiler's trace."""


def read(view):
    if view.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
