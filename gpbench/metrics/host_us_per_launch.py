"""host_us_per_launch.<part>: the main thread's time inside the program's
step or request spans (``adam_fit.step``, else ``predict_blocks``) over the
traced window ÷ the launch calls begun inside them, in µs."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    name = j.outer() if j else None
    if name is None:
        return None
    outer = j.named(name)
    launches = j.launches_in(outer)
    return sum(e - s for s, e in outer) / launches if launches else None
