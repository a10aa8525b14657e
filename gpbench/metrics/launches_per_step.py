"""launches_per_step.<part>: launch calls begun inside the program's
``adam_fit.step`` spans over the traced window ÷ those spans."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    steps = j.named("adam_fit.step") if j else []
    return j.launches_in(steps) / len(steps) if steps else None
