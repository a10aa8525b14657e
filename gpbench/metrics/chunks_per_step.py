"""chunks_per_step.<part>: the program's ``streaming.chunk`` spans (one a
call of the full-data data term, which takes one or several blocks) that
lie inside its ``adam_fit.step`` spans over the traced window ÷ those
spans.  Nothing where the program records no such span."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    steps = j.named("adam_fit.step") if j else []
    chunks = j.inside(j.named("streaming.chunk"), steps) if steps else []
    return len(chunks) / len(steps) if chunks else None
