"""launches_per_block.<part>: launch calls begun inside the program's
``predict_blocks`` spans over the traced window ÷ the ``predict.block``
spans inside them."""

from gpbench.harness import spans


def read(view):
    j = spans.join(view)
    if j is None:
        return None
    calls = j.named("predict_blocks")
    blocks = j.inside(j.named("predict.block"), calls)
    return j.launches_in(calls) / len(blocks) if blocks else None
