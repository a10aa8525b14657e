"""svgp_data_epilogue_roofline.<part>: row 2 (the fused SVGP epilogue's
forward, 3xTF32 on the tensor cores), Σ least time ÷ Σ device time over the
window's launches, each block at its own size (a request's ragged last
block too)."""

from gpbench.harness import rows


def read(view):
    return rows.roofline(view, "fwd")
