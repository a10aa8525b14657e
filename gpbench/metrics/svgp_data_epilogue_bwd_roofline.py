"""Row 3 (the fused SVGP epilogue's pullback, 3xTF32 on the tensor cores):
Σ least time ÷ Σ device time over the window's launches."""

from gpbench.harness import rows


def read(view):
    return rows.roofline(view, "bwd")
