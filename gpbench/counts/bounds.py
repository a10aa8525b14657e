"""The least time of the port's kernels, frozen from the bound arithmetic of
the repository's chip smoke script at the time this benchmark was written.

The least time of a launch is the larger of its SIMT operations over the
f32 rate, its exponentials over the special-function rate, its
tensor-core operations over the TF32 rate (the f32-accurate kernels run
3xTF32: three TF32 products an FMA) and its bytes over the memory rate,
each input byte read once and each output byte written once.  Peaks of
one H100 SXM at 700 W (NVIDIA's data sheet and the Hopper white paper)."""

from __future__ import annotations

PEAK_F32 = 67e12          # f32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12        # dense TF32 FLOP/s on the tensor cores
PEAK_SFU = 16 * 132 * 1.98e9  # exp or sqrt a second: 16 a clock an SM, 132 SMs
PEAK_BYTES = 3.35e12      # HBM3 bytes a second


def bound(flops: float, nbytes: float, exps: float = 0.0, tc_flops: float = 0.0):
    """(ms, what bounds it): the least time the card could take."""
    ops_ms = 1e3 * max(flops / PEAK_F32, exps / PEAK_SFU, tc_flops / PEAK_TF32)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gram_chol_bounds(m: int, d: int, gram: bool = True):
    """((ms, by) on the tensor cores, (ms, by) as a SIMT count) of row 1
    (``gram``: the Kuu Gram generated inside, ``gram_chol_inv``) or row 4
    (``chol_inv`` of a given matrix) in f32 at (m, d): the factor and the
    triangular inverse are m³/6 FMAs each; row 1's Gram over the lower
    triangle is 3d + 1 flops and one exp an entry, row 4's symmetrization
    an add and a product an entry; Zs or A read once, L and J written
    once."""
    fmas = m ** 3 / 3
    if gram:
        simt, exps, nbytes = m * m / 2 * (3 * d + 1), m * m / 2, 4 * (m * d + 2 * m * m)
    else:
        simt, exps, nbytes = m * m, 0.0, 4 * 3 * m * m
    return (bound(simt, nbytes, exps, tc_flops=2 * 3 * fmas),
            bound(simt + 2 * fmas, nbytes, exps))


def epilogue_bounds(which: str, m: int, b: int, d: int):
    """((ms, by) on the tensor cores, (ms, by) as a SIMT count) of row 2
    ("fwd", ``svgp_data_epilogue``) or row 3 ("bwd", its pullback) in f32
    at (m, b, d): the forward's quadratic form over Se's triangle is m²b/2
    FMAs, the pullback's Se·K0 m²b and S̄e m²b/2; K0's 3d + 1 flops and one
    exp an entry, mu (or āe) m·b FMAs; each input read once and each output
    written once."""
    fmas = m * m * b / 2 if which == "fwd" else 1.5 * m * m * b
    simt = 2 * m * b + b * m * (3 * d + 1)
    nbytes = (4 * (b * d + m * d + m * m + m + 2 * b) if which == "fwd"
              else 4 * (2 * (b * d + m * d + m * m + m) + 2 * b))
    return (bound(simt, nbytes, b * m, tc_flops=2 * 3 * fmas),
            bound(simt + 2 * fmas, nbytes, b * m))
