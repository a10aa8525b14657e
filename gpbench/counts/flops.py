"""Floating-point operations of a whole SVGP step or prediction, counted
from the shapes of the textbook whitened SVGP, the same whatever
implements them (the program's S-correction route and fused kernels do
the same products in another order).  Exponentials and the O(M²)
and O(B·M) elementwise terms beside them are left out, as MFU counts do.

Forward of the ELBO on B points with M inducing points in D dimensions:
the Kuu Gram M²(3D + 1)/2, its Cholesky M³/3 and the triangular inverse
M³/3; the Kuf Gram B·M(3D + 1); A = Lk⁻¹Kuf M²B; LqᵀA M²B; the mean
2MB and the two column sums of squares 4MB.  A training step is the
forward and its backward, three forwards in all, as a matmul's pullback is
two matmuls of its size.  A prediction is the same forward without q's
build per point: 2M² + M(3D + 1) + 6M flops a point."""

from __future__ import annotations


def svgp_forward(m: int, b: int, d: int) -> float:
    return (m * m * (3 * d + 1) / 2 + 2 * m ** 3 / 3 + b * m * (3 * d + 1)
            + 2 * m * m * b + 6 * m * b)


def svgp_train_step(m: int, b: int, d: int) -> float:
    return 3.0 * svgp_forward(m, b, d)


def svgp_predict(m: int, n: int, d: int) -> float:
    return n * (2.0 * m * m + m * (3 * d + 1) + 6 * m)
