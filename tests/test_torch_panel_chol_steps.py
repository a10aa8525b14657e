"""Rows 1 and 4's f32 kernel (``csrc/gram_chol_inv_mma.cu``: one launch a
panel step, the next diagonal block factored inside the step before it, the
products as 3xTF32) on the CPU: a host emulation in torch of its schedule
and arithmetic, against the plain versions and the JAX package's Pallas
kernels in interpret mode.  Row 1 generates K's tiles from the points,
row 4 reads a given matrix's tiles symmetrized, (A_ik + A_kiᵀ)/2 in A's
dtype; both pad M with identity rows and exact zeros.

The emulation runs the kernel's launches k = -1 .. n in order, with the
kernel's plan of blocks: (A) tile i > k of panel k, C = K_ik minus the
depth-split partial products, summed in split order after K's tile, then
L_ik = C·X_kᵀ; the look-ahead, (K_{k+1,k+1} minus (B)'s partials) minus
L_{k+1,k}L_{k+1,k}ᵀ,
factored and inverted by 16-wide sub-blocks; (C) J's row block k − 1,
−X_{k−1}·Σ_p L_{k−1,p}J_{p,m}.  Every product is 3xTF32 in f32 (A split
by truncation, B by rounding, each low half truncated again as the tensor
cores read it: the f32 low bits masked) and a plain product in f64, where
the emulation holds the schedule alone.

Tolerances: f64 against the plain versions and the Pallas kernels at the JAX
package's own (L 1e-10, J 1e-7: the inverse's error grows with cond(K));
f32 against the plain version in f64 at ``chip_smoke.py`` phase 3's limits
(‖dL‖_F/‖L‖_F ≤ 1e-4, max|LJ − I| ≤ 1e-3; at most 1.3e-7 and 4.4e-7
measured), and one TF32 product in place of three moves L at least ten
times further (about 1000 times measured).
M = 200 and 520 are not multiples of the 64-wide panel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.core import kernels as jk
from approximategps_tpu.ops.panel_chol import pallas_chol_inv, pallas_gram_chol_inv
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import panel_chol

torch.set_num_threads(1)

P, SB, TARGET_BLOCKS = 64, 16, 264  # gram_chol_inv_mma.cu: panel, sub-block, blocks a launch
SIG2, JITTER = 1.3, 1e-6
_MASK = -8192  # 0xffffe000: the 13 mantissa bits TF32 drops


def _trunc(x):
    return (x.view(torch.int32) & _MASK).view(torch.float32)


def _round(x):  # tf32_mma.cuh::tf32_split's hi
    return ((x.view(torch.int32) + 0x1000) & _MASK).view(torch.float32)


def _mm(A, B, terms=3):
    """A·B as the kernel forms it: 3xTF32 in f32 (``terms=1``: one TF32
    product; ``terms=2``: without A_lo·B_hi), a plain product in f64."""
    A, B = A.contiguous(), B.contiguous()
    if A.dtype == torch.float64:
        return A @ B
    bh = _round(B)
    if terms == 1:
        return _round(A) @ bh
    ah = _trunc(A)
    lo = _trunc(A - ah) @ bh if terms == 3 else 0.0
    return lo + ah @ _trunc(B - bh) + ah @ bh


def plan(k, n):
    """The kernel's blocks of launch k: (panels a split, splits of (A),
    splits of (B), (A) tiles, blocks)."""
    nA = n - k - 1 if 0 <= k <= n - 2 else 0
    has_b = 1 <= k <= n - 2
    kr = k - 1
    work = nA * k + (k if has_b else 0) + (kr * (kr + 1) // 2 if kr >= 1 else 0)
    ln = max(1, -(-work // TARGET_BLOCKS))
    sA = -(-k // ln) + 1 if k > 0 else 1  # split 0 generates K's tile
    sB = sA - 1 if has_b else 0
    nC = sum(-(-(kr - m) // ln) for m in range(max(kr, 0)))
    return ln, sA, sB, nA, sB + nA * sA + nC + (1 if k == -1 else 0)


def diag_factor_inv(C):
    """The diagonal step by 16-wide sub-blocks b: one warp factors the
    diagonal block right-looking and inverts it by columns (Y_b, with the
    pivots' reciprocals); X's block row b is -Y_b·(L_{b,<b} X_{<b,<b})
    beside Y_b; then the rows below, C_{>b,b}·Y_bᵀ, and the trailing
    update."""
    C = torch.tril(C.clone())
    X = torch.zeros_like(C)
    eye = torch.eye(SB, dtype=C.dtype)
    for o in range(0, P, SB):
        d = C[o:o + SB, o:o + SB].clone()
        pinv = torch.zeros(SB, dtype=C.dtype)
        for j in range(SB):
            sq = torch.sqrt(d[j, j])
            pinv[j] = 1.0 / sq
            d[j + 1:, j] = d[j + 1:, j] * pinv[j]
            d[j, j] = sq
            d[j + 1:, j + 1:] -= torch.tril(d[j + 1:, j, None] * d[None, j + 1:, j])
        d = torch.tril(d)
        C[o:o + SB, o:o + SB] = d
        Y = torch.zeros_like(d)
        for i in range(SB):  # every column at once: lane c solves L y = e_c
            Y[i] = (eye[i] - d[i, :i] @ Y[:i]) * pinv[i]
        T = C[o:o + SB, :o] @ X[:o, :o]
        X[o:o + SB, :o] = -(Y @ T)
        X[o:o + SB, o:o + SB] = Y
        C[o + SB:, o:o + SB] = C[o + SB:, o:o + SB] @ Y.T
        Lb = C[o + SB:, o:o + SB]
        C[o + SB:, o + SB:] -= torch.tril(Lb @ Lb.T)
    return torch.tril(C), X


def _padded(K):
    """K (M, M) in the kernel's padding: identity rows and columns up to a
    multiple of the panel, exact zeros beside them."""
    M = K.shape[0]
    Kp = torch.eye(-(-M // P) * P, dtype=K.dtype)
    Kp[:M, :M] = K
    return Kp


def emulate_gram_chol_inv(Z, sig2, jitter, kmap, terms=3):
    """Row 1: K's tiles generated from the points."""
    M = Z.shape[0]
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    K = sig2 * kmap.k_of_r2(r2) + jitter * torch.eye(M, dtype=Z.dtype)
    return emulate_steps(_padded(K), M, terms)


def emulate_chol_inv(A, terms=3):
    """Row 4: K's tiles A's symmetrized tiles, (A_ik + A_kiᵀ)/2 in A's
    dtype, as the kernel averages the staged tile and its transposed
    partner."""
    return emulate_steps(_padded(0.5 * (A + A.T)), A.shape[0], terms)


def emulate_steps(K, M, terms=3):
    """The kernel's launches on the padded K (Mp, Mp); (L, J) cut to M."""
    n = K.shape[0] // P
    L = torch.zeros_like(K)
    J = torch.zeros_like(K)

    def blk(A, i, j):
        return A[i * P:(i + 1) * P, j * P:(j + 1) * P]

    def depth_sum(parts):  # partial tiles summed in split order, as the last block does
        out = torch.zeros((P, P), dtype=K.dtype)
        for t in parts:
            out = out + t
        return out

    for k in range(-1, n + 1):
        ln, sA, sB, nA, blocks = plan(k, n)
        if blocks == 0:
            continue
        if 0 <= k <= n - 2:  # (B), then (A) with the look-ahead
            wB = [sum((_mm(blk(L, k + 1, p), blk(L, k + 1, p).T, terms)
                       for p in range(s * ln, min(k, (s + 1) * ln))), torch.zeros((P, P), dtype=K.dtype))
                  for s in range(sB)]
            X = blk(J, k, k)
            for i in range(k + 1, n):
                # split 0 is K's tile, split s > 0 minus its panels' products
                parts = [blk(K, i, k)] + [
                    -sum((_mm(blk(L, i, p), blk(L, k, p).T, terms)
                          for p in range((s - 1) * ln, min(k, s * ln))),
                         torch.zeros((P, P), dtype=K.dtype)) for s in range(1, sA)]
                C = depth_sum(parts) if sA > 1 else parts[0]
                blk(L, i, k)[:] = _mm(C, X.T, terms)
            Lr = blk(L, k + 1, k)
            C = (blk(K, k + 1, k + 1) - depth_sum(wB)) - _mm(Lr, Lr.T, terms)
        if k <= n - 2:
            if k == -1:
                C = blk(K, 0, 0)
            Lkk, Xkk = diag_factor_inv(C)
            blk(L, k + 1, k + 1)[:] = Lkk
            blk(J, k + 1, k + 1)[:] = Xkk
        kr = k - 1
        for m in range(max(kr, 0)):  # (C)
            if kr < 1:
                break
            splits = -(-(kr - m) // ln)
            parts = [sum((_mm(blk(L, kr, p), blk(J, p, m), terms)
                          for p in range(m + s * ln, min(kr, m + (s + 1) * ln))),
                         torch.zeros((P, P), dtype=K.dtype)) for s in range(splits)]
            T = depth_sum(parts) if splits > 1 else parts[0]
            blk(J, kr, m)[:] = -_mm(blk(J, kr, kr), T, terms)
    return L[:M, :M], J[:M, :M]


def _z(M, seed):
    return np.random.default_rng(seed).standard_normal((M, 8)) / 0.9


@pytest.mark.parametrize("M", [200, 520])
def test_torch_gram_chol_inv_steps_schedule_f64(M):
    Z = _z(M, M)
    kmap = tk.SqExponentialKernel().kernel_map()
    L, J = emulate_gram_chol_inv(torch.tensor(Z), SIG2, JITTER, kmap)
    L0, J0 = panel_chol.gram_chol_inv_plain(torch.tensor(Z), SIG2, JITTER, kmap)
    torch.testing.assert_close(L, L0, atol=1e-10, rtol=0)
    torch.testing.assert_close(J, J0, atol=1e-7, rtol=0)
    # the Pallas kernel takes panels that divide M: 40 divides 200 and 520
    Lj, Jj = jax.jit(lambda z: pallas_gram_chol_inv(
        z, SIG2, JITTER, jk.SqExponentialKernel.k_of_r2, panel=40, interpret=True))(jnp.asarray(Z))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-7, rtol=0)
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("M", [200, 520])
@pytest.mark.parametrize("cls", [tk.SqExponentialKernel, tk.Matern32Kernel], ids=["se", "m32"])
def test_torch_gram_chol_inv_steps_3xtf32_f32(cls, M):
    Z = _z(M, 7 + M)
    kmap = cls().kernel_map()
    L0, _ = panel_chol.gram_chol_inv_plain(torch.tensor(Z), SIG2, JITTER, kmap)
    eye = torch.eye(M, dtype=torch.float64)

    def errors(terms):
        L, J = emulate_gram_chol_inv(torch.tensor(Z, dtype=torch.float32), SIG2, JITTER, kmap,
                                     terms)
        assert L.dtype == torch.float32
        fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
        return fro, (L.double() @ J.double() - eye).abs().max().item()

    fro, res = errors(3)
    assert fro <= 1e-4 and res <= 1e-3, (fro, res)
    assert errors(1)[0] >= 10 * fro  # one TF32 product keeps about three digits


def test_torch_gram_chol_inv_steps_plan():
    """The plan covers each product once: (A)'s splits after its first (which
    generates K's tile) and (B)'s cover the panels before k, (C)'s the panels
    from m to k − 2; the path's M = 2048
    takes 34 launches of at most TARGET_BLOCKS + 2n + 1 blocks."""
    for n in (1, 2, 4, 9, 32):
        launches = 0
        for k in range(-1, n + 1):
            ln, sA, sB, nA, blocks = plan(k, n)
            launches += blocks > 0
            assert blocks <= TARGET_BLOCKS + 2 * n + 1
            if 0 <= k <= n - 2:
                assert sorted(p for s in range(1, sA) for p in range((s - 1) * ln, min(k, s * ln))) \
                    == list(range(k))
                assert sB == (sA - 1 if k >= 1 else 0)
            kr = k - 1
            for m in range(max(kr, 0)):
                splits = -(-(kr - m) // ln)
                assert sorted(p for s in range(splits)
                              for p in range(m + s * ln, min(kr, m + (s + 1) * ln))) \
                    == list(range(m, kr))
        if n == 32:
            assert launches == 34
    assert panel_chol.gram_chol_inv_part(2048, 8, torch.float32) == "mma"
    assert panel_chol.gram_chol_inv_part(2048, 8, torch.float64) == "loop"
    assert panel_chol.gram_chol_inv_part(2048, 65, torch.float32) is None


def test_torch_gram_chol_inv_steps_tight_limit_f32():
    """``chip_smoke.py`` phase 3's tighter f32 limit on row 1 (``ROW1_TIGHT32``)
    on its inputs (M = 2048, D = 8, the se map, the same draws): the kernel's
    3xTF32 schedule keeps ‖dL‖_F/‖L‖_F and max|LJ − I| against the plain
    version in f32 within it, and one or two TF32 products in place of three
    move both ten times past it."""
    from chip_smoke import ROW1_TIGHT32, SEED

    M, D = 2048, 8
    rng = np.random.default_rng(SEED + 1)
    rng.standard_normal((520, D))  # phase 3's f64 inputs come first
    Z = torch.tensor(rng.standard_normal((M, D)), dtype=torch.float32)
    kmap = tk.SqExponentialKernel().kernel_map()
    L0 = panel_chol.gram_chol_inv_plain(Z, SIG2, JITTER, kmap)[0].double()
    eye = torch.eye(M, dtype=torch.float64)

    def errors(terms):
        L, J = emulate_gram_chol_inv(Z, SIG2, JITTER, kmap, terms)
        fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
        return fro, (L.double() @ J.double() - eye).abs().max().item()

    assert max(errors(3)) <= ROW1_TIGHT32
    for terms in (1, 2):
        assert min(errors(terms)) >= 10 * ROW1_TIGHT32, terms


# -- row 4: the same schedule with K's tiles read from a given matrix --------


def _spd(Z, kmap):
    """Phase 3's given matrix: the Gram of the points plus the jitter, and a
    small asymmetry above the diagonal (the kernel factors sym(A))."""
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    A = SIG2 * kmap.k_of_r2(r2) + JITTER * torch.eye(Z.shape[0], dtype=Z.dtype)
    return A + 1e-7 * torch.triu(torch.ones_like(A), 1)


@pytest.mark.parametrize("M", [200, 520])
def test_torch_chol_inv_steps_schedule_f64(M):
    A = _spd(torch.tensor(_z(M, M)), tk.SqExponentialKernel().kernel_map())
    L, J = emulate_chol_inv(A)
    L0, J0 = panel_chol.chol_inv_plain(A)
    torch.testing.assert_close(L, L0, atol=1e-10, rtol=0)
    torch.testing.assert_close(J, J0, atol=1e-7, rtol=0)
    # the Pallas kernel takes the symmetric matrix and panels that divide M
    # (40 divides 200 and 520)
    Lj, Jj = jax.jit(lambda a: pallas_chol_inv(a, panel=40, interpret=True))(
        jnp.asarray((0.5 * (A + A.T)).numpy()))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-7, rtol=0)
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("M", [200, 520])
@pytest.mark.parametrize("cls", [tk.SqExponentialKernel, tk.Matern32Kernel], ids=["se", "m32"])
def test_torch_chol_inv_steps_3xtf32_f32(cls, M):
    A = _spd(torch.tensor(_z(M, 7 + M)), cls().kernel_map())
    L0, _ = panel_chol.chol_inv_plain(A)
    eye = torch.eye(M, dtype=torch.float64)

    def errors(terms):
        L, J = emulate_chol_inv(A.float(), terms)
        assert L.dtype == torch.float32
        fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
        return fro, (L.double() @ J.double() - eye).abs().max().item()

    fro, res = errors(3)
    assert fro <= 1e-4 and res <= 1e-3, (fro, res)
    assert errors(1)[0] >= 10 * fro  # one TF32 product keeps about three digits


def test_torch_chol_inv_steps_tight_limit_f32():
    """``chip_smoke.py`` phase 3 holds row 4 in f32 to row 1's tighter limit
    (``ROW1_TIGHT32``) on its inputs (M = 2048, D = 8, the se map, the same
    draws, the Gram plus the jitter and the small asymmetry): the kernel's
    3xTF32 schedule on A's tiles keeps ‖dL‖_F/‖L‖_F and max|LJ − I|
    against the plain version in f32 within it, and one or two TF32
    products in place of three move both ten times past it."""
    from chip_smoke import ROW1_TIGHT32, SEED

    M, D = 2048, 8
    rng = np.random.default_rng(SEED + 1)
    rng.standard_normal((520, D))  # phase 3's f64 inputs come first
    Z = torch.tensor(rng.standard_normal((M, D)), dtype=torch.float32)
    A = _spd(Z, tk.SqExponentialKernel().kernel_map())
    L0 = panel_chol.chol_inv_plain(A)[0].double()
    eye = torch.eye(M, dtype=torch.float64)

    def errors(terms):
        L, J = emulate_chol_inv(A, terms)
        fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
        return fro, (L.double() @ J.double() - eye).abs().max().item()

    assert max(errors(3)) <= ROW1_TIGHT32
    for terms in (1, 2):
        assert min(errors(terms)) >= 10 * ROW1_TIGHT32, terms
