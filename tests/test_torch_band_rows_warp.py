"""Row 6's warp-per-window kernel (``csrc/band_rows.cu``) on the CPU: a host
emulation in torch of the kernel's order of operations, against the plain
masked math (``masked_chol_solve_band_math``) and the JAX package's Pallas
kernel in interpret mode.

The kernel pads a window to a width KW (8, 16, 32 or 64) with identity rows
that couple to nothing, factors right-looking (column j's pivot floored at
8·eps·|Kw_jj| and deflated below it, its entries scaled, then the trailing
rows updated), carries the forward substitution w = L⁻¹kni along the
columns, and back-substitutes by columns of L (b_t, then every row adds
L_ti·b_t); the column is scaled by the pivot's reciprocal and both
substitutions divide by the pivot, as the plain version does (the kernel
takes the quotient from the reciprocal with one correction).  The emulation does the same, batched over windows, so what is
held here is the order in which pivots, floors and deflations are decided
and that the padding changes no entry.  Windows: previous-k windows of
points in 2-D, the first k masked (identity rows, zero coupling), every
third repeating a neighbour in the next slot (a deflated pivot); B ragged
against every kernel block.

Tolerances, relative to the largest entry: f64 1e-12 against the plain
masked math and the Pallas kernel (sums in another order; at most
2.6e-14 measured); f32 against the plain version in f64 at ``ROWS_RTOL32`` = 1e-4,
the limit ``chip_smoke.py`` phase 10 holds the kernel to on the card (the
windows' conditioning amplifies f32 rounding; at most 3.0e-6 measured); the
emulation at its own width against width 64 (more identity padding) 1e-14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.ops import batched_chol as jb
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import batched_chol as tb

torch.set_num_threads(1)

WIDTHS = (8, 16, 32, 64)  # band_rows.cu: the template widths a window is padded to
ROWS_RTOL32 = 1e-4


def width(k: int) -> int:
    return next(w for w in WIDTHS if k <= w)


def emulate_band_rows(Kw, kni, kdiag, kw_width=None):
    """The kernel's arithmetic in its order, batched over windows."""
    B, k, _ = Kw.shape
    KW = kw_width or width(k)
    dt = Kw.dtype
    eps8 = 8.0 * torch.finfo(dt).eps
    A = torch.eye(KW, dtype=dt).repeat(B, 1, 1)
    A[:, :k, :k] = torch.tril(Kw)
    c = torch.zeros((B, KW), dtype=dt)
    c[:, :k] = kni
    dg = torch.diagonal(A, dim1=1, dim2=2).clone()
    acc = torch.zeros_like(c)
    w = torch.zeros_like(c)
    live = torch.zeros_like(c, dtype=torch.bool)
    for j in range(KW):
        d_raw = A[:, j, j]
        fl = eps8 * dg[:, j].abs()
        lv = d_raw >= fl
        sq = torch.sqrt(torch.where(lv, d_raw, fl))
        scale = torch.where(lv, 1.0 / sq, torch.zeros_like(sq))
        l = A[:, j + 1:, j] * scale[:, None]
        A[:, j + 1:, j] = l
        A[:, j, j] = sq
        live[:, j] = lv
        w[:, j] = torch.where(lv, (c[:, j] - acc[:, j]) / sq, torch.zeros_like(sq))
        acc[:, j + 1:] += l * w[:, j, None]
        A[:, j + 1:, j + 1:] -= torch.tril(l[:, :, None] * l[:, None, :])
    b = torch.zeros_like(c)
    bacc = torch.zeros_like(c)
    for t in reversed(range(KW)):
        bt = torch.where(live[:, t], (w[:, t] - bacc[:, t]) / A[:, t, t],
                         torch.zeros_like(c[:, 0]))
        b[:, t] = bt
        bacc[:, :t] += A[:, t, :t] * bt[:, None]
    F_raw = kdiag - torch.sum(c * b, dim=1)
    fF = eps8 * kdiag.abs()
    u0 = 1.0 / torch.sqrt(torch.where(F_raw > fF, F_raw, fF))
    return torch.cat([-b[:, :k] * u0[:, None], u0[:, None]], dim=1)


def _windows(N, k, seed):
    """Masked (Kw, kni, kdiag) of previous-k windows of 2-D points (numpy
    inputs): the first k windows have masked slots, every third window
    repeats a neighbour in the next slot, so that pivot deflates."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.2 * np.sqrt(N), (N, 2))
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    if k >= 2:
        rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
        idx[rep, 1] = idx[rep, 0]
    valid = (idx >= 0).astype(np.float64)
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    Kw, kni, kdiag = tb.window_gram_inputs(torch.tensor(np.ascontiguousarray(xw)),
                                           torch.tensor(valid), tk.Matern32Kernel().kernel_map())
    return Kw, kni, kdiag, torch.tensor(valid)


def _rel(a, b) -> float:
    a = torch.as_tensor(np.array(a)).double()
    b = torch.as_tensor(np.array(b)).double()
    return ((a - b).abs().max() / b.abs().max()).item()


# k at 1, at a width's edge (7, 32), one past it (33: width 64) and at the limit
KS = [1, 7, 32, 33, 64]


@pytest.mark.parametrize("k", KS)
def test_torch_band_rows_warp_order_f64(k):
    N = 37 if k < 64 else 70  # ragged against 4 (k <= 32) and 2 (k = 64) windows a block
    Kw, kni, kdiag, valid = _windows(N, k, seed=k)
    live = tb._masked_chol_factor(Kw)[1]
    assert k == 1 or bool((live[:, :k] == 0).any())  # some pivots deflate
    got = emulate_band_rows(Kw, kni, kdiag)
    assert _rel(got, tb.masked_chol_solve_band_math(Kw, kni, kdiag)) <= 1e-12
    want = jb.batched_chol_solve_band(*(jnp.asarray(t.numpy()) for t in (Kw, kni, kdiag)))
    assert _rel(got, want) <= 1e-12
    assert bool((got[:, :k][valid == 0] == 0).all())  # masked slots exactly 0


@pytest.mark.parametrize("k", KS)
def test_torch_band_rows_warp_order_f32(k):
    Kw, kni, kdiag, valid = _windows(41, k, seed=100 + k)
    got = emulate_band_rows(Kw.float(), kni.float(), kdiag.float())
    assert got.dtype == torch.float32
    assert _rel(got, tb.masked_chol_solve_band_math(Kw, kni, kdiag)) <= ROWS_RTOL32
    assert bool((got[:, :k][valid == 0] == 0).all())


@pytest.mark.parametrize("k", [1, 7, 20])
def test_torch_band_rows_warp_padding_changes_nothing(k):
    """The identity rows a window is padded with couple to nothing: the
    kernel's width and the widest one give the same rows."""
    Kw, kni, kdiag, _ = _windows(29, k, seed=200 + k)
    assert _rel(emulate_band_rows(Kw, kni, kdiag),
                emulate_band_rows(Kw, kni, kdiag, kw_width=64)) <= 1e-14
    assert [width(kk) for kk in (1, 8, 9, 16, 17, 32, 33, 64)] == [8, 8, 16, 16, 32, 32, 64, 64]
