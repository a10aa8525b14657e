"""The Vecchia band rows (``ops/batched_chol.py``) on the CPU in f64 against
the JAX package's Pallas kernels in interpret mode.

On CPU tensors :func:`vecchia_band` runs its autograd Function with the plain
inner pass (the bordered (k+1) Cholesky), so what is held here is the
kernel's contract and the Function's pullback:

- rows 7, 8 and 10 (``pallas_vecchia_band``, ``pallas_vecchia_band_lanes``
  with a nugget and ``nugget_self`` both ways, ``pallas_vecchia_band_lanes_t``)
  on previous-k windows, whose first k rows have masked slots, and on
  windows with duplicated points, whose pivots deflate;
- the masked math from prebuilt Grams against the JAX function, and its
  gradient against the JAX custom VJP;
- the recompute pullback, the nugget's cotangent included, against the JAX
  custom VJPs (row 7's recompute, row 9's fused pullback).

Tolerances, relative to each array's largest entry: values 1e-12 and
gradients 1e-10 (f64; the two packages sum in other orders, and the
bordered and masked factorizations round differently).  Interpret-mode
calls stay at N ≤ 64 and k ≤ 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.ops import batched_chol as jb
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import batched_chol as tb

torch.set_num_threads(1)

MAPS = {
    "se": (agp.SqExponentialKernel, tk.SqExponentialKernel),
    "m12": (agp.Matern12Kernel, tk.Matern12Kernel),
    "m32": (agp.Matern32Kernel, tk.Matern32Kernel),
    "m52": (agp.Matern52Kernel, tk.Matern52Kernel),
}


def _windows(N, D, k, seed, duplicates=False):
    """Previous-k windows (N, D, k+1) of N points and their (N, k) mask; with
    ``duplicates`` every fourth point repeats the one before it, so windows
    hold coincident slots (a dependent column, a deflated pivot)."""
    rng = np.random.default_rng(seed)
    X = 1.5 * rng.standard_normal((N, D))
    if duplicates:
        X[1::4] = X[0::4][: X[1::4].shape[0]]
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    valid = (idx >= 0).astype(np.float64)
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    return np.ascontiguousarray(xw), valid


def _rel(t, j) -> float:
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _kmap(name):
    return MAPS[name][1]().kernel_map()


def _jfn(name):
    return MAPS[name][0].k_of_r2


@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "duplicates"])
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_vecchia_band_matches_row7(name, duplicates):
    """Row 7, the masked-column math on (N, D, k+1) windows; the masked
    slots of the first k rows are exactly 0."""
    xw, valid = _windows(41, 2, 6, seed=len(name), duplicates=duplicates)
    ref = jb.pallas_vecchia_band(jnp.asarray(xw), jnp.asarray(valid), _jfn(name))
    got = tb.vecchia_band(torch.tensor(xw), torch.tensor(valid), _kmap(name))
    assert got.shape == (41, 7)
    assert _rel(got, ref) <= 1e-12
    assert bool((got[:, :6][torch.tensor(valid) == 0] == 0).all())


@pytest.mark.parametrize("nugget_self", [True, False])
@pytest.mark.parametrize("name", ["se", "m32"])
def test_torch_vecchia_band_matches_row8_nugget(name, nugget_self):
    """Row 8, the bordered factorization, with a nugget on the valid
    diagonal and slot k in or out of it; duplicated points, whose pivots
    deflate without the nugget."""
    xw, valid = _windows(37, 3, 7, seed=3, duplicates=True)
    for nugget in (None, 0.05):
        kw = {} if nugget is None else {"nugget": jnp.asarray(nugget)}
        ref = jb.pallas_vecchia_band_lanes(jnp.asarray(xw), jnp.asarray(valid), _jfn(name),
                                           nugget_self=nugget_self, **kw)
        got = tb.vecchia_band(torch.tensor(xw), torch.tensor(valid), _kmap(name), nugget,
                              nugget_self)
        assert _rel(got, ref) <= 1e-12, nugget


def test_torch_vecchia_band_t_matches_row10():
    """Row 10 on transposed windows (D, k+1, N), with and without a nugget:
    the Function reads the layout through its strides."""
    xw, valid = _windows(45, 2, 5, seed=7)
    xwT, validT = np.ascontiguousarray(xw.transpose(1, 2, 0)), np.ascontiguousarray(valid.T)
    for nugget in (None, 0.2):
        kw = {} if nugget is None else {"nugget": jnp.asarray(nugget)}
        ref = jb.pallas_vecchia_band_lanes_t(jnp.asarray(xwT), jnp.asarray(validT), _jfn("m32"),
                                             **kw)
        got = tb.vecchia_band_t(torch.tensor(xwT), torch.tensor(validT), _kmap("m32"), nugget)
        assert _rel(got, ref) <= 1e-12, nugget
        assert torch.equal(got, tb.vecchia_band(torch.tensor(xw), torch.tensor(valid),
                                                _kmap("m32"), nugget))


def test_torch_bordered_plain_matches_masked_math():
    """The plain version (bordered) against the masked math on the same
    windows: roundoff on distinct points, and the same deflation rules
    where points coincide (the deflated coordinates give b = 0)."""
    kmap = _kmap("se")
    for duplicates in (False, True):
        xw, valid = _windows(60, 2, 8, seed=11, duplicates=duplicates)
        w, v = torch.tensor(xw), torch.tensor(valid)
        bordered = tb.vecchia_band_plain(w, v, kmap)
        masked = tb.masked_chol_solve_band_math(*tb.window_gram_inputs(w, v, kmap))
        assert _rel(bordered, masked.numpy()) <= 1e-12
        assert bool(torch.isfinite(bordered).all())


@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "duplicates"])
def test_torch_masked_math_matches_jax(duplicates):
    """The masked math from prebuilt Grams against the JAX function, value
    and gradient (the JAX XLA variant's custom VJP, ``_band_bwd``)."""
    xw, valid = _windows(50, 2, 6, seed=5, duplicates=duplicates)
    A, c, kd = (np.asarray(a) for a in jb._window_gram_inputs(
        jnp.asarray(xw), jnp.asarray(valid), agp.SqExponentialKernel.k_of_r2))
    A = A + 1e-3 * np.eye(6) * (np.arange(50)[:, None, None] % 3 == 0)  # nugget-like shifts
    g = np.random.default_rng(6).standard_normal((50, 7))
    ref, vjp = jax.vjp(jb.batched_chol_solve_band_unrolled, jnp.asarray(A), jnp.asarray(c),
                       jnp.asarray(kd))
    ref_bars = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (A, c, kd)]
    got = tb.masked_chol_solve_band_math(*ts)
    assert _rel(got, ref) <= 1e-12
    assert _rel(got, np.asarray(jb.masked_chol_solve_band_math(jnp.asarray(A), jnp.asarray(c),
                                                               jnp.asarray(kd)))) <= 1e-12
    bars = torch.autograd.grad(got, ts, torch.tensor(g))
    for what, t, j in zip(("A", "c", "kdiag"), bars, ref_bars):
        assert _rel(t, j) <= 1e-10, what


def _torch_grads(fn, xw, valid, nugget, g):
    w = torch.tensor(xw, requires_grad=True)
    nug = None if nugget is None else torch.tensor(nugget, dtype=torch.float64, requires_grad=True)
    out = fn(w, torch.tensor(valid), nug)
    wanted = [w] + ([] if nug is None else [nug])
    return out.detach(), torch.autograd.grad(out, wanted, torch.tensor(g))


def test_torch_vecchia_band_pullback_matches_row7_vjp():
    """No nugget: the recompute pullback against row 7's own backward (the
    JAX recompute, ``_vecchia_band_bwd``)."""
    xw, valid = _windows(40, 2, 5, seed=21)
    g = np.random.default_rng(22).standard_normal((40, 6))
    fn = agp.Matern52Kernel.k_of_r2
    _, vjp = jax.vjp(lambda w: jb.pallas_vecchia_band(w, jnp.asarray(valid), fn), jnp.asarray(xw))
    (ref,) = vjp(jnp.asarray(g))
    _, (got,) = _torch_grads(lambda w, v, n: tb.vecchia_band(w, v, _kmap("m52")), xw, valid,
                             None, g)
    assert _rel(got, ref) <= 1e-10


@pytest.mark.parametrize("nugget_self", [True, False])
def test_torch_vecchia_band_pullback_nugget_matches_row9(nugget_self):
    """With a nugget: x̄w and the nugget's cotangent against the JAX custom
    VJP of row 8, whose backward is row 9's fused pullback."""
    xw, valid = _windows(32, 2, 5, seed=31)
    g = np.random.default_rng(32).standard_normal((32, 6))
    fn = agp.SqExponentialKernel.k_of_r2
    _, vjp = jax.vjp(lambda w, n: jb.pallas_vecchia_band_lanes(
        w, jnp.asarray(valid), fn, nugget=n, nugget_self=nugget_self),
        jnp.asarray(xw), jnp.asarray(0.07))
    ref_w, ref_n = vjp(jnp.asarray(g))
    _, (got_w, got_n) = _torch_grads(
        lambda w, v, n: tb.vecchia_band(w, v, _kmap("se"), n, nugget_self), xw, valid, 0.07, g)
    assert _rel(got_w, ref_w) <= 1e-10
    assert abs(got_n.item() - float(ref_n)) <= 1e-10 * abs(float(ref_n))


def test_torch_vecchia_band_cpu_takes_the_plain_pass(monkeypatch):
    """A CPU tensor runs the plain version and counts no launch."""
    calls = []
    real = tb.vecchia_band_plain
    monkeypatch.setattr(tb, "vecchia_band_plain", lambda *a: calls.append(1) or real(*a))
    xw, valid = _windows(12, 1, 3, seed=1)
    before = tb.vecchia_band.launches
    tb.vecchia_band(torch.tensor(xw), torch.tensor(valid), _kmap("se"))
    assert calls == [1] and tb.vecchia_band.launches == before
