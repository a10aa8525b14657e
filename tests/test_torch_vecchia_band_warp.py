"""Rows 8 and 9's warp-per-window kernels (``csrc/vecchia_band.cu``,
``csrc/vecchia_band_bwd.cu``) on the CPU: host emulations in torch of the
kernels' order of operations, batched over windows, against the plain
versions (``vecchia_band_plain``, ``_recompute_pullback``) and the JAX
package's Pallas rows 8, 10 and 9 in interpret mode.

What the kernels do, and the emulations with them: a window's k × k block is
padded to a width KW (8, 16, 32 or 64) with identity rows that couple to
nothing, while slot k (the conditioned point) stays a border vector kni;
r² comes from exact coordinate differences, one coordinate after another;
the factor is right-looking (column j's pivot floored at 8·eps of its
original diagonal and deflated below it, its entries scaled, the trailing
rows updated) with w = L⁻¹kni alongside, each w_j a quotient by the pivot;
the band kernel takes the bordered last pivot F = Gm_kk − Σ w_j² (subtracted
column by column) and b = L⁻ᵀw by columns, each b_t a quotient by the pivot.
The pullback takes b, then F = kdiag − kni·b (the JAX convention), ū₀, F̄,
b̄, y = L⁻¹b̄ by rows, S = L⁻ᵀy by columns, the nugget partial and k̄ni, and
forms each pair (i, j), j < i, once: c_ij = 4 g′(r²) Gs_ij, whose terms
c_ij (x_i − x_j) row i sums over j and slot j's side sums over i > j in the
order of i.  So what is held here is the order in which pivots, floors and
deflations are decided, that the padding changes no entry, and the
pullback's pair sums.

Windows: previous-k windows of points about a lengthscale apart, the first
k masked, every third repeating a neighbour in the next slot (a deflated
pivot); the conditioned point never repeats a neighbour, since that sets F
at its floor, where roundoff decides the result.  N ragged against every
width's block of windows (32, 16, 8, 2).

Tolerances, relative to each array's largest entry (the nugget's partials
to the largest partial): f64 against the plain versions 1e-12 (band) and
1e-10 (pullback), as ``chip_smoke.py`` holds the kernels; against the
Pallas kernels in interpret mode the same.  The f32 emulations against the
plain versions in f64 on phase 9 (a)'s kind of k = 32 windows, within the
limits ``chip_smoke.py`` holds the f32 kernels to: the band at
``BAND_RTOL32`` = 1e-4 (at most 2.5e-5 measured: D = 1, SE, no nugget), x̄w
at ``BWD_XW_RTOL32`` = 1e-3 (at most 5.8e-5 measured, the same windows; the
f32 plain version's own 3.9e-5) and the nugget partials at
``BWD_NUG_RTOL32`` = 1e-4 (at most 4.1e-6).  The emulation at its own width against width 64 (more
identity padding): 1e-14.
"""

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

WIDTHS = (8, 16, 32, 64)  # the template widths a window's k x k block is padded to
BAND_RTOL32, BWD_XW_RTOL32, BWD_NUG_RTOL32 = 1e-4, 1e-3, 1e-4  # chip_smoke.py's f32 limits

MAPS = {
    "se": (agp.SqExponentialKernel, tk.SqExponentialKernel),
    "m12": (agp.Matern12Kernel, tk.Matern12Kernel),
    "m32": (agp.Matern32Kernel, tk.Matern32Kernel),
    "m52": (agp.Matern52Kernel, tk.Matern52Kernel),
}
NUGGETS = ((None, True), (0.1, False), (0.1, True))


def width(k: int) -> int:
    return next(w for w in WIDTHS if k <= w)


def _kmap(name):
    return MAPS[name][1]().kernel_map()


# -- the emulations ------------------------------------------------------------


def _pair_r2(xw, KW):
    """r² of every padded row against every slot below KW, and against slot
    k, coordinate by coordinate (slots past k at the origin)."""
    N, D, kp1 = xw.shape
    X = xw.new_zeros((N, D, KW + 1))
    X[:, :, :kp1] = xw
    xk = xw[:, :, kp1 - 1]
    r2 = xw.new_zeros((N, KW, KW))
    rk = xw.new_zeros((N, KW))
    for d in range(D):
        dd = X[:, d, :KW, None] - X[:, d, None, :KW]
        r2 = r2 + dd * dd
        dk = X[:, d, :KW] - xk[:, d, None]
        rk = rk + dk * dk
    return X, r2, rk


def _gram(xw, valid, kmap, nug, KW):
    """The masked Gram of the padded window: its lower triangle A (the
    diagonal g(0) + nug for a valid slot, 1 otherwise), the original
    diagonal and the border kni; the mask padded to KW."""
    N, _, kp1 = xw.shape
    k = kp1 - 1
    _, r2, rk = _pair_r2(xw, KW)
    vm = torch.zeros((N, KW), dtype=torch.bool)
    vm[:, :k] = valid != 0
    pm = vm[:, :, None] & vm[:, None, :]
    g0 = kmap.k_of_r2(xw.new_zeros(()))
    A = torch.tril(torch.where(pm, kmap.k_of_r2(r2), xw.new_zeros(())), -1)
    dg = torch.where(vm, g0 + nug, xw.new_ones(()))
    A = A + torch.diag_embed(dg)
    c = torch.where(vm, kmap.k_of_r2(rk), xw.new_zeros(()))
    return A, dg, c, vm


def _factor(A, dg, c, fsum):
    """The right-looking masked-column factor with w = L⁻¹c alongside; fsum
    loses each w_j² in the order of j."""
    KW = A.shape[-1]
    eps8 = 8.0 * torch.finfo(A.dtype).eps
    zero = A.new_zeros(())
    acc = torch.zeros_like(c)
    w = torch.zeros_like(c)
    live = torch.zeros_like(c, dtype=torch.bool)
    for j in range(KW):
        d_raw = A[:, j, j]
        fl = eps8 * dg[:, j].abs()
        lv = d_raw >= fl
        sq = torch.sqrt(torch.where(lv, d_raw, fl))
        l = A[:, j + 1:, j] * torch.where(lv, 1.0 / sq, zero)[:, None]
        A[:, j + 1:, j] = l
        A[:, j, j] = sq
        live[:, j] = lv
        w[:, j] = torch.where(lv, (c[:, j] - acc[:, j]) / sq, zero)
        fsum = fsum - w[:, j] * w[:, j]
        acc[:, j + 1:] += l * w[:, j, None]
        A[:, j + 1:, j + 1:] -= torch.tril(l[:, :, None] * l[:, None, :])
    return A, w, live, fsum


def _back_sub(L, y, live):
    """x = L⁻ᵀy by columns, each x_t a quotient by the pivot, dead 0."""
    x = torch.zeros_like(y)
    acc = torch.zeros_like(y)
    for t in reversed(range(y.shape[1])):
        x[:, t] = torch.where(live[:, t], (y[:, t] - acc[:, t]) / L[:, t, t], y.new_zeros(()))
        acc[:, :t] += L[:, t, :t] * x[:, t, None]
    return x


def _fwd_sub(L, y, live):
    """x = L⁻¹y by rows, each x_j a quotient by the pivot, dead 0."""
    x = torch.zeros_like(y)
    acc = torch.zeros_like(y)
    for j in range(y.shape[1]):
        x[:, j] = torch.where(live[:, j], (y[:, j] - acc[:, j]) / L[:, j, j], y.new_zeros(()))
        acc[:, j + 1:] += L[:, j + 1:, j] * x[:, j, None]
    return x


def _nug(nugget, like):
    return like.new_zeros(()) if nugget is None else like.new_tensor(nugget)


def emulate_band(xw, valid, kmap, nugget=None, nugget_self=True, kw=None):
    """``vecchia_band.cu``'s arithmetic in its order: (N, D, k+1) windows →
    (N, k+1) band rows."""
    N, _, kp1 = xw.shape
    k = kp1 - 1
    KW = kw or width(k)
    nug = _nug(nugget, xw)
    A, dg, c, _ = _gram(xw, valid, kmap, nug, KW)
    dk = kmap.k_of_r2(xw.new_zeros(())) + (nug if nugget_self else 0.0)
    L, w, live, F = _factor(A, dg, c, dk.expand(N).clone())
    fF = 8.0 * torch.finfo(xw.dtype).eps * dk.abs()
    u0 = 1.0 / torch.sqrt(torch.where(F >= fF, F, fF))
    b = _back_sub(L, w, live)
    return torch.cat([-b[:, :k] * u0[:, None], u0[:, None]], dim=1)


def emulate_band_bwd(xw, valid, kmap, gbar, nugget=None, nugget_self=True, kw=None):
    """``vecchia_band_bwd.cu``'s arithmetic in its order: the windows and the
    band's cotangent (N, k+1) → (x̄w (N, D, k+1), the nugget partials (N,))."""
    N, D, kp1 = xw.shape
    k = kp1 - 1
    KW = kw or width(k)
    nug = _nug(nugget, xw)
    zero = xw.new_zeros(())
    A, dg, c, vm = _gram(xw, valid, kmap, nug, KW)
    L, w, live, _ = _factor(A, dg, c, xw.new_zeros(N))
    b = _back_sub(L, w, live)
    kdiag = kmap.k_of_r2(zero) + (nug if nugget_self else 0.0)
    eps8 = 8.0 * torch.finfo(xw.dtype).eps
    F = kdiag - torch.sum(c * b, dim=1)
    F = torch.where(F >= eps8 * kdiag, F, eps8 * kdiag)
    u0 = 1.0 / torch.sqrt(F)
    gr = xw.new_zeros((N, KW))
    gr[:, :k] = gbar[:, :k]
    u0_bar = gbar[:, k] - torch.sum(gr * b, dim=1)
    F_bar = -0.5 * u0 * u0 * u0 * u0_bar
    bb = -u0[:, None] * gr - c * F_bar[:, None]
    S = _back_sub(L, _fwd_sub(L, bb, live), live)
    nbar = -torch.sum(torch.where(vm, S * b, zero), dim=1) + (F_bar if nugget_self else 0.0)
    kb = torch.where(vm, S - b * F_bar[:, None], zero)
    # step 7: each pair (i, j), j < i, once
    X, r2, rk = _pair_r2(xw, KW)
    lower = torch.tril(torch.ones((KW, KW), dtype=torch.bool), -1)
    on = vm[:, :, None] & vm[:, None, :] & lower
    gs = -0.5 * (S[:, :, None] * b[:, None, :] + S[:, None, :] * b[:, :, None])
    C = torch.where(on, 4.0 * kmap.dk_of_r2(r2) * gs, zero)
    ck = torch.where(vm, 4.0 * kmap.dk_of_r2(rk) * (0.5 * kb), zero)
    xbar = torch.zeros_like(xw)
    for d in range(D):
        diff = X[:, d, :KW, None] - X[:, d, None, :KW]  # x_i − x_j
        T = torch.where(on, C * diff, zero)
        row = torch.zeros_like(c)
        for j in range(KW):
            row = row + T[:, :, j]
        vk = ck * (X[:, d, :KW] - X[:, d, k, None])
        row = row + vk
        col = torch.zeros_like(c)
        for i in range(KW):
            col = col + T[:, i, :]
        xbar[:, d, :k] = (row - col)[:, :k]
        xbar[:, d, k] = -torch.sum(vk, dim=1)
    return xbar, nbar


# -- windows ------------------------------------------------------------------


def _windows(N, D, k, seed, dtype=torch.float64):
    """Previous-k windows (N, D, k+1) of points about a lengthscale apart and
    their (N, k) mask (numpy inputs), as ``chip_smoke.py`` phase 9 (a) builds
    them: the first k windows masked, every third repeating a neighbour in
    the next slot."""
    rng = np.random.default_rng(seed)
    X = (np.cumsum(rng.uniform(0.5, 1.5, (N, 1)), axis=0) if D == 1
         else rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D)))
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    if k >= 2:
        rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
        idx[rep, 1] = idx[rep, 0]
    pts = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1)
    xw = np.ascontiguousarray(pts.swapaxes(1, 2))
    return (torch.tensor(xw, dtype=dtype),
            torch.tensor((idx >= 0).astype(np.float64), dtype=dtype))


def _rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a)).double()
    b = torch.as_tensor(np.asarray(b)).double()
    return ((a - b).abs().max() / b.abs().max()).item()


# k on both sides of each width's edge and at the limits
KS = [1, 7, 8, 9, 16, 17, 32, 33, 64]


def _n(k):
    return 2 * k + 5  # past the k masked windows; odd, so ragged against every block


@pytest.mark.parametrize("k", KS)
def test_torch_vecchia_band_warp_order_f64(k):
    """The band kernel's order of operations against its plain version (the
    bordered factorization) in f64, four maps, no nugget and a nugget with
    and without slot k; deflated pivots; masked slots exactly 0."""
    D = 1 + k % 3
    xw, valid = _windows(_n(k), D, k, seed=k)
    live = tb._masked_chol_factor(tb.window_gram_inputs(xw, valid, _kmap("se"))[0])[1]
    assert k == 1 or bool((live == 0).any())  # some pivots deflate
    for name in MAPS:
        for nugget, self_ in NUGGETS:
            nug = None if nugget is None else torch.tensor([nugget], dtype=torch.float64)
            got = emulate_band(xw, valid, _kmap(name), nugget, self_)
            want = tb.vecchia_band_plain(xw, valid, _kmap(name), nug, self_)
            assert _rel(got, want) <= 1e-12, (name, nugget, self_)
            assert bool((got[:, :k][valid == 0] == 0).all())


@pytest.mark.parametrize("k", KS)
def test_torch_vecchia_band_bwd_warp_order_f64(k):
    """The pullback kernel's order of operations against its plain version
    (the recompute pullback) in f64: x̄w and each window's nugget partial,
    four maps, no nugget and a nugget with and without slot k; masked slots
    of x̄w exactly 0."""
    D = 1 + k % 3
    N = _n(k)
    xw, valid = _windows(N, D, k, seed=50 + k)
    g = torch.tensor(np.random.default_rng(k).standard_normal((N, k + 1)))
    for name in MAPS:
        for nugget, self_ in NUGGETS:
            nug = None if nugget is None else torch.tensor([nugget], dtype=torch.float64)
            got_x, got_p = emulate_band_bwd(xw, valid, _kmap(name), g, nugget, self_)
            ref_x, ref_p = tb._recompute_pullback(xw, valid, _kmap(name), nug, self_, g, True,
                                                  nug is not None)
            assert _rel(got_x, ref_x) <= 1e-10, (name, nugget, self_)
            if nug is not None:
                assert _rel(got_p, ref_p) <= 1e-10, (name, nugget, self_)
            assert bool((got_x[:, :, :k].transpose(1, 2)[valid == 0] == 0).all())


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_vecchia_band_warp_matches_pallas_rows_8_and_10(name):
    """The band emulation against rows 8 (``pallas_vecchia_band_lanes``, a
    nugget with and without slot k) and 10 (``pallas_vecchia_band_lanes_t``,
    the transposed windows) in interpret mode, N = 37, k = 7."""
    xw, valid = _windows(37, 2, 7, seed=len(name))
    fn = MAPS[name][0].k_of_r2
    jx, jv = jnp.asarray(xw.numpy()), jnp.asarray(valid.numpy())
    for nugget, self_ in NUGGETS:
        kw = {} if nugget is None else {"nugget": jnp.asarray(nugget)}
        got = emulate_band(xw, valid, _kmap(name), nugget, self_)
        assert _rel(got, jb.pallas_vecchia_band_lanes(jx, jv, fn, nugget_self=self_, **kw)) \
            <= 1e-12, (nugget, self_)
        if self_:
            ref_t = jb.pallas_vecchia_band_lanes_t(jnp.transpose(jx, (1, 2, 0)), jv.T, fn, **kw)
            assert _rel(got, ref_t) <= 1e-12, nugget


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_vecchia_band_bwd_warp_matches_pallas_row_9(name):
    """The pullback emulation against row 9 in interpret mode (the backward of
    ``pallas_vecchia_band_lanes_t`` and of ``pallas_vecchia_band_lanes``
    with the nugget off slot k): x̄w and the nugget's cotangent, N = 32,
    k = 6."""
    N, k = 32, 6
    xw, valid = _windows(N, 2, k, seed=7 + len(name))
    g = np.random.default_rng(3).standard_normal((N, k + 1))
    fn = MAPS[name][0].k_of_r2
    jx, jv = jnp.asarray(xw.numpy()), jnp.asarray(valid.numpy())
    for self_ in (True, False):
        if self_:
            f = lambda w, n: jb.pallas_vecchia_band_lanes_t(  # noqa: E731
                jnp.transpose(w, (1, 2, 0)), jv.T, fn, nugget=n)
        else:
            f = lambda w, n: jb.pallas_vecchia_band_lanes(  # noqa: E731
                w, jv, fn, nugget=n, nugget_self=False)
        _, vjp = jax.vjp(f, jx, jnp.asarray(0.04))
        ref_x, ref_n = vjp(jnp.asarray(g))
        got_x, got_p = emulate_band_bwd(xw, valid, _kmap(name), torch.tensor(g), 0.04, self_)
        assert _rel(got_x, ref_x) <= 1e-10, self_
        assert abs(got_p.sum().item() - float(ref_n)) <= 1e-10 * got_p.abs().sum().item()


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_vecchia_band_warp_f32_within_the_chip_limits(name):
    """The f32 emulations against the plain versions in f64 on the same
    (f32) windows, k = 32, D = 1 and 2, no nugget and a nugget with and
    without slot k: the band within ``BAND_RTOL32``, x̄w within
    ``BWD_XW_RTOL32``, the nugget partials within ``BWD_NUG_RTOL32``."""
    kmap = _kmap(name)
    for D, N in ((1, 301), (2, 99)):
        xw32, v32 = _windows(N, D, 32, seed=D, dtype=torch.float32)
        xw, valid = xw32.double(), v32.double()
        g32 = torch.tensor(np.random.default_rng(D).standard_normal((N, 33)), dtype=torch.float32)
        for nugget, self_ in NUGGETS:
            nug = None if nugget is None else torch.tensor([nugget], dtype=torch.float64)
            got = emulate_band(xw32, v32, kmap, nugget, self_)
            assert got.dtype == torch.float32
            assert _rel(got, tb.vecchia_band_plain(xw, valid, kmap, nug, self_)) <= BAND_RTOL32
            assert bool((got[:, :32][v32 == 0] == 0).all())
            got_x, got_p = emulate_band_bwd(xw32, v32, kmap, g32, nugget, self_)
            ref_x, ref_p = tb._recompute_pullback(xw, valid, kmap, nug, self_, g32.double(), True,
                                                  nug is not None)
            assert _rel(got_x, ref_x) <= BWD_XW_RTOL32, (D, nugget, self_)
            if nug is not None:
                assert _rel(got_p, ref_p) <= BWD_NUG_RTOL32, (D, nugget, self_)


@pytest.mark.parametrize("k", [1, 7, 20])
def test_torch_vecchia_band_warp_padding_changes_nothing(k):
    """The identity rows a window is padded with couple to nothing: the
    kernels' width and the widest one give the same band and pullback."""
    N = 29
    xw, valid = _windows(N, 2, k, seed=200 + k)
    g = torch.tensor(np.random.default_rng(k).standard_normal((N, k + 1)))
    kmap = _kmap("m52")
    assert _rel(emulate_band(xw, valid, kmap, 0.1, False),
                emulate_band(xw, valid, kmap, 0.1, False, kw=64)) <= 1e-14
    (x1, p1), (x2, p2) = (emulate_band_bwd(xw, valid, kmap, g, 0.1, True, kw=kw)
                          for kw in (None, 64))
    assert _rel(x1, x2) <= 1e-14 and _rel(p1, p2) <= 1e-14
    assert [width(kk) for kk in (1, 8, 9, 16, 17, 32, 33, 64)] == [8, 8, 16, 16, 32, 32, 64, 64]
