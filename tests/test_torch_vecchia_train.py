"""The Vecchia training slice on the CPU in f64 against the JAX package: the
white, constant and sum kernels and the nugget unwrap; the band Function's
pullback (row 9's contract) with a nugget; ``approx_lml`` values and
θ-gradients of the noisy-data model on both routes; the host-side orderings
(the port's own g++ build and its numpy versions); the maximin / random
orderings with previous / nearest / scaled neighbours; and ``adam_fit``.

The kernel route (``use_kernels=True``: on a CPU tensor the band Function
with its plain inner passes, the bordered Cholesky forward and the recompute
pullback) is held against the JAX package's fused tier (``use_pallas=True``,
rows 8, 9 and 10 in interpret mode); the plain route against its XLA path.

Tolerances, relative to each array's largest entry: Grams, values and
posteriors 1e-12, gradients 1e-10 (the two packages sum in other orders, and
the bordered and masked factorizations round differently), three Adam steps
1e-8 (Adam divides by √v̂ + ε, which amplifies a gradient's rounding where
an entry is small).  Interpret-mode calls stay at N ≤ 256 and k ≤ 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.models import vecchia as jv
from approximategps_tpu.native import ordering as jord
from approximategps_tpu.ops import batched_chol as jb
from approximategps_tpu.utils.training import adam_fit as jax_adam_fit
import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.native import ordering as tord
from approximategps_tpu_torch.ops import batched_chol as tb

torch.set_num_threads(1)

THETA = np.array([0.55, 0.55, 0.02])  # bench.py::vecchia_nugget_lml_grad's raw θ


def _rel(t, j) -> float:
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _jax_nugget_fx(theta, x):
    sp = jax.nn.softplus
    kern = (sp(theta[0]) * agp.with_lengthscale(agp.Matern32Kernel(), sp(theta[1]))
            + sp(theta[2]) * agp.WhiteKernel())
    return agp.GP(kern)(x, 0.0)


def _data(N, D, seed):
    """Distinct sites about a lengthscale apart, as the bench spaces them."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0.0, 0.8 * N, N)) if D == 1 else rng.uniform(0.0, 6.0, (N, D))
    y = np.sin(X if D == 1 else X[:, 0]) + 0.1 * rng.standard_normal(N)
    return X, y


# -- kernels -----------------------------------------------------------------

_KERNELS = {
    "white": (lambda m: m.WhiteKernel()),
    "constant": (lambda m: m.ConstantKernel(0.7)),
    "sum_white": (lambda m: 1.3 * m.with_lengthscale(m.Matern32Kernel(), 0.8)
                  + 0.05 * m.WhiteKernel()),
    "sum_number": (lambda m: m.SqExponentialKernel() + 2.0),
    "number_sum": (lambda m: 2.0 + m.Matern52Kernel()),
    "scaled_sum": (lambda m: 0.5 * (m.Matern12Kernel() + 0.1 * m.WhiteKernel())),
}


@pytest.mark.parametrize("name", list(_KERNELS))
def test_torch_white_constant_sum_kernels_match_jax(name):
    """gram(X), gram(X, Z) and diag(X) against the JAX package; Z shares
    three points with X, which the two-argument white finds by value."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0.0, 3.0, (9, 2))
    Z = np.concatenate([X[[1, 4, 7]], rng.uniform(0.0, 3.0, (4, 2))])
    kt, kj = _KERNELS[name](tk), _KERNELS[name](agp)
    Xt, Zt = torch.tensor(X), torch.tensor(Z)
    assert _rel(kt.gram(Xt), kj.gram(jnp.asarray(X))) <= 1e-12
    assert _rel(kt.gram(Xt, Zt), kj.gram(jnp.asarray(X), jnp.asarray(Z))) <= 1e-12
    assert _rel(kt.diag(Xt), kj.diag(jnp.asarray(X))) <= 1e-12
    if name == "white":
        assert torch.equal(kt.gram(Xt, Zt)[[1, 4, 7], [0, 1, 2]], torch.ones(3, dtype=Xt.dtype))
        assert float(kt.gram(Xt, Zt).sum()) == 3.0


_UNWRAP = {
    "sigma_k_plus_tau_white": (lambda m: 1.7 * m.with_lengthscale(m.Matern32Kernel(), 0.6)
                               + 0.03 * m.WhiteKernel()),
    "white_plus_k": (lambda m: m.WhiteKernel() + m.SqExponentialKernel()),
    "outer_factor": (lambda m: 2.0 * (m.Matern52Kernel() + 0.1 * m.WhiteKernel())),
    "nested_scales": (lambda m: 3.0 * m.with_lengthscale(
        2.0 * (1.5 * m.with_lengthscale(m.Matern12Kernel(), 0.5) + 0.2 * m.WhiteKernel()), 2.0)),
    "no_white": (lambda m: 1.2 * m.with_lengthscale(m.SqExponentialKernel(), 0.3)),
    "two_stationary": (lambda m: m.SqExponentialKernel() + m.Matern32Kernel()),
    "white_plus_number": (lambda m: m.WhiteKernel() + 1.0),
}


@pytest.mark.parametrize("name", list(_UNWRAP))
def test_torch_unwrap_stationary_nugget_matches_jax(name):
    """The map, input scale, variance and nugget of each form against the
    JAX package's ``unwrap_stationary_nugget``; sums that do not unwrap
    give None in both."""
    got = tk.unwrap_stationary_nugget(_UNWRAP[name](tk))
    ref = jk.unwrap_stationary_nugget(_UNWRAP[name](agp))
    assert (got is None) == (ref is None)
    if ref is None:
        return
    r2 = np.linspace(0.0, 4.0, 9)
    assert _rel(got[0].k_of_r2(torch.tensor(r2)), ref[0](jnp.asarray(r2))) <= 1e-14
    for g, r in zip(got[1:], ref[1:]):
        assert (g is None) == (r is None)
        if r is not None:
            assert abs(float(g) - float(r)) <= 1e-14 * abs(float(r))


def test_torch_build_vecchia_nugget_fx_matches_jax():
    x, _ = _data(25, 1, 2)
    fx = convert.build_vecchia_nugget_fx(
        convert.from_jax_params(THETA, device="cpu", dtype=torch.float64), torch.tensor(x))
    fj = _jax_nugget_fx(jnp.asarray(THETA), jnp.asarray(x))
    assert _rel(fx.cov(), fj.cov()) <= 1e-13
    assert float(fx.noise) == 0.0


# -- the band Function's pullback (row 9's contract) ---------------------------

_MAPS = {
    "se": (agp.SqExponentialKernel, tk.SqExponentialKernel),
    "m12": (agp.Matern12Kernel, tk.Matern12Kernel),
    "m32": (agp.Matern32Kernel, tk.Matern32Kernel),
    "m52": (agp.Matern52Kernel, tk.Matern52Kernel),
}


def _windows_t(N, D, k, seed):
    """Previous-k windows in row 10's (D, k+1, N) layout and their (k, N)
    mask; every third window repeats a neighbour in the next slot (a
    deflated pivot), and the first k windows have masked slots."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D))
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
    idx[rep, 1] = idx[rep, 0]
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1)  # (N, k+1, D)
    return np.ascontiguousarray(xw.transpose(2, 1, 0)), (idx >= 0).astype(np.float64).T.copy()


@pytest.mark.parametrize("name", list(_MAPS))
def test_torch_band_t_pullback_with_nugget_matches_row9(name):
    """Row 10's layout with a nugget: x̄w, in the (D, k+1, N) layout it came
    in, and the nugget's cotangent against the JAX custom VJP of
    ``pallas_vecchia_band_lanes_t``, whose backward is row 9 in interpret
    mode."""
    xwT, validT = _windows_t(40, 2, 6, seed=len(name))
    g = np.random.default_rng(3).standard_normal((40, 7))
    fn = _MAPS[name][0].k_of_r2
    _, vjp = jax.vjp(lambda w, n: jb.pallas_vecchia_band_lanes_t(w, jnp.asarray(validT), fn,
                                                                 nugget=n),
                     jnp.asarray(xwT), jnp.asarray(0.04))
    ref_w, ref_n = vjp(jnp.asarray(g))
    w = torch.tensor(xwT, requires_grad=True)
    nug = torch.tensor(0.04, dtype=torch.float64, requires_grad=True)
    out = tb.vecchia_band_t(w, torch.tensor(validT), _MAPS[name][1]().kernel_map(), nug)
    got_w, got_n = torch.autograd.grad(out, (w, nug), torch.tensor(g))
    assert got_w.shape == w.shape
    assert _rel(got_w, ref_w) <= 1e-10
    assert abs(got_n.item() - float(ref_n)) <= 1e-10 * abs(float(ref_n))


@pytest.mark.parametrize("nugget_self", [True, False], ids=["self", "noself"])
def test_torch_pullback_per_window_nugget_partials_match_row9(nugget_self):
    """Each window's share of the nugget's cotangent (``per_window``) in row
    8's layout against row 9 in interpret mode given that window's
    cotangent alone (the pullback is linear in it), 1e-10 relative to the
    largest share; the default return is their sum."""
    N, k = 12, 4
    xwT, validT = _windows_t(N, 2, k, seed=21)
    xw, valid = np.ascontiguousarray(xwT.transpose(2, 0, 1)), validT.T.copy()
    g = np.random.default_rng(5).standard_normal((N, k + 1))
    fn = _MAPS["m32"][0].k_of_r2
    _, vjp = jax.vjp(lambda n: jb.pallas_vecchia_band_lanes(
        jnp.asarray(xw), jnp.asarray(valid), fn, nugget=n, nugget_self=nugget_self),
        jnp.asarray(0.05))
    ref = np.array([float(vjp(jnp.asarray(g * (np.arange(N) == i)[:, None]))[0])
                    for i in range(N)])
    args = (torch.tensor(xw), torch.tensor(valid), tk.Matern32Kernel().kernel_map(),
            torch.tensor(g), 0.05, nugget_self)
    _, parts = tb.vecchia_band_bwd(*args, per_window=True)
    _, total = tb.vecchia_band_bwd(*args)
    assert parts.shape == (N,)
    assert _rel(parts, ref) <= 1e-10
    assert torch.equal(total, parts.sum().reshape(1))


def test_torch_band_nugget_gradient_with_the_points_fixed():
    """The nugget's gradient alone (no gradient in the points), the nugget
    off slot k, where only Kw depends on it: the same as with the points'
    gradient taken too."""
    xwT, validT = _windows_t(30, 2, 5, seed=13)
    xw, valid = torch.tensor(xwT).permute(2, 0, 1), torch.tensor(validT).T
    g = torch.tensor(np.random.default_rng(6).standard_normal((30, 6)))
    kmap = tk.Matern52Kernel().kernel_map()
    nug = torch.tensor(0.07, dtype=torch.float64, requires_grad=True)
    (alone,) = torch.autograd.grad(tb.vecchia_band(xw, valid, kmap, nug, False), nug, g)
    w = xw.detach().requires_grad_()
    _, both = torch.autograd.grad(tb.vecchia_band(w, valid, kmap, nug, False), (w, nug), g)
    assert abs(alone.item() - both.item()) <= 1e-14 * abs(both.item())


def test_torch_vecchia_band_bwd_is_the_functions_pullback():
    """The pullback on its own equals the Function's, nugget or none; on CPU
    tensors it is the plain version and counts no launch."""
    xwT, validT = _windows_t(30, 1, 5, seed=9)
    xw, valid = torch.tensor(xwT).permute(2, 0, 1), torch.tensor(validT).T
    g = torch.tensor(np.random.default_rng(4).standard_normal((30, 6)))
    kmap = tk.Matern32Kernel().kernel_map()
    before = tb.vecchia_band_bwd.launches
    for nugget in (None, 0.1):
        w = xw.detach().requires_grad_()
        nug = None if nugget is None else torch.tensor(nugget, dtype=torch.float64,
                                                        requires_grad=True)
        out = tb.vecchia_band(w, valid, kmap, nug)
        grads = torch.autograd.grad(out, [w] + ([] if nug is None else [nug]), g)
        xw_bar, nug_bar = tb.vecchia_band_bwd(xw, valid, kmap, g, nugget)
        assert torch.equal(xw_bar, grads[0])
        assert (nug_bar is None) == (nugget is None)
        if nugget is not None:
            assert torch.equal(nug_bar.reshape(()), grads[1])
    assert tb.vecchia_band_bwd.launches == before


# -- approx_lml of the noisy-data model ----------------------------------------


@pytest.mark.parametrize("use", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("D", [1, 2])
def test_torch_nugget_approx_lml_and_grad_match_jax(D, use):
    """σ²·Matérn-3/2(ℓ) + τ²·White on distinct sites: the value and all three
    θ-gradient entries against the JAX package's matching route (the kernel
    route rides the nugget, the plain route the white term's Grams)."""
    x, y = _data(70, D, 10 + D)
    nn_t, nn_j = tgp.NearestNeighbors(6, use_kernels=use), agp.NearestNeighbors(6, use_pallas=use)
    jval, jgrad = jax.value_and_grad(
        lambda th: agp.approx_lml(nn_j, _jax_nugget_fx(th, jnp.asarray(x)), jnp.asarray(y)))(
        jnp.asarray(THETA))
    th = torch.tensor(THETA, requires_grad=True)
    tval = tgp.approx_lml(nn_t, convert.build_vecchia_nugget_fx(th, torch.tensor(x)),
                          torch.tensor(y))
    (tgrad,) = torch.autograd.grad(tval, th)
    assert abs(tval.item() - float(jval)) <= 1e-12 * abs(float(jval))
    assert _rel(tgrad, jgrad) <= 1e-10
    assert float(tgrad[2].abs()) > 0.0


def test_torch_nugget_duplicated_sites_pin_the_tier_difference():
    """With duplicated sites in one window the kernel route (the nugget on the
    index diagonal: iid noise on each observation) and the plain route (the
    value-equality white of the cross-covariance column, which makes the
    duplicate's conditional variance 0, floored) differ by design; the
    kernel route still matches the JAX package's fused tier, and on the same
    sites made distinct the two routes agree."""
    x, y = _data(40, 1, 14)
    x[11] = x[10]
    x[25] = x[24]
    nn = agp.NearestNeighbors(5, use_pallas=True)
    jval = float(agp.approx_lml(nn, _jax_nugget_fx(jnp.asarray(THETA), jnp.asarray(x)),
                                jnp.asarray(y)))
    fx = convert.build_vecchia_nugget_fx(torch.tensor(THETA), torch.tensor(x))
    fused = tgp.approx_lml(tgp.NearestNeighbors(5, use_kernels=True), fx, torch.tensor(y)).item()
    plain = tgp.approx_lml(tgp.NearestNeighbors(5, use_kernels=False), fx, torch.tensor(y)).item()
    assert abs(fused - jval) <= 1e-12 * abs(jval)
    assert abs(plain - fused) > 1.0
    x[11] += 1e-3
    x[25] += 1e-3
    fx = convert.build_vecchia_nugget_fx(torch.tensor(THETA), torch.tensor(x))
    fused = tgp.approx_lml(tgp.NearestNeighbors(5, use_kernels=True), fx, torch.tensor(y)).item()
    plain = tgp.approx_lml(tgp.NearestNeighbors(5, use_kernels=False), fx, torch.tensor(y)).item()
    assert abs(plain - fused) <= 1e-10 * abs(fused)


# -- host-side orderings -------------------------------------------------------


@pytest.fixture(params=["gxx", "numpy"])
def ordering_backend(request, monkeypatch):
    """The port's ordering functions through its g++ build, or through the
    numpy versions (as where no compiler is found)."""
    if request.param == "numpy":
        monkeypatch.setattr(tord, "_load", lambda: None)
    else:
        assert tord.native_available()
    return request.param


def test_torch_ordering_build_failure_warns(tmp_path, monkeypatch):
    """A source g++ cannot build gives no library and says so once."""
    bad = tmp_path / "vecchia_order.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tord, "_SRC", bad)
    monkeypatch.setattr(tord, "_BUILD_DIR", tmp_path / "_build")
    with pytest.warns(RuntimeWarning, match="numpy versions"):
        assert tord._build() is None


@pytest.mark.parametrize("N,D", [(300, 2), (2500, 2), (200, 5)])
def test_torch_orderings_match_jax(N, D, ordering_backend):
    """maximin, nearest and scaled (ρ = 3) equal the JAX package's on random
    points; N = 2500 in 2-D takes the grid paths of the C++ code."""
    X = np.random.default_rng(N + D).uniform(0.0, 1.0, (N, D))
    order = jord.maximin_ordering(X)
    np.testing.assert_array_equal(tgp.maximin_ordering(X), order)
    np.testing.assert_array_equal(tgp.nearest_predecessor_neighbors(X, order, 8),
                                  jord.nearest_predecessor_neighbors(X, order, 8))
    np.testing.assert_array_equal(tgp.scaled_ball_predecessors(X, order, 3.0, 8),
                                  jord.scaled_ball_predecessors(X, order, 3.0, 8))


def test_torch_resolve_ordering_matches_jax():
    X = np.random.default_rng(5).uniform(0.0, 1.0, (50, 2))
    for ordering in ("natural", "maximin", "random"):
        np.testing.assert_array_equal(tgp.resolve_ordering(torch.tensor(X), ordering),
                                      jv.resolve_ordering(jnp.asarray(X), ordering))
    with pytest.raises(ValueError, match="unknown ordering"):
        tgp.resolve_ordering(torch.tensor(X), "hilbert")


@pytest.mark.parametrize("use", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("neighbors", ["previous", "nearest", "scaled"])
@pytest.mark.parametrize("ordering", ["maximin", "random"])
def test_torch_general_orderings_match_jax(ordering, neighbors, use):
    """``approx_lml`` (value and θ-gradient) and the posterior's
    ``mean_and_var`` of the noisy-data model under each ordering and
    neighbour set, against the JAX package's matching route (the kernel
    route gathers windows in row 8's layout, nugget included)."""
    x, y = _data(80, 2, 20)
    xs = np.random.default_rng(21).uniform(0.0, 6.0, (9, 2))
    kw = dict(ordering=ordering, neighbors=neighbors, rho=2.5)
    nn_t, nn_j = tgp.NearestNeighbors(6, use_kernels=use, **kw), \
        agp.NearestNeighbors(6, use_pallas=use, **kw)
    jval, jgrad = jax.value_and_grad(
        lambda th: agp.approx_lml(nn_j, _jax_nugget_fx(th, jnp.asarray(x)), jnp.asarray(y)))(
        jnp.asarray(THETA))
    th = torch.tensor(THETA, requires_grad=True)
    tval = tgp.approx_lml(nn_t, convert.build_vecchia_nugget_fx(th, torch.tensor(x)),
                          torch.tensor(y))
    (tgrad,) = torch.autograd.grad(tval, th)
    assert abs(tval.item() - float(jval)) <= 1e-12 * abs(float(jval))
    assert _rel(tgrad, jgrad) <= 1e-10
    jmu, jvar = agp.posterior(nn_j, _jax_nugget_fx(jnp.asarray(THETA), jnp.asarray(x)),
                              jnp.asarray(y)).mean_and_var(jnp.asarray(xs))
    with torch.no_grad():
        fx = convert.build_vecchia_nugget_fx(torch.tensor(THETA), torch.tensor(x))
        tmu, tvar = tgp.posterior(nn_t, fx, torch.tensor(y)).mean_and_var(torch.tensor(xs))
    assert _rel(tmu, jmu) <= 1e-12 and _rel(tvar, jvar) <= 1e-12


def test_torch_adam_fit_matches_jax_optimiser():
    """Three Adam steps (lr 1e-2) on −``approx_lml`` of the noisy-data model,
    kernel route against the JAX package's ``adam_fit`` (optax) on its fused
    tier: the losses and θ after each step."""
    x, y = _data(60, 1, 30)
    nn_t, nn_j = tgp.NearestNeighbors(5, use_kernels=True), agp.NearestNeighbors(5, use_pallas=True)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jparams, jlosses = jax_adam_fit(
        lambda p, xb, yb: -agp.approx_lml(nn_j, _jax_nugget_fx(p["theta"], xb), yb),
        {"theta": jnp.asarray(THETA)}, [(xj, yj)] * 3, learning_rate=1e-2)
    xt, yt = torch.tensor(x), torch.tensor(y)
    params, losses = tgp.adam_fit(
        lambda p, xb, yb: -tgp.approx_lml(nn_t, convert.build_vecchia_nugget_fx(p["theta"], xb),
                                          yb),
        {"theta": torch.tensor(THETA)}, [(xt, yt)] * 3, learning_rate=1e-2)
    assert len(losses) == 3
    assert _rel(torch.stack(losses), np.asarray(jlosses)) <= 1e-8
    assert _rel(params["theta"], jparams["theta"]) <= 1e-8
