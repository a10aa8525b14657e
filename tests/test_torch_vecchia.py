"""The Vecchia serving slice (``models/vecchia.py``) on the CPU in f64 against
the JAX package: the banded and sparse precision roots, ``approx_lml``, the
posterior's ``mean_and_var`` and ``predict_knn``, on both routes.

The kernel route (``use_kernels=True``; on a CPU tensor the band Function
with its plain inner pass) is held against the JAX package's fused tier
(``use_pallas=True``, Pallas in interpret mode); the plain route (auto on the
CPU) against its XLA path.  At full conditioning both match the exact GP.
Each place where the kernel declines runs the plain path, which a spy on
the band Function's inner pass shows.

Tolerances: roots, values, means and variances 1e-12 relative to the largest
entry (1e-10 for gradients); the exact GP 1e-8 (conditioning on all points
is exact, up to the floors and the Cholesky's rounding).  Interpret-mode
calls stay at N ≤ 256 and k ≤ 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.models import vecchia as jv
import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.models import vecchia as tv
from approximategps_tpu_torch.ops import batched_chol as tb

torch.set_num_threads(1)

THETA = np.array([0.4, -0.2, np.log(np.expm1(0.05))])  # raw (variance, lengthscale, noise)


def _rel(t, j) -> float:
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _jax_fx(theta, x):
    kern = jax.nn.softplus(theta[0]) * agp.with_lengthscale(agp.Matern32Kernel(),
                                                            jax.nn.softplus(theta[1]))
    return agp.GP(kern)(x, jax.nn.softplus(theta[2]))


def _torch_fx(theta, x):
    return convert.build_vecchia_fx(
        convert.from_jax_params(theta, device="cpu", dtype=torch.float64), torch.tensor(x))


@pytest.fixture
def spy(monkeypatch):
    """Counts the band Function's inner passes (the kernel route)."""
    calls = []
    real = tb.vecchia_band_pass
    monkeypatch.setattr(tb, "vecchia_band_pass", lambda *a: calls.append(1) or real(*a))
    return calls


def _data(N, D, seed):
    rng = np.random.default_rng(seed)
    # about a lengthscale apart, as the bench spaces its points
    X = np.sort(rng.uniform(0.0, 0.6 * N, N)) if D == 1 else rng.uniform(0.0, 6.0, (N, D))
    y = np.sin(X if D == 1 else X[:, 0]) + 0.1 * rng.standard_normal(N)
    return X, y


def test_torch_build_vecchia_fx_matches_jax():
    x, _ = _data(20, 1, 0)
    fx_t, fx_j = _torch_fx(THETA, x), _jax_fx(jnp.asarray(THETA), jnp.asarray(x))
    assert _rel(fx_t.cov(), fx_j.cov()) <= 1e-13
    assert abs(float(fx_t.noise) - float(fx_j.noise)) <= 1e-15
    # θ₂ = −inf gives noise 0
    fx0 = convert.build_vecchia_fx(torch.tensor([0.5, 0.5, -np.inf]), torch.zeros(3))
    assert float(fx0.noise) == 0.0


def test_torch_unwrap_stationary_bare_and_scaled():
    """A bare map unwraps with no scale and no variance; the scaled forms
    give theirs; ``diag`` covers each kernel ``predict_knn`` reads."""
    kmap, scale, variance = tk.unwrap_stationary(tk.Matern32Kernel())
    assert kmap.id == tk.KernelMapId.MATERN32 and scale is None and variance is None
    kern = 2.0 * tk.with_lengthscale(tk.SqExponentialKernel(), 0.5)
    kmap, scale, variance = tk.unwrap_stationary(kern)
    assert kmap.id == tk.KernelMapId.SE and float(scale) == 2.0 and float(variance) == 2.0
    X = torch.rand((5, 2), dtype=torch.float64)
    for k in (tk.Matern32Kernel(), kern, tk.with_lengthscale(tk.Matern52Kernel(), 3.0)):
        torch.testing.assert_close(k.diag(X), torch.diagonal(k.gram(X)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("D", [1, 3])
def test_torch_approx_root_prec_band_matches_jax(D, use, spy):
    """The band on both routes against the JAX package's matching route, at
    D = 1 (row 10's previous-k windows) and D = 3; the out-of-range slots
    of the first k rows hold exactly 0."""
    x, _ = _data(70, D, D)
    k = 6
    fx_t, fx_j = _torch_fx(THETA, x), _jax_fx(jnp.asarray(THETA), jnp.asarray(x))
    ref = jv.approx_root_prec_band(jnp.asarray(x), k, fx_j.f.kernel, use_pallas=bool(use))
    got = tv.approx_root_prec_band(torch.tensor(x), k, fx_t.f.kernel, use_kernels=use)
    assert _rel(got, ref) <= 1e-12
    assert len(spy) == (1 if use else 0)
    out_of_range = torch.arange(k)[:, None] + torch.arange(k)[None, :] < k  # i − k + t < 0
    assert bool((got[:k, :k][out_of_range] == 0).all())
    blocked = tv.approx_root_prec_band(torch.tensor(x), k, fx_t.f.kernel, block_size=16,
                                       use_kernels=False)
    assert _rel(blocked, ref) <= 1e-12


def test_torch_band_ops_match_dense():
    rng = np.random.default_rng(2)
    N, k = 11, 3
    band = rng.standard_normal((N, k + 1))
    for i in range(k):
        band[i, :k - i] = 0.0
    U = np.zeros((N, N))
    for i in range(N):
        for t in range(k + 1):
            if i - k + t >= 0:
                U[i - k + t, i] = band[i, t]
    v, X = rng.standard_normal(N), rng.standard_normal((N, 4))
    tband = torch.tensor(band)
    np.testing.assert_allclose(tv.band_Ut_matmul(tband, torch.tensor(v)), U.T @ v, atol=1e-13)
    np.testing.assert_allclose(tv.band_Ut_matmul(tband, torch.tensor(X)), U.T @ X, atol=1e-13)
    np.testing.assert_allclose(tv.band_U_matvec(tband, torch.tensor(v)), U @ v, atol=1e-13)


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
def test_torch_approx_root_prec_sparse_matches_jax(use, spy):
    """Random predecessor sets (−1 padded), gathered windows in row 8's
    layout without a nugget; the root's whiten, U-product and logdet."""
    x, _ = _data(60, 2, 5)
    N, k = 60, 5
    rng = np.random.default_rng(6)
    offs = np.sort(rng.integers(1, 1 << 30, size=(N, k)) % np.maximum(np.arange(N)[:, None], 1),
                   axis=1)
    nbr = np.where(np.arange(N)[:, None] > np.arange(k)[None, :],
                   np.maximum(np.arange(N)[:, None] - 1 - offs, 0), -1)
    fx_t, fx_j = _torch_fx(THETA, x), _jax_fx(jnp.asarray(THETA), jnp.asarray(x))
    ref = jv.approx_root_prec_sparse(jnp.asarray(x), jnp.asarray(nbr), fx_j.f.kernel,
                                     use_pallas=bool(use))
    got = tv.approx_root_prec_sparse(torch.tensor(x), nbr, fx_t.f.kernel, use_kernels=use)
    assert len(spy) == (1 if use else 0)
    assert _rel(got.coeff, ref.coeff) <= 1e-12 and _rel(got.diag, ref.diag) <= 1e-12
    v = rng.standard_normal(N)
    assert _rel(got.whiten(torch.tensor(v)), ref.whiten(jnp.asarray(v))) <= 1e-12
    assert _rel(got.u_matvec(torch.tensor(v)), ref.u_matvec(jnp.asarray(v))) <= 1e-12
    assert abs(got.logdet().item() - float(ref.logdet())) <= 1e-12 * abs(float(ref.logdet()))


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
def test_torch_approx_lml_and_posterior_match_jax(use, spy):
    """``approx_lml`` (value and θ-gradient) and the posterior's
    ``mean_and_var`` against the JAX package's matching route."""
    x, y = _data(80, 1, 7)
    xs = np.linspace(0.0, 48.0, 13)
    nn_t = tgp.NearestNeighbors(7, use_kernels=use)
    nn_j = agp.NearestNeighbors(7, use_pallas=bool(use))
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda th: agp.approx_lml(nn_j, _jax_fx(th, jnp.asarray(x)), jnp.asarray(y))))(
        jnp.asarray(THETA))
    th = torch.tensor(THETA, requires_grad=True)
    fx = convert.build_vecchia_fx(th, torch.tensor(x))
    tval = tgp.approx_lml(nn_t, fx, torch.tensor(y))
    (tgrad,) = torch.autograd.grad(tval, th)
    assert len(spy) == (1 if use else 0)
    assert abs(tval.item() - float(jval)) <= 1e-12 * abs(float(jval))
    assert _rel(tgrad[:2], jgrad[:2]) <= 1e-10  # the root ignores the noise
    jmu, jvar = agp.posterior(nn_j, _jax_fx(jnp.asarray(THETA), jnp.asarray(x)),
                              jnp.asarray(y)).mean_and_var(jnp.asarray(xs))
    with torch.no_grad():
        tmu, tvar = tgp.posterior(nn_t, _torch_fx(THETA, x), torch.tensor(y)).mean_and_var(
            torch.tensor(xs))
    assert _rel(tmu, jmu) <= 1e-12 and _rel(tvar, jvar) <= 1e-12


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
def test_torch_full_conditioning_matches_exact_gp(use):
    """k = N − 1 conditions every point on all before it: ``approx_lml`` is
    the exact ``logpdf`` (noise 0; the root ignores noise) and the
    posterior the exact one."""
    x, y = _data(30, 2, 8)
    theta = THETA.copy()
    theta[2] = -np.inf
    fx = _torch_fx(theta, x)
    nn = tgp.NearestNeighbors(29, use_kernels=use)
    exact = tgp.logpdf(fx, torch.tensor(y)).item()
    assert abs(tgp.approx_lml(nn, fx, torch.tensor(y)).item() - exact) <= 1e-8 * abs(exact)
    xs = torch.tensor(np.random.default_rng(9).uniform(0.0, 6.0, (7, 2)))
    mu, var = tgp.posterior(nn, fx, torch.tensor(y)).mean_and_var(xs)
    mu0, var0 = tgp.posterior(fx, torch.tensor(y)).mean_and_var(xs)
    assert _rel(mu, mu0.numpy()) <= 1e-8
    assert float((var - var0).abs().max()) <= 1e-8


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
def test_torch_predict_knn_matches_jax(use, spy):
    """``predict_knn`` on both routes against the JAX package's matching
    route (the fused one runs row 8 with ``nugget_self=False``)."""
    rng = np.random.default_rng(10)
    X = 1.5 * rng.standard_normal((200, 2))
    Xs = 1.5 * rng.standard_normal((45, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(200)
    fx_t, fx_j = _torch_fx(THETA, X), _jax_fx(jnp.asarray(THETA), jnp.asarray(X))
    jmu, jvar = agp.predict_knn(fx_j, jnp.asarray(y), jnp.asarray(Xs), k=8, test_block=16,
                                use_pallas=bool(use))
    tmu, tvar = tgp.predict_knn(fx_t, torch.tensor(y), torch.tensor(Xs), k=8, test_block=16,
                                use_kernels=use)
    assert len(spy) == (1 if use else 0)  # one launch for all test points
    assert _rel(tmu, jmu) <= 1e-12 and _rel(tvar, jvar) <= 1e-12


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
def test_torch_predict_knn_exact_at_full_k(use):
    """k = N: every test point conditions on all observations, so the mean
    and variance are the exact posterior's, scalar noise and (plain route)
    per-point noise alike."""
    rng = np.random.default_rng(11)
    X, Xs = rng.standard_normal((40, 2)), rng.standard_normal((9, 2))
    y = torch.tensor(np.sin(X[:, 0]) + 0.1 * rng.standard_normal(40))
    fx = _torch_fx(THETA, X)
    mu0, var0 = tgp.posterior(fx, y).mean_and_var(torch.tensor(Xs))
    for f in (fx, tgp.GP(fx.f.kernel)(torch.tensor(X), torch.full((40,), float(fx.noise),
                                                                  dtype=torch.float64))):
        mu, var = tgp.predict_knn(f, y, torch.tensor(Xs), k=40, use_kernels=use)
        assert _rel(mu, mu0.numpy()) <= 1e-8
        assert float((var - var0).abs().max()) <= 1e-8


class _Warped(tk.Kernel):
    """A kernel that does not unwrap to a stationary map: SE on warped
    inputs x + 0.1·x²."""

    def gram(self, X, Z=None):
        warp = lambda A: tk.as_points(A) * (1.0 + 0.1 * tk.as_points(A))  # noqa: E731
        return tk.SqExponentialKernel().gram(warp(X), None if Z is None else warp(Z))

    def diag(self, X):
        return tk.SqExponentialKernel().diag(X)


def test_torch_vecchia_declines_run_the_plain_path(spy):
    """With the kernel route asked for, each place the band kernel declines
    runs the windowed tier (row 6's Function, on a CPU tensor the plain
    masked math; ``test_torch_band_rows.py`` counts its calls): a kernel that
    does not unwrap, noise that is not a scalar, D > 8, and above k = 64 the
    plain masked math; each agrees with the plain route."""
    rng = np.random.default_rng(12)
    x1 = np.cumsum(rng.uniform(0.5, 1.5, 50))
    warped = _Warped()
    got = tv.approx_root_prec_band(torch.tensor(x1), 4, warped, use_kernels=True)
    ref = jv.approx_root_prec_band(jnp.asarray(x1 * (1.0 + 0.1 * x1)), 4,
                                   agp.SqExponentialKernel(), use_pallas=False)
    assert _rel(got, ref) <= 1e-12
    X9 = rng.uniform(0.0, 3.0, (40, 9))
    kern = tk.with_lengthscale(tk.SqExponentialKernel(), 2.0)
    got = tv.approx_root_prec_band(torch.tensor(X9), 4, kern, use_kernels=True)
    assert _rel(got, tv.approx_root_prec_band(torch.tensor(X9), 4, kern, use_kernels=False)) == 0
    x = np.sort(rng.uniform(0.0, 40.0, 80))
    kern = tk.Matern32Kernel()
    got = tv.approx_root_prec_band(torch.tensor(x), 65, kern, use_kernels=True)
    assert _rel(got, tv.approx_root_prec_band(torch.tensor(x), 65, kern, use_kernels=False)) == 0
    X, Xs = rng.standard_normal((70, 2)), rng.standard_normal((6, 2))
    y = torch.tensor(np.sin(X[:, 0]))
    noise = torch.tensor(0.01 + 0.05 * rng.uniform(size=70))
    fx = tgp.GP(tk.SqExponentialKernel())(torch.tensor(X), noise)
    mu, var = tgp.predict_knn(fx, y, torch.tensor(Xs), k=8, use_kernels=True)
    mu0, var0 = tgp.predict_knn(fx, y, torch.tensor(Xs), k=8, use_kernels=False)
    assert torch.equal(mu, mu0) and torch.equal(var, var0)
    fx = tgp.GP(warped)(torch.tensor(X), 0.1)
    tgp.predict_knn(fx, y, torch.tensor(Xs), k=8, use_kernels=True)
    assert spy == []


def test_torch_vecchia_other_orderings_are_not_ported():
    """The other orderings and neighbour sets are ported
    (``test_torch_vecchia_train.py``); what is not, an unknown ordering or
    neighbour set, raises ValueError, as in the JAX package."""
    fx = _torch_fx(THETA, np.linspace(0.0, 5.0, 10))
    y = torch.zeros(10, dtype=torch.float64)
    for kw, what in (({"ordering": "hilbert"}, "unknown ordering"),
                     ({"neighbors": "ball"}, "unknown neighbors"),
                     ({"ordering": "maximin", "neighbors": "ball"}, "unknown neighbors")):
        with pytest.raises(ValueError, match=what):
            tgp.posterior(tgp.NearestNeighbors(3, **kw), fx, y)
        with pytest.raises(ValueError, match=what):
            jv._posterior_nn(agp.NearestNeighbors(3, **kw), _jax_fx(jnp.asarray(THETA),
                                                                    jnp.linspace(0.0, 5.0, 10)),
                             jnp.zeros(10))
