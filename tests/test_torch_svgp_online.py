"""The online SVGP of the PyTorch port (``models/svgp_online.py``) on the CPU
against the JAX package, f64: ``online_elbo``'s value and gradients (both
parametrizations, moved sites and hyperparameters), ``online_optimal_q``,
``centered_q``, and the fixed-site stream (``site_update``,
``site_posterior_q``), each to 1e-10 relative to the largest entry; and a
counterpart of each test of ``tests/test_svgp_online.py`` at its tolerances.
The JAX package's stationarity and hyperparameter-gradient tests are in its
slow tier; their counterparts here run at the same small sizes (seven and six
inducing points) and stay fast.  No JAX function here reaches a Pallas
kernel; the port runs rows 1 and 4's plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.models.svgp_online import centered_q as jax_centered_q
from approximategps_tpu_torch.models.svgp_online import centered_q

torch.set_num_threads(1)
TOL = 1e-10
LS = 0.6
NOISE = 0.1


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _prior(ls=LS):
    return tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), ls))


def _jprior(ls=LS):
    return agp.GP(agp.with_lengthscale(agp.SqExponentialKernel(), ls))


def _data(n=60, seed=0):
    """x on [−2, 2], y a draw of the prior plus noise (numpy)."""
    x = np.linspace(-2.0, 2.0, n)
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / LS**2) + (NOISE + 1e-9) * np.eye(n)
    y = np.linalg.cholesky(K) @ np.random.default_rng(seed).standard_normal(n)
    return _prior(), _t(x), _t(y)


def _prior_state(fz):
    return tgp.OnlineSVGPState(fz, fz.to_mvn())


def _q(m, L):
    return tgp.MultivariateNormal(_t(m), _t(L))


def test_torch_correction_vanishes_for_prior_state():
    """q_old = p_old (same sites and hyperparameters): the online bound is
    the batch ELBO."""
    f, x, y = _data(24)
    fz = f(x[::4], 1e-8)
    q = _q(np.sin(np.arange(6.0)), np.eye(6) + 0.1 * np.tril(np.ones((6, 6)), -1))
    sva = tgp.SparseVariationalApproximation(fz, q, tgp.Centered())
    batch = tgp.elbo(sva, f(x, NOISE), y)
    online = tgp.online_elbo(sva, _prior_state(fz), f(x, NOISE), y)
    np.testing.assert_allclose(_np(online), _np(batch), rtol=1e-10)


def test_torch_gaussian_streaming_equals_batch():
    """Fixed z and hyperparameters: three closed-form online updates
    telescope to the full-batch optimum, and so do the posteriors."""
    f, x, y = _data(60)
    fz = f(torch.linspace(-1.9, 1.9, 9, dtype=torch.float64), 1e-10)
    state = _prior_state(fz)
    for i in range(3):
        sl = slice(i * 20, (i + 1) * 20)
        state = tgp.OnlineSVGPState(fz, tgp.online_optimal_q(state, fz, f(x[sl], NOISE), y[sl]))
    q_batch = tgp.optimal_variational_posterior(fz, f(x, NOISE), y)
    np.testing.assert_allclose(_np(state.q.mean), _np(q_batch.mean), atol=1e-8)
    np.testing.assert_allclose(_np(state.q.cov()), _np(q_batch.cov()), atol=1e-8)
    xs = torch.linspace(-2.5, 2.5, 17, dtype=torch.float64)
    p_on = tgp.posterior(tgp.SparseVariationalApproximation(fz, state.q, tgp.Centered()))
    p_ba = tgp.posterior(tgp.SparseVariationalApproximation(fz, q_batch, tgp.Centered()))
    np.testing.assert_allclose(_np(p_on.mean(xs)), _np(p_ba.mean(xs)), atol=1e-8)
    np.testing.assert_allclose(_np(p_on.var(xs)), _np(p_ba.var(xs)), atol=1e-8)


def test_torch_first_round_matches_batch_optimum():
    f, x, y = _data(20)
    fz = f(x[::3], 1e-10)
    q1 = tgp.online_optimal_q(_prior_state(fz), fz, f(x, NOISE), y)
    q_batch = tgp.optimal_variational_posterior(fz, f(x, NOISE), y)
    np.testing.assert_allclose(_np(q1.mean), _np(q_batch.mean), atol=1e-9)
    np.testing.assert_allclose(_np(q1.cov()), _np(q_batch.cov()), atol=1e-9)


def test_torch_online_elbo_stationary_at_closed_form_optimum():
    """∂(online bound)/∂(m, L) = 0 at ``online_optimal_q``, and random
    moves of m lower the bound."""
    f, x, y = _data(40)
    fz = f(torch.linspace(-1.8, 1.8, 7, dtype=torch.float64), 1e-10)
    q1 = tgp.online_optimal_q(_prior_state(fz), fz, f(x[:20], NOISE), y[:20])
    state = tgp.OnlineSVGPState(fz, q1)
    q2 = tgp.online_optimal_q(state, fz, f(x[20:], NOISE), y[20:])

    def bound(m, L):
        sva = tgp.SparseVariationalApproximation(fz, tgp.MultivariateNormal(m, L), tgp.Centered())
        return tgp.online_elbo(sva, state, f(x[20:], NOISE), y[20:])

    m, L = q2.mean.clone().requires_grad_(), q2.scale_tril.clone().requires_grad_()
    val = bound(m, L)
    gm, gL = torch.autograd.grad(val, (m, L))
    assert torch.isfinite(val)
    np.testing.assert_allclose(_np(gm), 0.0, atol=1e-7)
    np.testing.assert_allclose(_np(torch.tril(gL)), 0.0, atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(3):
            dk = torch.randn(m.shape, generator=gen, dtype=torch.float64)
            assert bound(m + 0.05 * dk, L) < val


def test_torch_online_hyper_gradient_matches_fd_and_jax():
    """d(online bound)/d(log lengthscale) against central differences
    (rtol 1e-5, the JAX test's) and against jax.grad (1e-10)."""
    f, x, y = _data(30)
    z = torch.linspace(-1.5, 1.5, 6, dtype=torch.float64)
    fz_old = f(z, 1e-8)
    q1 = tgp.online_optimal_q(_prior_state(fz_old), fz_old, f(x[:15], NOISE), y[:15])
    state = tgp.OnlineSVGPState(fz_old, q1)
    q = _q(0.3 * np.ones(6), 0.8 * np.eye(6))

    def bound(log_ls):
        fnew = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), torch.exp(log_ls)))
        sva = tgp.SparseVariationalApproximation(fnew(z, 1e-8), q, tgp.Centered())
        return tgp.online_elbo(sva, state, fnew(x[15:], NOISE), y[15:])

    t0 = torch.log(torch.tensor(0.5, dtype=torch.float64)).requires_grad_()
    (g,) = torch.autograd.grad(bound(t0), t0)
    h = 1e-5
    with torch.no_grad():
        fd = (bound(t0 + h) - bound(t0 - h)) / (2 * h)
    np.testing.assert_allclose(g.item(), fd.item(), rtol=1e-5)

    jz, jx, jy = (jnp.asarray(_np(a)) for a in (z, x, y))
    jf = _jprior()
    jfz = jf(jz, 1e-8)
    jstate = agp.OnlineSVGPState(jfz, agp.MultivariateNormal(jnp.asarray(_np(q1.mean)),
                                                             jnp.asarray(_np(q1.scale_tril))))
    jq = agp.MultivariateNormal(0.3 * jnp.ones(6), 0.8 * jnp.eye(6))

    def jbound(log_ls):
        fnew = agp.GP(agp.with_lengthscale(agp.SqExponentialKernel(), jnp.exp(log_ls)))
        sva = agp.SparseVariationalApproximation(fnew(jz, 1e-8), jq, agp.Centered())
        return agp.online_elbo(sva, jstate, fnew(jx[15:], NOISE), jy[15:])

    jv, jg = jax.value_and_grad(jbound)(jnp.log(0.5))
    assert _rel(bound(t0), jv) < TOL and _rel(g, jg) < TOL


def test_torch_noncentered_state_and_bound_match_centered():
    f, x, y = _data(24)
    fz = f(x[::4], 1e-8)
    Lk = fz.scale_tril()
    m_eps = torch.cos(torch.arange(6.0, dtype=torch.float64))
    L_eps = 0.7 * torch.eye(6, dtype=torch.float64) + 0.05 * torch.tril(
        torch.ones((6, 6), dtype=torch.float64), -1)
    sva_nc = tgp.SparseVariationalApproximation(fz, tgp.MultivariateNormal(m_eps, L_eps),
                                                tgp.NonCentered())
    q_c = centered_q(sva_nc)
    np.testing.assert_allclose(_np(q_c.mean), _np(fz.mean() + Lk @ m_eps), atol=1e-12)
    np.testing.assert_allclose(_np(q_c.cov()), _np(Lk @ L_eps @ L_eps.T @ Lk.T), atol=1e-12)
    sva_c = tgp.SparseVariationalApproximation(fz, q_c, tgp.Centered())
    state = tgp.online_state(sva_nc)
    np.testing.assert_allclose(_np(state.q.mean), _np(q_c.mean), atol=1e-12)
    prior_state = _prior_state(f(x[::4] + 0.05, 1e-8))
    b_nc = tgp.online_elbo(sva_nc, prior_state, f(x, NOISE), y)
    b_c = tgp.online_elbo(sva_c, prior_state, f(x, NOISE), y)
    np.testing.assert_allclose(_np(b_nc), _np(b_c), rtol=1e-9)


def test_torch_streaming_with_moving_sites_and_hypers():
    """New sites and hyperparameters between rounds: within 10 % of the
    batch optimum's scale, and the bound finite."""
    f, x, y = _data(60)
    z1 = torch.linspace(-1.9, 0.5, 10, dtype=torch.float64)
    z2 = torch.linspace(-1.9, 1.9, 14, dtype=torch.float64)
    f2 = _prior(0.55)
    fz1, fz2 = f(z1, 1e-10), f2(z2, 1e-10)
    q1 = tgp.online_optimal_q(_prior_state(fz1), fz1, f(x[:30], NOISE), y[:30])
    state = tgp.OnlineSVGPState(fz1, q1)
    q2 = tgp.online_optimal_q(state, fz2, f2(x[30:], NOISE), y[30:])
    q_batch = tgp.optimal_variational_posterior(fz2, f2(x, NOISE), y)
    xs = torch.linspace(-1.8, 1.8, 25, dtype=torch.float64)
    p_on = tgp.posterior(tgp.SparseVariationalApproximation(fz2, q2, tgp.Centered()))
    p_ba = tgp.posterior(tgp.SparseVariationalApproximation(fz2, q_batch, tgp.Centered()))
    err = float(torch.max(torch.abs(p_on.mean(xs) - p_ba.mean(xs))))
    assert err < 0.1 * float(torch.max(torch.abs(p_ba.mean(xs))))
    val = tgp.online_elbo(tgp.SparseVariationalApproximation(fz2, q2, tgp.Centered()), state,
                          f2(x[30:], NOISE), y[30:])
    assert torch.isfinite(val)


def test_torch_online_elbo_latent_gaussian_matches_finitegp_path():
    f, x, y = _data(20)
    fz = f(x[::4], 1e-8)
    sva = tgp.SparseVariationalApproximation(fz, _q(0.2 * np.ones(5), 0.9 * np.eye(5)),
                                             tgp.Centered())
    state = _prior_state(f(x[::4] - 0.1, 1e-8))
    lf = tgp.LatentGP(f, tgp.GaussianLikelihood(NOISE), 0.0)
    b1 = tgp.online_elbo(sva, state, f(x, NOISE), y)
    b2 = tgp.online_elbo(sva, state, lf(x), y)
    np.testing.assert_allclose(_np(b1), _np(b2), rtol=1e-9)


def _fit(loss_fn, q0, steps=400):
    m = q0.mean.detach().clone().requires_grad_()
    L = q0.scale_tril.detach().clone().requires_grad_()
    opt = torch.optim.Adam([m, L], lr=5e-2)
    for _ in range(steps):
        opt.zero_grad()
        (-loss_fn(tgp.MultivariateNormal(m, torch.tril(L)))).backward()
        opt.step()
    return tgp.MultivariateNormal(m.detach(), torch.tril(L.detach()))


def test_torch_online_bernoulli_improves_with_second_batch():
    """Non-conjugate streaming: Adam on the round-2 online bound beats
    carrying round 1's posterior, and moves toward the full-batch fit."""
    f = _prior(0.8)
    x = torch.linspace(-2.0, 2.0, 40, dtype=torch.float64)
    gen = torch.Generator().manual_seed(7)
    ftrue = 2.0 * f(x, 1e-8).sample(gen)
    y = (torch.rand(40, generator=gen, dtype=torch.float64) < torch.sigmoid(ftrue)).double()
    lf = tgp.LatentGP(f, tgp.BernoulliLikelihood(), 1e-8)
    fz = f(torch.linspace(-1.9, 1.9, 8, dtype=torch.float64), 1e-8)

    def sva(q):
        return tgp.SparseVariationalApproximation(fz, q, tgp.Centered())

    q1 = _fit(lambda q: tgp.elbo(sva(q), lf(x[:20]), y[:20]), fz.to_mvn())
    state = tgp.OnlineSVGPState(fz, q1)

    def round2(q):
        return tgp.online_elbo(sva(q), state, lf(x[20:]), y[20:])

    q2 = _fit(round2, q1)
    with torch.no_grad():
        assert float(round2(q2)) > float(round2(q1)) + 0.1
    q_full = _fit(lambda q: tgp.elbo(sva(q), lf(x), y), fz.to_mvn(), steps=600)
    assert float(torch.linalg.norm(q2.mean - q_full.mean)) < \
        float(torch.linalg.norm(q1.mean - q_full.mean))


def test_torch_site_state_telescopes_to_batch_optimum():
    """The fixed-site accumulator, chunks in any order, equals the
    full-batch optimum."""
    f, x, y = _data(60)
    fz = f(torch.linspace(-1.9, 1.9, 9, dtype=torch.float64), 1e-10)
    st = tgp.site_state(fz)
    for i in (2, 0, 1):
        sl = slice(i * 20, (i + 1) * 20)
        st = tgp.site_update(st, f(x[sl], NOISE), y[sl])
    q = tgp.site_posterior_q(st)
    q_batch = tgp.optimal_variational_posterior(fz, f(x, NOISE), y)
    np.testing.assert_allclose(_np(q.mean), _np(q_batch.mean), atol=1e-9)
    np.testing.assert_allclose(_np(q.cov()), _np(q_batch.cov()), atol=1e-9)


def test_torch_site_state_matches_general_online_chain():
    f, x, y = _data(40)
    fz = f(torch.linspace(-1.8, 1.8, 7, dtype=torch.float64), 1e-10)
    st, state = tgp.site_state(fz), _prior_state(fz)
    for i in range(2):
        sl = slice(i * 20, (i + 1) * 20)
        st = tgp.site_update(st, f(x[sl], NOISE), y[sl])
        state = tgp.OnlineSVGPState(fz, tgp.online_optimal_q(state, fz, f(x[sl], NOISE), y[sl]))
    q_fast = tgp.site_posterior_q(st)
    np.testing.assert_allclose(_np(q_fast.mean), _np(state.q.mean), atol=1e-9)
    np.testing.assert_allclose(_np(q_fast.cov()), _np(state.q.cov()), atol=1e-9)


def test_torch_site_state_validates_inputs():
    f = _prior()
    z = torch.linspace(0, 1, 4, dtype=torch.float64)
    st = tgp.site_state(f(z, 1e-10))
    with pytest.raises(ValueError):
        tgp.site_update(st, f(z, torch.ones(4, dtype=torch.float64)), torch.ones(4))
    nonzero = tgp.GP(tgp.SqExponentialKernel(), tgp.core.ConstMean(1.0))
    with pytest.raises(ValueError):
        tgp.site_state(nonzero(z, 1e-10))
    with pytest.raises(ValueError):
        tgp.online_optimal_q(_prior_state(f(z, 1e-10)), nonzero(z, 1e-10), f(z, 0.1),
                             torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tgp.online_optimal_q(_prior_state(f(z, 1e-10)), f(z, 1e-10),
                             f(z, torch.ones(4, dtype=torch.float64)),
                             torch.ones(4, dtype=torch.float64))


# -- parity with the JAX package ---------------------------------------------------------


def _pair_problem(seed=3):
    """Moved sites and hyperparameters, both parametrizations' q from numpy."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-2.0, 2.0, 30)
    y = np.sin(2 * x) + 0.2 * rng.standard_normal(30)
    z_old, z_new = np.linspace(-1.9, 0.4, 6), np.linspace(-1.8, 1.8, 8)
    m_old = 0.5 * rng.standard_normal(6)
    L_old = np.tril(0.05 * rng.standard_normal((6, 6)), -1) + np.diag(
        0.3 + 0.2 * rng.uniform(size=6))
    m = 0.3 * rng.standard_normal(8)
    L = np.tril(0.05 * rng.standard_normal((8, 8)), -1) + np.diag(0.5 + 0.2 * rng.uniform(size=8))
    return x, y, z_old, z_new, m_old, L_old, m, L


@pytest.mark.parametrize("centered", [True, False], ids=["centered", "noncentered"])
def test_torch_online_elbo_and_optimal_q_match_jax(centered):
    """The bound's value and its gradients in (m, L, z, log ℓ) against
    jax.value_and_grad, and ``online_optimal_q`` and ``centered_q`` against
    the JAX ones, with moved sites and a new lengthscale."""
    x, y, z_old, z_new, m_old, L_old, m, L = _pair_problem()
    jst = agp.OnlineSVGPState(_jprior()(jnp.asarray(z_old), 1e-8),
                              agp.MultivariateNormal(jnp.asarray(m_old), jnp.asarray(L_old)))
    tst = tgp.OnlineSVGPState(_prior()(_t(z_old), 1e-8), _q(m_old, L_old))
    jpar, tpar = (agp.Centered(), tgp.Centered()) if centered else \
        (agp.NonCentered(), tgp.NonCentered())

    def jbound(m_, L_, z_, lls):
        f = agp.GP(agp.with_lengthscale(agp.SqExponentialKernel(), jnp.exp(lls)))
        sva = agp.SparseVariationalApproximation(f(z_, 1e-8), agp.MultivariateNormal(m_, L_), jpar)
        return agp.online_elbo(sva, jst, f(jnp.asarray(x), NOISE), jnp.asarray(y), num_data=90)

    def tbound(m_, L_, z_, lls):
        f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), torch.exp(lls)))
        sva = tgp.SparseVariationalApproximation(f(z_, 1e-8), tgp.MultivariateNormal(m_, L_), tpar)
        return tgp.online_elbo(sva, tst, f(_t(x), NOISE), _t(y), num_data=90)

    args = (m, L, z_new, np.log(0.55))
    jv, jg = jax.value_and_grad(jbound, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    targs = [_t(a, True) for a in args]
    tv = tbound(*targs)
    tg = torch.autograd.grad(tv, targs)
    assert _rel(tv, jv) < TOL
    for a, b in zip(tg, jg):
        assert _rel(a, b) < TOL

    jsva = agp.SparseVariationalApproximation(
        _jprior()(jnp.asarray(z_new), 1e-8), agp.MultivariateNormal(jnp.asarray(m),
                                                                   jnp.asarray(L)), jpar)
    tsva = tgp.SparseVariationalApproximation(_prior()(_t(z_new), 1e-8), _q(m, L), tpar)
    jc, tc = jax_centered_q(jsva), centered_q(tsva)
    assert _rel(tc.mean, jc.mean) < TOL and _rel(tc.scale_tril, jc.scale_tril) < TOL
    f2j, f2t = _jprior(0.55), _prior(0.55)
    jq = agp.online_optimal_q(jst, f2j(jnp.asarray(z_new), 1e-8), f2j(jnp.asarray(x), NOISE),
                              jnp.asarray(y))
    tq = tgp.online_optimal_q(tst, f2t(_t(z_new), 1e-8), f2t(_t(x), NOISE), _t(y))
    assert _rel(tq.mean, jq.mean) < TOL and _rel(tq.scale_tril, jq.scale_tril) < TOL


def test_torch_site_stream_matches_jax():
    """site_update over three chunks, then site_posterior_q, against the
    JAX accumulator (lam, eta and q)."""
    _, x, y = _data(60, seed=4)
    z = np.linspace(-1.9, 1.9, 9)
    jfz, tfz = _jprior()(jnp.asarray(z), 1e-10), _prior()(_t(z), 1e-10)
    jst, tst = agp.site_state(jfz), tgp.site_state(tfz)
    for i in range(3):
        sl = slice(i * 20, (i + 1) * 20)
        jst = agp.site_update(jst, _jprior()(jnp.asarray(_np(x[sl])), NOISE),
                              jnp.asarray(_np(y[sl])))
        tst = tgp.site_update(tst, _prior()(x[sl], NOISE), y[sl])
    assert _rel(tst.lam, jst.lam) < TOL and _rel(tst.eta, jst.eta) < TOL
    jq, tq = agp.site_posterior_q(jst), tgp.site_posterior_q(tst)
    assert _rel(tq.mean, jq.mean) < TOL and _rel(tq.scale_tril, jq.scale_tril) < TOL
