"""The dense Laplace approximation (``models/laplace.py``) on the CPU in f64,
against the JAX package on the same numpy inputs: a counterpart of each test
of ``tests/test_laplace.py``, each also holding the port to the JAX function.

No Pallas kernel is on this path.  Tolerances: the port against the JAX
package 1e-10 relative to each array's largest entry (f64, the same
algorithm, sums in other orders); against finite differences and the
reference's optima the JAX tests' own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu import test_utils as tu
from approximategps_tpu.models import laplace as JL
from approximategps_tpu_torch.models import laplace as TL
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

TOL = 1e-10


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(t, j) -> float:
    t, j = _np(t), _np(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _data():
    X, Y = tu.generate_data()
    return np.asarray(X), np.asarray(Y)


def _latent(theta, lik=None, jitter=1e-8):
    """``tu.build_latent_gp`` on the port's side."""
    kern = tsoftplus(theta[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                      tsoftplus(theta[1]))
    return tgp.LatentGP(tgp.GP(kern), lik or tgp.BernoulliLikelihood(), jitter)


def _fd5(f, x, i, h=1e-4):
    e = np.zeros_like(x)
    e[i] = 1.0
    return (-f(x + 2 * h * e) + 8 * f(x + h * e) - 8 * f(x - h * e) + f(x - 2 * h * e)) / (12 * h)


def _gauss_lik(noise_scale):
    """``tu.test_approximation_predictions``'s Gaussian as a user function."""
    return (lambda f, y: -0.5 * ((y - f) / noise_scale) ** 2 - jnp.log(noise_scale)
            - 0.5 * jnp.log(2 * jnp.pi),
            lambda f, y: -0.5 * ((y - f) / noise_scale) ** 2 - np.log(noise_scale)
            - 0.5 * np.log(2 * np.pi))


def _conjugate_fixture(noise_scale=0.1):
    x = np.linspace(-1.0, 1.0, 5)
    fx = agp.GP(agp.Matern32Kernel())(jnp.asarray(x), noise_scale**2)
    y = np.asarray(fx.sample(jax.random.PRNGKey(123456)))
    jlog, tlog = _gauss_lik(noise_scale)
    return x, y, agp.FunctionLikelihood(logpdf=jlog), tgp.FunctionLikelihood(logpdf=tlog)


def test_torch_laplace_predictions_conformance():
    """Gaussian likelihood: the posterior is exact GP regression, its
    interface is consistent, and it equals the JAX posterior."""
    x, y, jlik, tlik = _conjugate_fixture()
    la_j, la_t = agp.LaplaceApproximation(maxiter=2), tgp.LaplaceApproximation(maxiter=2)
    jpost = agp.posterior(la_j, agp.LatentGP(agp.GP(agp.Matern32Kernel()), jlik, 0.0)(
        jnp.asarray(x)), jnp.asarray(y))
    f = tgp.GP(tgp.Matern32Kernel())
    tpost = tgp.posterior(la_t, tgp.LatentGP(f, tlik, 0.0)(_t(x)), _t(y))
    a = np.linspace(-1.2, 1.2, 6)
    b = np.random.default_rng(3).standard_normal(7)
    m, C = tpost.mean_and_cov(_t(a))
    m2, v2 = tpost.mean_and_var(_t(a))
    assert _rel(m, tpost.mean(_t(a))) < 1e-12 and _rel(m2, m) < 1e-12
    assert _rel(C, tpost.cov(_t(a))) < 1e-12 and _rel(torch.diagonal(C), tpost.var(_t(a))) < 1e-12
    assert _rel(v2, torch.diagonal(C)) < 1e-12
    assert _rel(tpost.cov(_t(a), _t(b)), tpost.cov(_t(b), _t(a)).T) < 1e-12
    assert np.linalg.eigvalsh(_np(C)).min() > -1e-10
    jm, jC = jpost.mean_and_cov(jnp.asarray(a))
    assert _rel(m, jm) < TOL and _rel(C, jC) < TOL
    # exact GP regression
    xt = np.concatenate([x, b[:3]])
    me, Ce = tgp.posterior(f(_t(x), 0.01), _t(y)).mean_and_cov(_t(xt))
    ma, Ca = tpost.mean_and_cov(_t(xt))
    np.testing.assert_allclose(_np(ma), _np(me), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(Ca), _np(Ce), rtol=1e-5, atol=1e-7)


def test_torch_laplace_lml_gradients_match_fd_and_jax():
    """approx_lml's θ-gradient: the JAX package's to 1e-10, central
    differences to rtol 1e-6 (the JAX test's)."""
    X, Y = _data()
    theta0 = np.random.RandomState(123).rand(2)

    def jobj(theta):
        return -agp.approx_lml(agp.LaplaceApproximation(tol=1e-12), tu.build_latent_gp(theta)(X), Y)

    def tobj(theta):
        return -tgp.approx_lml(tgp.LaplaceApproximation(tol=1e-12), _latent(theta)(_t(X)),
                               torch.tensor(Y))

    jv, jg = jax.jit(jax.value_and_grad(jobj))(jnp.asarray(theta0))
    th = _t(theta0, True)
    tv = tobj(th)
    (tg,) = torch.autograd.grad(tv, th)
    assert _rel(tv, jv) < TOL and _rel(tg, jg) < TOL
    with torch.no_grad():
        for i in range(2):
            fd = _fd5(lambda t: tobj(_t(t)).item(), theta0, i)
            np.testing.assert_allclose(tg[i].item(), fd, rtol=1e-6)


def test_torch_newton_chain_rule_through_psd_wrapper():
    """The IFT pullback through K = LᵀL against autograd of 40 unrolled
    Newton steps (1e-8, the JAX test's) and against the JAX custom VJP."""
    ys = np.array([1, 1, 0])
    Lmat = np.random.RandomState(5).standard_normal((3, 3))
    ct = np.random.RandomState(6).standard_normal(3)
    lik = tgp.BernoulliLikelihood()

    def custom(Lm):
        return TL.newton_inner_loop(lik, torch.tensor(ys), Lm.T @ Lm, f_init=Lm.new_zeros(3),
                                    maxiter=100, tol=1e-13)

    def unrolled(Lm):
        f = Lm.new_zeros(3)
        for _ in range(40):
            f, _ = TL._newton_step(lik, torch.tensor(ys), Lm.T @ Lm, f)
        return f

    L1, L2 = _t(Lmat, True), _t(Lmat, True)
    f_c, f_u = custom(L1), unrolled(L2)
    (g_c,) = torch.autograd.grad(f_c, L1, _t(ct))
    (g_u,) = torch.autograd.grad(f_u, L2, _t(ct))
    np.testing.assert_allclose(g_c.numpy(), g_u.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f_c.detach().numpy(), f_u.detach().numpy(), atol=1e-10)

    def jcustom(Lm):
        return JL.newton_inner_loop(tu.dist_y_given_f, ys, Lm.T @ Lm, f_init=jnp.zeros(3),
                                    maxiter=100, tol=1e-13)

    jf, vjp = jax.vjp(jcustom, jnp.asarray(Lmat))
    assert _rel(f_c, jf) < TOL and _rel(g_c, vjp(jnp.asarray(ct))[0]) < TOL


def test_torch_lik_param_gradient_via_ift():
    """The IFT gradient in the Gaussian likelihood's variance: central
    differences (rtol 1e-6) and the JAX package (1e-10)."""
    rng = np.random.RandomState(7)
    n = 6
    A = rng.standard_normal((n, n))
    K = A @ A.T + np.eye(n)
    y = rng.standard_normal(n)

    def tsum(s2):
        f = TL.newton_inner_loop(tgp.GaussianLikelihood(s2), _t(y), _t(K), tol=1e-13)
        return torch.sum(f * torch.arange(n, dtype=torch.float64))

    def jsum(s2):
        f = JL.newton_inner_loop(agp.GaussianLikelihood(s2), jnp.asarray(y), jnp.asarray(K),
                                 tol=1e-13)
        return jnp.sum(f * jnp.arange(n))

    s2 = _t(0.5, True)
    (ad,) = torch.autograd.grad(tsum(s2), s2)
    h = 1e-5
    with torch.no_grad():
        fd = (tsum(_t(0.5 + h)) - tsum(_t(0.5 - h))).item() / (2 * h)
    np.testing.assert_allclose(ad.item(), fd, rtol=1e-6)
    assert _rel(ad, jax.grad(jsum)(0.5)) < TOL
    # the targets' cotangent through the same IFT
    yt = _t(y, True)
    f = TL.newton_inner_loop(tgp.GaussianLikelihood(0.5), yt, _t(K), tol=1e-13)
    (gy,) = torch.autograd.grad(torch.sum(f * torch.arange(n, dtype=torch.float64)), yt)
    jgy = jax.grad(lambda yy: jnp.sum(JL.newton_inner_loop(agp.GaussianLikelihood(0.5), yy,
                                                           jnp.asarray(K), tol=1e-13)
                                      * jnp.arange(n)))(jnp.asarray(y))
    assert _rel(gy, jgy) < TOL


def test_torch_laplace_reference_optima():
    """The reference's hard-coded optima (L-BFGS-B rtol 1e-4, Nelder–Mead
    1e-3) through the port's warm-started objective, whose value and
    gradient at the start equal the JAX objective's."""
    X, Y = _data()
    theta0 = np.array([5.0, 1.0])
    objective = tgp.build_laplace_objective(_latent, _t(X), torch.tensor(Y), newton_tol=1e-12)
    jobj = JL.build_laplace_objective(tu.build_latent_gp, X, Y, newton_tol=1e-12)
    tv, tg = tgp.build_laplace_objective(_latent, _t(X), torch.tensor(Y),
                                         newton_tol=1e-12).value_and_grad(_t(theta0))
    jv, jg = jobj.value_and_grad(jnp.asarray(theta0))
    assert _rel(tv, jv) < TOL and _rel(tg, jg) < TOL

    def fun(theta):
        v, g = objective.value_and_grad(_t(theta))
        return v.item(), g.numpy()

    res = scipy.optimize.minimize(fun, theta0, jac=True, method="L-BFGS-B",
                                  options={"maxiter": 1000})
    np.testing.assert_allclose(res.x, [7.709076337653239, 1.51820292019697], rtol=1e-4)
    res_nm = scipy.optimize.minimize(lambda t: objective(_t(t)).item(), theta0,
                                     method="Nelder-Mead",
                                     options={"xatol": 1e-8, "fatol": 1e-10, "maxiter": 2000})
    np.testing.assert_allclose(res_nm.x, [7.708967951453345, 1.5182348363613536], rtol=1e-3)


def test_torch_laplace_warmstart_vs_coldstart():
    """Warm starts save more than 100 Newton steps over the JAX test's two
    L-BFGS-B runs from each start: the port's objective, fed the θ of every
    call of those runs, takes the JAX objective's Newton steps call by call.
    (With ftol 1e-17 where a run stops depends on the objective's last bits,
    so each package's own runs make other numbers of calls.)  The port's own
    runs land on the same optimum cold and warm (rtol 1e-4)."""
    X, Y = _data()
    totals, optima = {}, {}
    for warm in (False, True):
        totals[warm] = 0
        for theta0 in (np.array([5.0, 1.0]), np.array([2.0, 3.0])):
            jobj = JL.build_laplace_objective(tu.build_latent_gp, X, Y, newton_warmstart=warm,
                                              newton_tol=1e-12)
            tobj = tgp.build_laplace_objective(_latent, _t(X), torch.tensor(Y),
                                               newton_warmstart=warm, newton_tol=1e-12)
            steps = []

            def fun(theta):
                before = (jobj.newton_steps, tobj.newton_steps)
                v, g = jobj.value_and_grad(jnp.asarray(theta))
                tobj.value_and_grad(_t(theta))
                steps.append((jobj.newton_steps - before[0], tobj.newton_steps - before[1]))
                return float(v), np.asarray(g)

            scipy.optimize.minimize(fun, theta0, jac=True, method="L-BFGS-B",
                                    options={"maxiter": 1000, "ftol": 1e-17, "gtol": 1e-12})
            assert [t for _, t in steps] == [j for j, _ in steps]
            totals[warm] += tobj.newton_steps
        own = tgp.build_laplace_objective(_latent, _t(X), torch.tensor(Y),
                                          newton_warmstart=warm, newton_tol=1e-12)

        def fun_own(theta):
            v, g = own.value_and_grad(_t(theta))
            return v.item(), g.numpy()

        optima[warm] = scipy.optimize.minimize(
            fun_own, np.array([2.0, 3.0]), jac=True, method="L-BFGS-B",
            options={"maxiter": 1000, "ftol": 1e-17, "gtol": 1e-12}).x
    assert totals[False] - totals[True] > 100, totals
    np.testing.assert_allclose(optima[False], optima[True], rtol=1e-4)


def test_torch_laplace_steps_match_jax():
    """Every Newton iterate of ``laplace_steps``: the same count, iterates
    and lml as the JAX package's; q a MultivariateNormal; the lml does not
    fall."""
    X, Y = _data()
    theta0 = np.random.RandomState(123).rand(2)
    res = TL.laplace_steps(_latent(_t(theta0))(_t(X)), torch.tensor(Y))
    jres = JL.laplace_steps(tu.build_latent_gp(jnp.asarray(theta0))(X), Y)
    assert len(res) == len(jres) >= 2
    for r, jr in zip(res, jres):
        assert _rel(r.fnew, jr.fnew) < TOL and _rel(r.lml_approx, jr.lml_approx) < TOL
        assert _rel(r.f_cov, jr.f_cov) < 1e-8  # (K⁻¹ + W)⁻¹ through B⁻¹: cond(B) amplifies
    assert isinstance(res[-1].q, tgp.MultivariateNormal)
    assert np.isfinite(res[-1].lml_approx.item())
    assert res[-1].lml_approx.item() >= res[0].lml_approx.item() - 1e-10


def test_torch_laplace_2d_inputs():
    """2-D inputs through the objective with no parameters."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 2))
    y = (rng.uniform(size=5) > 0.5).astype(np.int64)
    tobj = tgp.build_laplace_objective(
        lambda: tgp.LatentGP(tgp.GP(tgp.SEKernel()), tgp.BernoulliLikelihood(), 1e-8), _t(x),
        torch.tensor(y))
    jobj = JL.build_laplace_objective(
        lambda: agp.LatentGP(agp.GP(agp.SEKernel()), agp.BernoulliLikelihood(), 1e-8),
        jnp.asarray(x), jnp.asarray(y))
    val = tobj()
    assert np.isfinite(val.item()) and _rel(val, jobj()) < TOL
    v, g = tobj.value_and_grad()
    assert _rel(v, val) == 0.0 and g == ()


def test_torch_laplace_posterior_as_a_gp():
    """The posterior behaves as a GP: mean and variance at 10 points (the
    JAX posterior's), positive variances, its FiniteGP's marginals, and
    cov's diagonal equal to var; ``laplace_f_and_lml`` gives its mode, the
    JAX package's lml and Newton count."""
    X, Y = _data()
    tpost = tgp.posterior(tgp.LaplaceApproximation(), _latent(_t([2.0, 2.0]))(_t(X)),
                          torch.tensor(Y))
    jpost = agp.posterior(agp.LaplaceApproximation(), tu.build_latent_gp(jnp.array([2.0, 2.0]))(X),
                          Y)
    xs = np.linspace(0, 23.5, 10)
    m, v = tpost.mean_and_var(_t(xs))
    jm, jv = jpost.mean_and_var(jnp.asarray(xs))
    assert m.shape == v.shape == (10,) and bool((v > 0).all())
    assert _rel(m, jm) < TOL and _rel(v, jv) < TOL
    f_opt, lml, n = tgp.laplace_f_and_lml(_latent(_t([2.0, 2.0]))(_t(X)), torch.tensor(Y))
    jf, jlml, jn = agp.laplace_f_and_lml(tu.build_latent_gp(jnp.array([2.0, 2.0]))(X), Y)
    assert n == int(jn) and _rel(f_opt, jf) < TOL and _rel(lml, jlml) < TOL
    assert _rel(f_opt, tpost.cache.f) == 0.0
    mvn = tpost(_t(xs), 1e-9).to_mvn()
    np.testing.assert_allclose(mvn.mean.numpy(), m.numpy(), atol=1e-12)
    np.testing.assert_allclose(mvn.var().numpy(), v.numpy() + 1e-9, atol=1e-8)
    np.testing.assert_allclose(torch.diagonal(tpost.cov(_t(xs))).numpy(), v.numpy(), atol=1e-8)


def test_torch_laplace_approx_lml_conjugate_oracle():
    """Gaussian likelihood: the Laplace evidence is the exact logpdf (rtol
    1e-4, atol 1e-5, as ``tu.test_approx_lml``), and the JAX package's."""
    x = np.linspace(-1.0, 1.0, 6)
    fx = agp.GP(agp.Matern32Kernel())(jnp.asarray(x), 0.01)
    y = np.asarray(fx.sample(jax.random.PRNGKey(123456)))
    jlog, tlog = _gauss_lik(0.1)
    f = tgp.GP(tgp.Matern32Kernel())
    got = tgp.approx_lml(tgp.LaplaceApproximation(),
                         tgp.LatentGP(f, tgp.FunctionLikelihood(logpdf=tlog), 0.0)(_t(x)), _t(y))
    exact = tgp.logpdf(f(_t(x), 0.01), _t(y))
    np.testing.assert_allclose(got.item(), exact.item(), rtol=1e-4, atol=1e-5)
    jgot = agp.approx_lml(agp.LaplaceApproximation(),
                          agp.LatentGP(agp.GP(agp.Matern32Kernel()),
                                       agp.FunctionLikelihood(logpdf=jlog), 0.0)(jnp.asarray(x)),
                          jnp.asarray(y))
    assert _rel(got, jgot) < TOL


def test_torch_newton_forward_mode_jvp():
    """The explicit forward-mode tangent against central differences of the
    fixed point (rtol 1e-5, atol 1e-9) and the JAX package."""
    rng = np.random.RandomState(8)
    n = 5
    A = rng.standard_normal((n, n))
    K = A @ A.T + np.eye(n)
    dK = rng.standard_normal((n, n))
    dK = 0.5 * (dK + dK.T)
    ys = np.array([1, 0, 1, 1, 0])
    lik = tgp.BernoulliLikelihood()
    f0, df = TL.newton_inner_loop_jvp(lik, torch.tensor(ys), _t(K), _t(dK), tol=1e-13)
    h = 1e-6
    fp = TL.newton_inner_loop(lik, torch.tensor(ys), _t(K + h * dK), tol=1e-13)
    fm = TL.newton_inner_loop(lik, torch.tensor(ys), _t(K - h * dK), tol=1e-13)
    np.testing.assert_allclose(df.numpy(), ((fp - fm) / (2 * h)).numpy(), rtol=1e-5, atol=1e-9)
    jf0, jdf = JL.newton_inner_loop_jvp(tu.dist_y_given_f, ys, jnp.asarray(K), jnp.asarray(dK),
                                        tol=1e-13)
    assert _rel(f0, jf0) < TOL and _rel(df, jdf) < TOL


LIKS = {
    "probit": (lambda: agp.BernoulliLikelihood(link="probit"),
               lambda: tgp.BernoulliLikelihood(link="probit"),
               lambda x: (np.sin(x) > 0).astype(np.int64)),
    "poisson": (agp.PoissonLikelihood, tgp.PoissonLikelihood,
                lambda x: np.round(np.exp(np.sin(x))).astype(np.int64)),
    "exponential": (agp.ExponentialLikelihood, tgp.ExponentialLikelihood,
                    lambda x: np.exp(0.3 * np.sin(x)) + 0.1),
    "negbinom": (lambda: agp.NegativeBinomialLikelihood(successes=3.0),
                 lambda: tgp.NegativeBinomialLikelihood(successes=3.0),
                 lambda x: np.round(2.0 * np.exp(np.sin(x))).astype(np.int64)),
}


@pytest.mark.parametrize("name", list(LIKS))
def test_torch_laplace_other_likelihoods(name):
    """Each log-concave likelihood end to end: the lml and its θ-gradient
    (the JAX package's to 1e-10; central differences rtol 1e-5, atol 1e-10)
    and the posterior's mean and variance (the JAX package's)."""
    jmake, tmake, ygen = LIKS[name]
    x = np.linspace(0, 6, 24)
    y = ygen(x)
    ty = torch.tensor(y) if y.dtype.kind == "i" else _t(y)

    def tobj(theta):
        return -tgp.approx_lml(tgp.LaplaceApproximation(tol=1e-12),
                               _latent(theta, tmake())(_t(x)), ty)

    def jobj(theta):
        kern = jax.nn.softplus(theta[0]) * agp.with_lengthscale(
            agp.SqExponentialKernel(), jax.nn.softplus(theta[1]))
        lf = agp.LatentGP(agp.GP(kern), jmake(), 1e-8)
        return -agp.approx_lml(agp.LaplaceApproximation(tol=1e-12), lf(jnp.asarray(x)),
                               jnp.asarray(y))

    theta0 = np.array([1.0, 1.0])
    th = _t(theta0, True)
    v = tobj(th)
    (g,) = torch.autograd.grad(v, th)
    jv, jg = jax.jit(jax.value_and_grad(jobj))(jnp.asarray(theta0))
    assert np.isfinite(v.item()) and _rel(v, jv) < TOL and _rel(g, jg) < TOL
    with torch.no_grad():
        for i in range(2):
            fd = _fd5(lambda t: tobj(_t(t)).item(), theta0, i)
            np.testing.assert_allclose(g[i].item(), fd, rtol=1e-5, atol=1e-10)
    tpost = tgp.posterior(tgp.LaplaceApproximation(),
                          tgp.LatentGP(tgp.GP(tgp.SqExponentialKernel()), tmake(), 1e-8)(_t(x)),
                          ty)
    mu, var = tpost.mean_and_var(_t(x))
    jpost = agp.posterior(agp.LaplaceApproximation(),
                          agp.LatentGP(agp.GP(agp.SqExponentialKernel()), jmake(), 1e-8)(
                              jnp.asarray(x)), jnp.asarray(y))
    jmu, jvar = jpost.mean_and_var(jnp.asarray(x))
    assert bool(torch.isfinite(mu).all()) and bool((var > 0).all())
    assert _rel(mu, jmu) < TOL and _rel(var, jvar) < TOL


def _payloads_j(lik, Y, K, mode):
    seen = []
    f = JL.newton_inner_loop(lik, Y, K, callback=lambda f, c: seen.append((np.asarray(f), c)),
                             callback_mode=mode)
    return f, seen


def test_torch_newton_callback_modes_match_jax_io():
    """Both callback modes are one loop: the same payloads as the JAX
    package's (eager and io, which agree), and the result of its "io" mode
    (the last iterate; its eager mode returns the one before, a quirk of the
    reference)."""
    X, Y = _data()
    theta = np.array([2.0, 1.5])
    lfx = _latent(_t(theta))(_t(X))
    lik, K = TL._check_laplace_inputs(lfx, torch.tensor(Y))
    jlik, jK = JL._check_laplace_inputs(tu.build_latent_gp(jnp.asarray(theta))(X), Y)
    jf_io, jio = _payloads_j(jlik, Y, jK, "io")
    jf_eager, jeager = _payloads_j(jlik, Y, jK, "eager")
    assert len(jio) == len(jeager) > 1
    for mode in ("eager", "io"):
        seen = []
        f = TL.newton_inner_loop(lik, torch.tensor(Y), K, callback_mode=mode,
                                 callback=lambda f, c: seen.append((f.clone(), c)))
        assert len(seen) == len(jio)
        for (tf, tc), (jf, jc) in zip(seen, jio):
            assert _rel(tf, jf) < TOL and _rel(tc.W, jc.W) < TOL and _rel(tc.B_L, jc.B_L) < TOL
        assert _rel(f, jf_io) < TOL and _rel(f, seen[-1][0]) == 0.0
    assert _rel(jf_eager, jeager[-2][0]) == 0.0  # the eager mode's iterate before the last
    with pytest.raises(ValueError, match="callback_mode"):
        TL.newton_inner_loop(lik, torch.tensor(Y), K, callback=print, callback_mode="jit")


def test_torch_laplace_objective_callback_payloads():
    """``newton_callback`` sees every iterate of the objective's solve, one
    a Newton step counted, the first equal to a fresh run's."""
    X, Y = _data()
    seen = []
    obj = tgp.build_laplace_objective(_latent, _t(X), torch.tensor(Y),
                                      newton_callback=lambda f, c: seen.append((f.clone(), c)))
    theta = _t([2.0, 1.5])
    val, g = obj.value_and_grad(theta)
    assert np.isfinite(val.item()) and bool(torch.isfinite(g).all())
    assert len(seen) == obj.newton_steps > 1
    for f, c in seen:
        assert f.shape == (48,) and bool(torch.isfinite(f).all())
        assert bool(torch.isfinite(c.B_L).all())
    jseen = []
    jlfx = tu.build_latent_gp(jnp.array([2.0, 1.5]))(X)
    jlik, jK = JL._check_laplace_inputs(jlfx, Y)
    JL.newton_inner_loop(jlik, Y, jK, f_init=jlfx.fx.mean(),
                         callback=lambda f, c: jseen.append(np.asarray(f)))
    assert _rel(seen[0][0], jseen[0]) < TOL


def test_torch_laplace_steps_scan_matches_steps():
    """``laplace_steps_scan``: the eager trajectory in its valid entries,
    the converged state frozen after, the JAX scan's values."""
    X, Y = _data()
    lfx = _latent(_t([1.5, 1.0]))(_t(X))
    res = TL.laplace_steps(lfx, torch.tensor(Y))
    out = tgp.laplace_steps_scan(lfx, torch.tensor(Y), n_steps=30)
    n = int(out["n_iter"])
    assert n == len(res)
    assert bool(out["valid"][:n].all()) and not bool(out["valid"][n:].any())
    for i, r in enumerate(res):
        np.testing.assert_allclose(out["f"][i].numpy(), r.fnew.numpy(), atol=1e-10)
        np.testing.assert_allclose(out["lml"][i].item(), r.lml_approx.item(), atol=1e-10)
    np.testing.assert_allclose(out["f_opt"].numpy(), res[-1].fnew.numpy(), atol=1e-10)
    jout = agp.laplace_steps_scan(tu.build_latent_gp(jnp.array([1.5, 1.0]))(X), Y, n_steps=30)
    assert int(jout["n_iter"]) == n
    for k in ("f", "lml", "f_opt"):
        assert _rel(out[k], jout[k]) < TOL
    assert np.array_equal(out["valid"].numpy(), np.asarray(jout["valid"]))


def _studentt_data():
    rng = np.random.default_rng(12)
    N, df = 24, 3.0
    x = np.sort(rng.uniform(size=N) * 6)
    y = np.sin(x) + 0.2 * rng.standard_t(df, N)
    return x, y


@pytest.mark.parametrize("mode,damping", [("fisher", 1.0), ("clamp", 0.5)])
def test_torch_gauss_newton_studentt_finds_stationary_mode(mode, damping):
    """Student-t through the PSD curvature surrogates: a stationary point of
    ψ(f) = −log p(y|f) + ½fᵀK⁻¹f (‖∇ψ‖ < 1e-4), a finite lml, and the JAX
    package's mode and lml (1e-8: thousands of damped steps)."""
    x, y = _studentt_data()
    kern = 1.5 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.8)
    K = kern.gram(_t(x)) + 1e-8 * torch.eye(24, dtype=torch.float64)
    lik = tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(3.0, 0.4), mode=mode)
    f_opt = TL.newton_inner_loop(lik, _t(y), K, maxiter=3000, damping=damping)
    assert bool(torch.isfinite(f_opt).all())
    _, d1, _ = lik.log_prob_d1_d2(f_opt, _t(y))
    assert torch.linalg.vector_norm(torch.linalg.solve(K, f_opt) - d1).item() < 1e-4
    lml = TL.laplace_lml(lik, _t(y), K, f_opt=f_opt)
    jlik = agp.GaussNewtonLikelihood(agp.StudentTLikelihood(3.0, 0.4), mode=mode)
    jf = JL.newton_inner_loop(jlik, jnp.asarray(y), jnp.asarray(K.numpy()), maxiter=3000,
                              damping=damping)
    jlml = JL.laplace_lml(jlik, jnp.asarray(y), jnp.asarray(K.numpy()), f_opt=jf)
    assert np.isfinite(lml.item()) and _rel(f_opt, jf) < 1e-8 and _rel(lml, jlml) < 1e-8


def test_torch_newton_step_nans_where_jax_nans():
    """A raw Student-t step where the curvature is negative: B's factor is
    NaN, no error and no host check, as in the JAX package."""
    x, y = _studentt_data()
    K = (1.5 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.8)).gram(_t(x))
    f = _t(y) + 2.0  # |y − f| = 2 > scale·√df: the log-density is convex there
    fnew, cache = TL._newton_step(tgp.StudentTLikelihood(3.0, 0.4), _t(y), K, f)
    jfnew, jcache = JL._newton_step(agp.StudentTLikelihood(3.0, 0.4), jnp.asarray(y),
                                    jnp.asarray(K.numpy()), jnp.asarray(f.numpy()))
    assert bool(torch.isnan(cache.B_L).any()) and bool(torch.isnan(fnew).all())
    assert bool(jnp.isnan(jcache.B_L).any()) and bool(jnp.isnan(jfnew).all())


def test_torch_gauss_newton_inactive_equals_plain_newton():
    """For a log-concave likelihood the clamp never fires: the wrapped and the
    plain likelihood give the same lml (rtol 1e-12) and θ-gradient (1e-9),
    both the JAX package's."""
    X, Y = _data()

    def lml(theta, wrap):
        lfx = _latent(theta)(_t(X))
        lik = tgp.GaussNewtonLikelihood(lfx.lik, mode="clamp", floor=1e-12)
        return TL.laplace_lml(lik if wrap else lfx.lik, _t(Y), lfx.fx.cov(), tol=1e-12)

    out = []
    for wrap in (False, True):
        th = _t([1.3, 0.2], True)
        v = lml(th, wrap)
        out.append((v, torch.autograd.grad(v, th)[0]))
    (v1, g1), (v2, g2) = out
    np.testing.assert_allclose(v2.item(), v1.item(), rtol=1e-12)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-9)

    def jlml(theta):
        lfx = tu.build_latent_gp(theta)(X)
        K = lfx.fx.cov()
        return JL.laplace_lml(lfx.lik, jnp.asarray(Y, K.dtype), K, tol=1e-12)

    jv, jg = jax.value_and_grad(jlml)(jnp.array([1.3, 0.2]))
    assert _rel(v1, jv) < TOL and _rel(g1, jg) < TOL


def test_torch_newton_multistart_picks_better_mode():
    """A bimodal posterior (Cauchy-like likelihood, a strong prior): the two
    starts find different modes, the best is returned, and each start's lml
    is the JAX package's."""
    K = _t([[1.0]])
    y = _t([6.0])
    lik = tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(1.0, 0.1), mode="fisher")
    f_best, lmls = TL.newton_multistart(lik, y, K, torch.stack([y.new_zeros(1), y]), maxiter=500)
    assert bool(torch.isfinite(lmls).all()) and abs(lmls[0] - lmls[1]).item() > 1e-3
    best = TL.laplace_lml(lik, y, K, f_opt=f_best)
    np.testing.assert_allclose(best.item(), lmls.max().item(), rtol=1e-10)
    # neither start settles within 500 steps here (an oscillation in which
    # rounding decides the path), so the JAX package is held to three steps
    jlik = agp.GaussNewtonLikelihood(agp.StudentTLikelihood(1.0, 0.1), mode="fisher")
    f3, l3 = TL.newton_multistart(lik, y, K, torch.stack([y.new_zeros(1), y]), maxiter=3)
    jf, jl = JL.newton_multistart(jlik, jnp.array([6.0]), jnp.array([[1.0]]),
                                  jnp.stack([jnp.zeros(1), jnp.array([6.0])]), maxiter=3)
    assert _rel(l3, jl) < TOL and _rel(f3, jf) < TOL


def test_torch_predictions_use_solved_representer_weights():
    """With a loose Newton tolerance and a sharp Gaussian likelihood the
    mean from the solved weight ``a`` keeps exact-GP accuracy (atol 5e-3)
    and equals the JAX package's."""
    rng = np.random.RandomState(7)
    N = 60
    x = np.sort(rng.uniform(0, 6, N))
    y = np.sin(x) + 0.05 * rng.randn(N)
    f = tgp.GP(1.0 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.7))
    lfx = tgp.LatentGP(f, tgp.GaussianLikelihood(_t(1e-4)), 1e-10)(_t(x))
    post = tgp.posterior(tgp.LaplaceApproximation(maxiter=100, tol=1e-3), lfx, _t(y))
    mu = post.mean(_t(x))
    np.testing.assert_allclose(mu.numpy(), tgp.posterior(f(_t(x), 1e-4), _t(y)).mean(_t(x)).numpy(),
                               atol=5e-3)
    jf = agp.GP(1.0 * agp.with_lengthscale(agp.Matern52Kernel(), 0.7))
    jpost = agp.posterior(agp.LaplaceApproximation(maxiter=100, tol=1e-3),
                          agp.LatentGP(jf, agp.GaussianLikelihood(jnp.asarray(1e-4)), 1e-10)(
                              jnp.asarray(x)), jnp.asarray(y))
    assert _rel(mu, jpost.mean(jnp.asarray(x))) < TOL


def test_torch_convert_laplace_bench_models_match_jax():
    """``convert.laplace_neg_lml`` is ``bench.py::laplace_n5k``'s −lml (value
    and θ-gradient, the JAX model on the same data, 1e-10), and
    ``convert.laplace_kernel`` at ``LAPLACE_CG_THETA`` the CG rows' kernel."""
    from approximategps_tpu_torch import convert

    x, y = convert.laplace_data(200, 1, seed=3, device="cpu", dtype=torch.float64)
    assert x.shape == (200,) and bool((x[1:] >= x[:-1]).all()) and y.dtype == torch.int32

    def jneg(theta):
        kern = jax.nn.softplus(theta[0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                                jax.nn.softplus(theta[1]))
        K = agp.GP(kern)(jnp.asarray(x.numpy()), 1e-6).cov()
        return -JL.laplace_lml(agp.BernoulliLikelihood(), jnp.asarray(y.numpy()), K, maxiter=20)

    th = _t([1.0, 1.0], True)
    v = convert.laplace_neg_lml(th, x, y)
    (g,) = torch.autograd.grad(v, th)
    jv, jg = jax.value_and_grad(jneg)(jnp.array([1.0, 1.0]))
    assert _rel(v, jv) < TOL and _rel(g, jg) < TOL
    x2, _ = convert.laplace_data(50, 2, device="cpu", dtype=torch.float64)
    assert x2.shape == (50, 2) and float(x2.min()) >= 0.0 and float(x2.max()) <= 10.0
    jk = 1.5 * agp.with_lengthscale(agp.SqExponentialKernel(), 1.2)
    kern = convert.laplace_kernel(_t(convert.LAPLACE_CG_THETA))
    assert _rel(kern.gram(x2), jk.gram(jnp.asarray(x2.numpy()))) < 1e-14
