"""The natural-gradient SVGP path, VFE, the Poisson SVGP and ``lbfgs_fit``
on the CPU, f64, against the JAX package: ``natgrad_update`` and
``natgrad_update_tril``, ``blocked_tril_inv`` and its pullback, three
``make_natgrad_adam_step`` steps against the JAX step (optax Adam), the
conjugate-exact identity against ``vfe_elbo``, ``gradient_precision``'s
TF32 switch, VFE's optimal q, bound and posterior with the golden
equalities of ``tests/test_svgp.py``, the Poisson SVGP's elbo and gradients,
and ``lbfgs_fit``.

On the CPU no JAX function here reaches a Pallas kernel (``chol_with_inv``'s
kernel gates need a TPU), and the port runs the plain versions of rows 1
and 4.  Inputs come from numpy with fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.core.linalg import blocked_tril_inv as jax_blocked_tril_inv
from approximategps_tpu.models.vfe import optimal_variational_posterior as jax_opt_q
from approximategps_tpu.utils import training as jtraining
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu_torch.core import linalg as tlinalg
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _close(t, j, rtol, atol=0.0):
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(a, np.asarray(j), rtol=rtol, atol=atol)


# -- natgrad_update, natgrad_update_tril ---------------------------------------


def _toy(n=6, seed=0):
    """test_natgrad_update_tril_matches_dense_S's problem: a non-trivial
    (m, S ≠ I), the ELBO of a Gaussian likelihood on a N(0, I) prior."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n)
    R = 0.3 * rng.standard_normal((n, n))
    S0 = R @ R.T + np.eye(n)
    return y, np.linalg.cholesky(S0), S0, rng.standard_normal(n), 0.3


def _jax_elbo_mL(y, s2):
    n = y.shape[0]

    def elbo(m, L):
        ell = -0.5 * jnp.sum(((y - m) ** 2 + jnp.sum(jnp.tril(L) ** 2, 1)) / s2)
        q = agp.MultivariateNormal(m, jnp.tril(L))
        return ell - agp.kl_divergence(q, agp.MultivariateNormal(jnp.zeros(n), jnp.eye(n)))

    return elbo


def _torch_elbo_mL(y, s2):
    n = y.shape[0]

    def elbo(m, L):
        ell = -0.5 * torch.sum(((y - m) ** 2 + torch.sum(torch.tril(L) ** 2, 1)) / s2)
        q = tgp.MultivariateNormal(m, torch.tril(L))
        p = tgp.MultivariateNormal(torch.zeros(n, dtype=m.dtype), torch.eye(n, dtype=m.dtype))
        return ell - tgp.core.kl_divergence(q, p)

    return elbo


def test_torch_natgrad_update_matches_jax():
    """natgrad_update from dense-S gradients at lr 0.7, to 1e-9; the
    gradients themselves (the port's autograd against jax.grad) to 1e-12."""
    y, L0, S0, m0, s2 = _toy()
    jel = _jax_elbo_mL(jnp.asarray(y), s2)
    gm, gS = jax.jit(jax.grad(lambda m, S: jel(m, jnp.linalg.cholesky(S)), argnums=(0, 1)))(
        jnp.asarray(m0), jnp.asarray(S0))
    m1, L1 = jax.jit(lambda *a: jtraining.natgrad_update(*a, lr=0.7))(
        jnp.asarray(m0), jnp.asarray(L0), gm, gS)

    tel = _torch_elbo_mL(_t(y), s2)
    mt, St = _t(m0, True), _t(S0, True)
    tgm, tgS = torch.autograd.grad(tel(mt, torch.linalg.cholesky(St)), (mt, St))
    _close(tgm, gm, 1e-12, 1e-12)
    _close(tlinalg.symmetrize(tgS), gS, 1e-12, 1e-12)
    tm1, tL1 = tgp.natgrad_update(_t(m0), _t(L0), _t(gm), _t(gS), lr=0.7)
    _close(tm1, m1, 0, 1e-9)
    _close(tL1, L1, 0, 1e-9)


@pytest.mark.parametrize("carry_inv", [False, True])
def test_torch_natgrad_update_tril_matches_jax(carry_inv):
    """natgrad_update_tril from scale-tril gradients, with and without the
    carried L⁻¹, to 1e-9; the carried inverse is L1⁻¹."""
    y, L0, S0, m0, s2 = _toy()
    jel = _jax_elbo_mL(jnp.asarray(y), s2)
    gm, gL = jax.jit(jax.grad(jel, argnums=(0, 1)))(jnp.asarray(m0), jnp.asarray(L0))
    Linv = np.linalg.inv(L0) if carry_inv else None
    m1, L1, Li1 = jax.jit(lambda m, L, gm, gL, Li: jtraining.natgrad_update_tril(
        m, L, gm, gL, lr=0.7, Linv=Li))(jnp.asarray(m0), jnp.asarray(L0), gm, gL,
                                        None if Linv is None else jnp.asarray(Linv))

    tel = _torch_elbo_mL(_t(y), s2)
    mt, Lt = _t(m0, True), _t(L0, True)
    tgm, tgL = torch.autograd.grad(tel(mt, Lt), (mt, Lt))
    _close(tgm, gm, 1e-12, 1e-12)
    _close(tgL, gL, 1e-12, 1e-12)
    tm1, tL1, tLi1 = tgp.natgrad_update_tril(_t(m0), _t(L0), _t(gm), _t(gL), lr=0.7,
                                             Linv=None if Linv is None else _t(Linv))
    for got, want in ((tm1, m1), (tL1, L1), (tLi1, Li1)):
        _close(got, want, 0, 1e-9)
    _close(tLi1 @ tL1, np.eye(6), 0, 1e-9)


# -- blocked_tril_inv ------------------------------------------------------------


@pytest.mark.parametrize("n", [200, 512])  # 512: four 128-blocks, the JAX level-batched branch
def test_torch_blocked_tril_inv_and_pullback_match_jax(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    L = np.linalg.cholesky(A @ A.T + np.eye(n))
    ct = rng.standard_normal((n, n))
    Jinv, (jbar,) = jax.jit(lambda L, ct: (lambda out: (out[0], out[1](ct)))(
        jax.vjp(jax_blocked_tril_inv, L)))(jnp.asarray(L), jnp.asarray(ct))
    Lt = _t(L, True)
    Tinv = tgp.blocked_tril_inv(Lt)
    (tbar,) = torch.autograd.grad(Tinv, Lt, _t(ct))
    _close(Tinv, Jinv, 0, 1e-12)
    scale = np.abs(np.asarray(jbar)).max()
    _close(tbar, jbar, 0, 1e-12 * scale)
    assert not torch.triu(tbar, 1).any()


# -- make_natgrad_adam_step -------------------------------------------------------


def _hybrid_setup():
    """test_hybrid_natgrad_adam_step_conjugate_exact's n = 40, M = 8 problem."""
    rng = np.random.default_rng(7)
    n, M = 40, 8
    x = np.sort(rng.uniform(0.0, 6.0, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    z = x[:: n // M][:M]
    return x, y, z, 0.1


def _jax_hybrid_elbo(z, noise):
    def elbo_fn(hyper, m, L, xb, yb):
        f = agp.GP(jsoftplus(hyper[0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                               jsoftplus(hyper[1])))
        q = agp.MultivariateNormal(m, jnp.tril(L))
        return agp.elbo(agp.SparseVariationalApproximation(f(z, 1e-8), q), f(xb, noise), yb)

    return elbo_fn


def _torch_hybrid_elbo(z, noise, seen=None):
    def elbo_fn(hyper, m, L, xb, yb):
        if seen is not None:
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        f = tgp.GP(tsoftplus(hyper[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                               tsoftplus(hyper[1])))
        q = tgp.MultivariateNormal(m, torch.tril(L))
        return tgp.elbo(tgp.SparseVariationalApproximation(f(z, 1e-8), q), f(xb, noise), yb)

    return elbo_fn


def test_torch_natgrad_adam_step_matches_jax():
    """Three hybrid steps (Adam 1e-2 on the hyperparameters, nat_lr 0.5 on
    q) from an arbitrary q: the ELBO of each step, the hyperparameters and
    (m, L, L⁻¹) after each, against the JAX step with optax Adam, to 1e-8."""
    x, y, z, noise = _hybrid_setup()
    hyper0, m0, L0 = np.array([0.5, 0.5]), 0.3 * np.ones(8), 1.4 * np.eye(8)
    jstep, jinit = jtraining.make_natgrad_adam_step(_jax_hybrid_elbo(jnp.asarray(z), noise),
                                                    optax.adam(1e-2), nat_lr=0.5)
    jcarry = jinit(jnp.asarray(hyper0), jnp.asarray(m0), jnp.asarray(L0))
    tstep, tinit = tgp.make_natgrad_adam_step(_torch_hybrid_elbo(_t(z), noise),
                                              learning_rate=1e-2, nat_lr=0.5)
    tcarry = tinit(_t(hyper0), _t(m0), _t(L0))
    for _ in range(3):
        jcarry, je = jstep(jcarry, jnp.asarray(x), jnp.asarray(y))
        tcarry, te = tstep(tcarry, _t(x), _t(y))
        _close(te, je, 1e-8)
        for i in (0, 2, 3, 4):
            _close(tcarry[i], jcarry[i], 1e-8, 1e-10)


def test_torch_natgrad_adam_step_conjugate_exact():
    """One step with nat_lr = 1 lands q on the optimal q of the old
    hyperparameters: the ELBO there equals the port's vfe_elbo (1e-8
    relative), while Adam moves the hyperparameters."""
    x, y, z, noise = _hybrid_setup()
    elbo_fn = _torch_hybrid_elbo(_t(z), noise)
    hyper0 = np.array([0.5, 0.5])
    step, init = tgp.make_natgrad_adam_step(elbo_fn, learning_rate=1e-2, nat_lr=1.0)
    (hyper1, _, m1, L1, Linv1), e0 = step(init(_t(hyper0), _t(0.3 * np.ones(8)),
                                               _t(1.4 * np.eye(8))), _t(x), _t(y))
    assert torch.isfinite(e0)
    assert not np.allclose(hyper1.detach().numpy(), hyper0)
    e1 = elbo_fn(_t(hyper0), m1, L1, _t(x), _t(y))
    f0 = tgp.GP(tsoftplus(_t(0.5)) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                           tsoftplus(_t(0.5))))
    bound = tgp.vfe_elbo(tgp.VFE(f0(_t(z), 1e-8)), f0(_t(x), noise), _t(y))
    _close(e1, bound.detach(), 1e-8)
    _close(Linv1 @ L1, np.eye(8), 0, 1e-8)


@pytest.mark.parametrize("precision,inside", [("high", False), ("highest", False),
                                               ("default", True), (None, "caller")])
@pytest.mark.parametrize("caller", [False, True])
def test_torch_natgrad_gradient_precision_sets_and_restores_tf32(precision, inside, caller):
    x, y, z, noise = _hybrid_setup()
    seen = []
    step, init = tgp.make_natgrad_adam_step(_torch_hybrid_elbo(_t(z), noise, seen),
                                            gradient_precision=precision)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = caller
    try:
        step(init(_t([0.5, 0.5]), _t(np.zeros(8)), _t(np.eye(8))), _t(x), _t(y))
        assert seen == [caller if inside == "caller" else inside]
        assert torch.backends.cuda.matmul.allow_tf32 is caller
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    with pytest.raises(ValueError, match="gradient_precision"):
        tgp.make_natgrad_adam_step(_torch_hybrid_elbo(_t(z), noise), gradient_precision="low")


# -- VFE --------------------------------------------------------------------------


def _vfe_setup():
    """test_svgp.py's elbo_setup: N = 20 on [0, 10], its kernel
    softplus(0.2)·SE ∘ ScaleTransform(softplus(0.6))."""
    rng = np.random.default_rng(654321)
    x = rng.uniform(0, 10, 20)
    y = np.sin(x) + 0.9 * np.cos(x * 1.6) + 0.4 * rng.uniform(size=20)
    return x, y, 0.1


def _kernels(k):
    j = jsoftplus(k[0]) * agp.InputScaledKernel(agp.SqExponentialKernel(), jsoftplus(k[1]))
    t = tsoftplus(_t(k[0])) * tgp.InputScaledKernel(tgp.SqExponentialKernel(), tsoftplus(_t(k[1])))
    return j, t


def test_torch_vfe_matches_jax():
    """optimal_variational_posterior, vfe_elbo and posterior(VFE)'s means
    and variances at 7 test points against the JAX package, M = 6, to
    1e-10."""
    x, y, noise = _vfe_setup()
    z = x[:6]
    xs = np.linspace(-1, 11, 7)
    jk, tk_ = _kernels([0.2, 0.6])
    jf, tf = agp.GP(jk), tgp.GP(tk_)

    @jax.jit
    def jax_side(z, x, y, xs):
        fz, fx = jf(z, 1e-6), jf(x, noise)
        q = jax_opt_q(fz, fx, y)
        post = agp.posterior(agp.VFE(fz), fx, y)
        return (q.mean, q.cov(), agp.vfe_elbo(agp.VFE(fz), fx, y),
                agp.approx_lml(agp.VFE(fz), fx, y), post.mean(xs), post.var(xs))

    want = jax_side(*map(jnp.asarray, (z, x, y, xs)))
    tfz, tfx = tf(_t(z), 1e-6), tf(_t(x), noise)
    tq = tgp.optimal_variational_posterior(tfz, tfx, _t(y))
    tpost = tgp.posterior(tgp.VFE(tfz), tfx, _t(y))
    assert isinstance(tpost, tgp.SVGPPosterior)
    assert isinstance(tpost.approx.parametrization, tgp.Centered)
    got = (tq.mean, tq.cov(), tgp.vfe_elbo(tgp.VFE(tfz), tfx, _t(y)),
           tgp.approx_lml(tgp.VFE(tfz), tfx, _t(y)), tpost.mean(_t(xs)), tpost.var(_t(xs)))
    for a, b in zip(got, want):
        _close(a, b, 1e-10, 1e-12)


def test_torch_vfe_golden_equalities():
    """test_svgp.py:111: with z == x the SVGP at the optimal q equals exact
    GPR and the VFE posterior (1e-10), the collapsed bound equals the exact
    log evidence (1e-8), and with a jittered Kuu the collapsed bound equals
    the uncollapsed ELBO at the optimal q (1e-6)."""
    x, y, noise = _vfe_setup()
    _, kern = _kernels([0.2, 0.6])
    f = tgp.GP(kern)
    fx, fz, yt = f(_t(x), noise), f(_t(x), 0.0), _t(y)
    q = tgp.optimal_variational_posterior(fz, fx, yt)
    gpr = tgp.posterior(fx, yt)
    vfe = tgp.posterior(tgp.VFE(fz), fx, yt)
    svgp = tgp.posterior(tgp.SparseVariationalApproximation(fz, q, tgp.Centered()))
    xt = _t(x)
    for post in (gpr, vfe):
        _close(post.mean(xt), svgp.mean(xt).detach(), 0, 1e-10)
        _close(post.cov(xt), svgp.cov(xt).detach(), 0, 1e-10)
    ev = tgp.vfe_elbo(tgp.VFE(fz), fx, yt)
    _close(ev, fx.logpdf(yt).detach(), 1e-8)
    fzj = f(_t(x), 1e-8)
    qj = tgp.optimal_variational_posterior(fzj, fx, yt)
    ej = tgp.elbo(tgp.SparseVariationalApproximation(fzj, qj, tgp.Centered()), fx, yt)
    _close(tgp.vfe_elbo(tgp.VFE(fzj), fx, yt), ej.detach(), 1e-6)


# -- Poisson SVGP -------------------------------------------------------------------


def test_torch_poisson_svgp_elbo_and_gradients_match_jax():
    """test_svgp.py::test_poisson_svgp_elbo's problem (N = 40, M = 8, SE,
    Poisson exp link, analytic expectation) at a non-trivial q: the elbo
    and its gradients in m, the scale-tril and z, to 1e-10."""
    rng = np.random.default_rng(3)
    N, M = 40, 8
    x = np.sort(rng.uniform(0, 6, N))
    y = rng.poisson(np.exp(np.sin(x) + 0.5))
    m = 0.2 * rng.standard_normal(M)
    A = 0.8 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M)))
    z = x[::5]

    def jloss(m, A, z):
        f = agp.GP(agp.SqExponentialKernel())
        lf = agp.LatentGP(f, agp.PoissonLikelihood(), 1e-8)
        sva = agp.SparseVariationalApproximation(f(z, 1e-6), agp.MultivariateNormal(m, jnp.tril(A)))
        return agp.elbo(sva, lf(jnp.asarray(x)), jnp.asarray(y))

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(m), jnp.asarray(A), jnp.asarray(z))
    f = tgp.GP(tgp.SqExponentialKernel())
    lf = tgp.LatentGP(f, tgp.PoissonLikelihood(), 1e-8)
    mt, At, zt = _t(m, True), _t(A, True), _t(z, True)
    sva = tgp.SparseVariationalApproximation(f(zt, 1e-6), tgp.MultivariateNormal(mt, torch.tril(At)))
    tv = tgp.elbo(sva, lf(_t(x)), torch.tensor(y))
    tg = torch.autograd.grad(tv, (mt, At, zt))
    _close(tv, jv, 1e-10)
    for got, want in zip(tg, jg):
        _close(got, want, 1e-10, 1e-10 * np.abs(np.asarray(want)).max())


def test_torch_gram_fused_pullback_keeps_f32_digits_far_from_the_origin():
    """The gram-fused posterior build's pullback in f32, with 256 inducing
    points on [0, 100] (the Poisson cell's layout, cut down) and a
    non-trivial q: each gradient of the Poisson loss lies no further from
    the f64 plain path than max(1e-3, 2 × the plain f32 path's distance).
    With r² and Z̄s through the matmul identity (the JAX package's form) the
    kernel hyperparameters' gradient lay 4.9e-3 off (a CPU run), past the
    limit."""
    from approximategps_tpu_torch import convert

    rng = np.random.default_rng(30)
    xh = np.sort(rng.uniform(size=1024)) * 100.0
    x, y = torch.tensor(xh[:, None]), torch.tensor(rng.poisson(np.exp(np.sin(xh))))
    M = 256
    ps = {"k": np.array([0.5, 0.5]), "z": np.linspace(0.0, 100.0, M)[:, None],
          "m": 0.3 * rng.standard_normal(M),
          "A": 0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M)))}

    def grads(dtype, use_kernels):
        p = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in ps.items()}
        with tgp.config_context(use_kernels=use_kernels, solve_mode="inv_matmul"):
            loss = convert.poisson_svgp_loss(p, x.to(dtype), y, num_data=100_000)
            return torch.autograd.grad(loss, list(p.values()))

    ref = grads(torch.float64, False)
    for got, plain, want in zip(grads(torch.float32, True), grads(torch.float32, False), ref):
        scale = want.abs().max().item()
        e_got = (got.double() - want).abs().max().item() / scale
        e_plain = (plain.double() - want).abs().max().item() / scale
        assert e_got <= max(1e-3, 2 * e_plain), (e_got, e_plain)


# -- lbfgs_fit ------------------------------------------------------------------------


def test_torch_lbfgs_fit_quadratic():
    """test_lbfgs_fit_on_device's quadratic: the minimiser to 1e-6 in fewer
    than 100 iterations."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 4))
    Q, b = _t(A @ A.T + np.eye(4)), _t(rng.standard_normal(4))
    params, loss, n = tgp.lbfgs_fit(lambda p: 0.5 * p["x"] @ Q @ p["x"] - b @ p["x"],
                                    {"x": torch.zeros(4, dtype=torch.float64)})
    _close(params["x"], np.linalg.solve(Q.numpy(), b.numpy()), 0, 1e-6)
    assert n < 100
    _close(loss, -0.5 * b.numpy() @ np.linalg.solve(Q.numpy(), b.numpy()), 1e-10)


def test_torch_lbfgs_fit_vfe_hyperparameters_match_jax():
    """A VFE hyperparameter fit (raw variance, lengthscale and noise, M = 6
    inducing points): the port's final loss against the JAX lbfgs_fit's, to
    1e-6 relative (the line searches differ, the minimum is the same)."""
    x, y, _ = _vfe_setup()
    z = x[::4][:5]

    def jloss(p):
        f = agp.GP(jsoftplus(p[0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                           jsoftplus(p[1])))
        return -agp.vfe_elbo(agp.VFE(f(jnp.asarray(z), 1e-6)), f(jnp.asarray(x), jsoftplus(p[2])),
                             jnp.asarray(y))

    def tloss(p):
        f = tgp.GP(tsoftplus(p[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                           tsoftplus(p[1])))
        return -tgp.vfe_elbo(tgp.VFE(f(_t(z), 1e-6)), f(_t(x), tsoftplus(p[2])), _t(y))

    p0 = np.array([0.0, 0.0, -1.0])
    _, jl, _ = jtraining.lbfgs_fit(jloss, jnp.asarray(p0))
    p, tl, n = tgp.lbfgs_fit(tloss, _t(p0))
    assert 0 < n <= 200
    _close(tl, jl, 1e-6)
