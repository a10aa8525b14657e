"""The matrix-free Laplace approximation (``models/laplace_cg.py``) on the
CPU in f64: a counterpart of each test of ``tests/test_laplace_cg.py``
(against the port's dense Laplace at the JAX tests' tolerances), each also
holding the port to the JAX package on the same numpy inputs, and the
logdet(B) gradient against a dense oracle.

Routes: "resident" is ``storage="auto"`` below ``cg_dense_threshold`` (one
Gram a solve); "chunked" forces ``kernel_matvec``'s plain block path;
"fused" forces it through the ``gram_matvec`` autograd Function (its plain
inner pass on the CPU, its one-pass self-Gram pullback), row 5's route on
the card.  The JAX package runs its own defaults (XLA products off the
TPU).  The SLQ probes are made with numpy and handed to both packages (the
JAX side through a patched ``jax.random.normal``, whose signs it takes).
The port against the JAX package: 1e-8 relative to each array's largest
entry (CG to 1e-12 in f64 on both sides, in other summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu import test_utils as tu
from approximategps_tpu.models.laplace_cg import (
    LaplaceCG as JLaplaceCG,
    laplace_lml_cg as jlaplace_lml_cg,
    newton_inner_loop_cg as jnewton_cg,
)
from approximategps_tpu_torch import config_context
from approximategps_tpu_torch.core.gp import FiniteGP
from approximategps_tpu_torch.models import iterative as titer
from approximategps_tpu_torch.models import laplace as TL
from approximategps_tpu_torch.models import laplace_cg as TLC
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

TOL = 1e-8
ROUTES = {"resident": ("auto", "auto"), "chunked": ("chunked", "plain"),
          "fused": ("chunked", "fused")}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(t, j) -> float:
    t, j = _np(t), _np(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _setup(N=48):
    X, Y = tu.generate_data()
    return np.asarray(X)[:N], np.asarray(Y)[:N]


def _latent(theta, jitter=1e-8):
    kern = tsoftplus(theta[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                      tsoftplus(theta[1]))
    return tgp.LatentGP(tgp.GP(kern), tgp.BernoulliLikelihood(), jitter)


def _probes(P, N, seed=0):
    return np.sign(np.random.default_rng(seed).standard_normal((P, N)))


def _patched_normal(monkeypatch, probes):
    """``jax.random.normal`` returning ``probes`` (the JAX lml takes their
    signs)."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(probes, dtype))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("block_size", [None, 16])
def test_torch_laplace_cg_mode_matches_dense(block_size, route):
    """The CG mode against the port's dense mode (atol 1e-7, the JAX
    test's) and the JAX CG mode (1e-8), in the JAX package's Newton count."""
    X, Y = _setup()
    storage, mode = ROUTES[route]
    lfx = _latent(_t([1.2, 0.4]))(_t(X))
    kern = lfx.fx.f.kernel
    f_dense = TL.newton_inner_loop(lfx.lik, torch.tensor(Y),
                                   kern.gram(_t(X)) + 1e-10 * torch.eye(len(Y), dtype=torch.float64),
                                   maxiter=100, tol=1e-12)
    with config_context(matvec_mode=mode):
        f_cg, n = TLC.newton_inner_loop_cg(lfx.lik, torch.tensor(Y), kern, _t(X), maxiter=100,
                                           tol=1e-12, cg_tol=1e-12, block_size=block_size,
                                           storage=storage, return_niter=True)
    np.testing.assert_allclose(_np(f_cg), _np(f_dense), atol=1e-7)
    jlfx = tu.build_latent_gp(jnp.array([1.2, 0.4]))(X)
    jf, jn = jnewton_cg(jlfx.lik, Y, jlfx.fx.f.kernel, X, maxiter=100, tol=1e-12, cg_tol=1e-12,
                        block_size=block_size, return_niter=True)
    assert _rel(f_cg, jf) < TOL and n == int(jn)


@pytest.mark.parametrize("route", ["resident", "fused"])
def test_torch_laplace_cg_posterior_matches_dense(route):
    """Mean, variance and covariance against the dense posterior (atol
    1e-6, the JAX test's) and the JAX CG posterior (1e-8)."""
    X, Y = _setup()
    storage, mode = ROUTES[route]
    lfx = _latent(_t([1.2, 0.4]))(_t(X))
    xs = np.linspace(0.0, 20.0, 37)
    dense = tgp.posterior(tgp.LaplaceApproximation(tol=1e-12), lfx, torch.tensor(Y))
    with config_context(matvec_mode=mode):
        post = tgp.posterior(tgp.LaplaceCG(tol=1e-12, cg_tol=1e-12, storage=storage), lfx,
                             torch.tensor(Y))
        mu, var = post.mean_and_var(_t(xs))
        C = post.cov(_t(xs[:9]))
    mu_d, var_d = dense.mean_and_var(_t(xs))
    np.testing.assert_allclose(_np(mu), _np(mu_d), atol=1e-6)
    np.testing.assert_allclose(_np(var), _np(var_d), atol=1e-6)
    np.testing.assert_allclose(_np(C), _np(dense.cov(_t(xs[:9]))), atol=1e-6)
    jpost = agp.posterior(JLaplaceCG(tol=1e-12, cg_tol=1e-12),
                          tu.build_latent_gp(jnp.array([1.2, 0.4]))(X), Y)
    jmu, jvar = jpost.mean_and_var(jnp.asarray(xs))
    assert _rel(mu, jmu) < TOL and _rel(var, jvar) < TOL
    assert _rel(C, jpost.cov(jnp.asarray(xs[:9]))) < TOL


def test_torch_laplace_cg_lml_slq_close_to_dense(monkeypatch):
    """The SLQ lml within 0.25 of the dense lml (256 probes, 48 Lanczos
    steps: the JAX test's bound) and equal to the JAX SLQ lml on the same
    probes (1e-8)."""
    X, Y = _setup()
    probes = _probes(256, 48)
    lfx = _latent(_t([1.2, 0.4]))(_t(X))
    la = tgp.LaplaceCG(tol=1e-12, cg_tol=1e-12, num_probes=256, lanczos_iters=48)
    lml = tgp.approx_lml(la, lfx, torch.tensor(Y), probes=_t(probes))
    dense = tgp.approx_lml(tgp.LaplaceApproximation(tol=1e-12), lfx, torch.tensor(Y))
    assert abs(lml.item() - dense.item()) < 0.25, (lml.item(), dense.item())
    _patched_normal(monkeypatch, probes)
    jlml = agp.approx_lml(JLaplaceCG(tol=1e-12, cg_tol=1e-12, num_probes=256, lanczos_iters=48),
                          tu.build_latent_gp(jnp.array([1.2, 0.4]))(X), Y,
                          key=jax.random.PRNGKey(0))
    assert _rel(lml, jlml) < TOL


def test_torch_laplace_cg_lml_requires_generator():
    """Without a generator (or seed) or probes ``approx_lml`` raises, as the
    JAX one does without a key; an int seed makes its own probes."""
    X, Y = _setup()
    lfx = _latent(_t([1.2, 0.4]))(_t(X))
    with pytest.raises(ValueError, match="generator"):
        tgp.approx_lml(tgp.LaplaceCG(), lfx, torch.tensor(Y))
    la = tgp.LaplaceCG(num_probes=8, lanczos_iters=10)
    a = tgp.approx_lml(la, lfx, torch.tensor(Y), generator=3)
    b = tgp.approx_lml(la, lfx, torch.tensor(Y),
                       probes=TLC.rademacher_probes(3, 8, 48, torch.float64))
    assert np.isfinite(a.item()) and a.item() == b.item()


@pytest.mark.parametrize("route", list(ROUTES))
def test_torch_laplace_cg_ift_gradient_matches_dense(route):
    """d(Σ sin f̂)/dθ through the CG-IFT pullback against the dense IFT
    pullback (rtol 1e-6, atol 1e-8: the JAX test's) and the JAX CG
    gradient (1e-8)."""
    X, Y = _setup()
    storage, mode = ROUTES[route]

    def via_cg(theta):
        lfx = _latent(theta)(_t(X))
        with config_context(matvec_mode=mode):
            f = TLC.newton_inner_loop_cg(lfx.lik, torch.tensor(Y), lfx.fx.f.kernel, _t(X),
                                         maxiter=100, tol=1e-12, cg_tol=1e-12, storage=storage)
            return torch.sum(torch.sin(f))

    def via_dense(theta):
        lfx = _latent(theta)(_t(X))
        f = TL.newton_inner_loop(lfx.lik, torch.tensor(Y), lfx.fx.f.kernel.gram(_t(X)),
                                 maxiter=100, tol=1e-12)
        return torch.sum(torch.sin(f))

    grads = []
    for fn in (via_cg, via_dense):
        th = _t([1.1, 0.3], True)
        with config_context(matvec_mode=mode):
            grads.append(torch.autograd.grad(fn(th), th)[0])
    np.testing.assert_allclose(_np(grads[0]), _np(grads[1]), rtol=1e-6, atol=1e-8)

    def jvia_cg(theta):
        lfx = tu.build_latent_gp(theta)(X)
        f = jnewton_cg(lfx.lik, Y, lfx.fx.f.kernel, X, maxiter=100, tol=1e-12, cg_tol=1e-12)
        return jnp.sum(jnp.sin(f))

    assert _rel(grads[0], jax.grad(jvia_cg)(jnp.array([1.1, 0.3]))) < TOL


@pytest.mark.parametrize("route", ["resident", "fused"])
def test_torch_laplace_cg_ift_lik_and_target_gradients_match_dense(route):
    """The CG-IFT cotangents of a Gaussian likelihood's variance and of the
    (float) targets equal the dense IFT's (1e-8; CG to 1e-12)."""
    X, Y = _setup()
    y = np.sin(X / 3.0) + 0.3 * np.random.default_rng(2).standard_normal(48)
    storage, mode = ROUTES[route]
    kern = 1.2 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 2.0)
    w = torch.linspace(-1.0, 1.0, 48, dtype=torch.float64)
    grads = []
    for dense in (False, True):
        s2, yt = _t(0.3, True), _t(y, True)
        with config_context(matvec_mode=mode):
            if dense:
                f = TL.newton_inner_loop(tgp.GaussianLikelihood(s2), yt, kern.gram(_t(X)),
                                         tol=1e-12)
            else:
                f = TLC.newton_inner_loop_cg(tgp.GaussianLikelihood(s2), yt, kern, _t(X),
                                             tol=1e-12, cg_tol=1e-12, storage=storage)
            grads.append(torch.autograd.grad(torch.sum(torch.sin(f) * w), (s2, yt)))
    (gs, gy), (gs_d, gy_d) = grads
    assert _rel(gs, gs_d) < TOL and _rel(gy, gy_d) < TOL


@pytest.mark.parametrize("route", ["resident", "fused"])
def test_torch_laplace_cg_lml_gradients_match_dense(route, monkeypatch):
    """The lml's θ-gradient through the matrix-free path (Newton IFT, the
    cache at the fixed point, the stochastic-trace logdet) against the dense
    gradient within Hutchinson noise (1024 probes: 0.05·max + 0.02, the JAX
    test's) and the JAX gradient on the same probes (1e-8)."""
    X, Y = _setup()
    storage, mode = ROUTES[route]
    probes = _probes(1024, 48, seed=11)

    def via_cg(theta):
        lfx = _latent(theta)(_t(X))
        return TLC.laplace_lml_cg(lfx.lik, torch.tensor(Y), lfx.fx.f.kernel, _t(X),
                                  probes=_t(probes), lanczos_iters=48, maxiter=100, tol=1e-12,
                                  cg_tol=1e-12, storage=storage)

    def via_dense(theta):
        lfx = _latent(theta)(_t(X))
        return TL.laplace_lml(lfx.lik, torch.tensor(Y), lfx.fx.f.kernel.gram(_t(X)),
                              maxiter=100, tol=1e-12)

    out = []
    for fn in (via_cg, via_dense):
        th = _t([1.1, 0.3], True)
        with config_context(matvec_mode=mode):
            v = fn(th)
            out.append((v, torch.autograd.grad(v, th)[0]))
    (v, g), (_, g_dense) = out
    scale = g_dense.abs().max().item()
    np.testing.assert_allclose(_np(g), _np(g_dense), atol=0.05 * scale + 0.02)
    _patched_normal(monkeypatch, probes)

    def jvia_cg(theta):
        lfx = tu.build_latent_gp(theta)(X)
        return jlaplace_lml_cg(lfx.lik, Y, lfx.fx.f.kernel, X, jax.random.PRNGKey(11),
                               num_probes=1024, lanczos_iters=48, maxiter=100, tol=1e-12,
                               cg_tol=1e-12)

    jv, jg = jax.value_and_grad(jvia_cg)(jnp.array([1.1, 0.3]))
    assert _rel(v, jv) < TOL and _rel(g, jg) < 1e-7  # the surrogate's CG solves, 1e-12 each


@pytest.mark.parametrize("route", ["resident", "chunked"])
def test_torch_laplace_cg_builds_no_dense_gram(route, monkeypatch):
    """``posterior(LaplaceCG)`` and ``approx_lml`` never call ``fx.cov()``;
    on the chunked route no N × N Gram is built at all (every Gram the
    kernel forms has at most ``block_size`` rows or one column)."""
    X, Y = _setup(N=32)
    lfx = _latent(_t([1.2, 0.4]))(_t(X))
    storage = ROUTES[route][0]

    def boom(self):
        raise AssertionError("dense fx.cov() called in a matrix-free path")

    monkeypatch.setattr(FiniteGP, "cov", boom)
    shapes = []
    gram = tgp.SqExponentialKernel.gram

    def spy(self, x, z=None):
        out = gram(self, x, z)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(tgp.SqExponentialKernel, "gram", spy)
    la = tgp.LaplaceCG(tol=1e-10, cg_tol=1e-10, block_size=8, num_probes=8, lanczos_iters=20,
                       storage=storage)
    post = tgp.posterior(la, lfx, torch.tensor(Y))
    mu, var = post.mean_and_var(_t(np.linspace(0.0, 20.0, 9)))
    assert bool(torch.isfinite(mu).all() and torch.isfinite(var).all())
    lml = tgp.approx_lml(la, lfx, torch.tensor(Y), generator=0)
    assert np.isfinite(lml.item())
    full = [s for s in shapes if s == (32, 32)]
    assert (not full) if route == "chunked" else bool(full)
    if route == "chunked":
        assert all(min(s) == 1 or s[0] <= 8 or s[1] == 9 for s in shapes), shapes


@pytest.mark.parametrize("case", ["no kernel", "kernel", "above threshold", "no map"])
def test_torch_laplace_cg_auto_storage_takes_the_kernel_where_it_runs(case):
    """``storage="auto"`` builds the resident Gram only where the fused
    kernel does not run and N ≤ ``cg_dense_threshold``; where the kernel
    runs (``matvec_mode="fused"``: its Function, as on the card), or above
    the threshold, every product is a ``kernel_matvec``; a kernel the fused
    matvec does not take (a product) keeps the Gram.  Each operator's
    product equals the dense K·V + jitter·V (1e-12)."""
    X, _ = _setup(N=40)
    x = _t(X)
    kern = tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.7)
    if case == "no map":
        kern = kern * tgp.with_lengthscale(tgp.Matern32Kernel(), 2.0)
    mode = "fused" if case in ("kernel", "no map") else "auto"
    threshold = 16 if case == "above threshold" else 24576
    V = _t(np.random.default_rng(5).standard_normal((40, 3)))
    before = dict(titer.stats)
    with config_context(matvec_mode=mode, cg_dense_threshold=threshold):
        out = TLC._k_matvec(kern, x, 8, 1e-3)(V)
    used = {k: titer.stats[k] - before[k] for k in ("matvec_fused", "matvec_plain")}
    want = {"no kernel": (0, 0), "kernel": (1, 0), "above threshold": (0, 1),
            "no map": (0, 0)}[case]
    assert (used["matvec_fused"], used["matvec_plain"]) == want
    ref = kern.gram(x) @ V + 1e-3 * V
    assert _rel(out, ref) <= 1e-12


def test_torch_laplace_cg_operator_includes_latent_jitter(monkeypatch):
    """B = I + √W (K + jitter·I) √W: with a jitter of 1e-2 the CG posterior
    equals the dense one (atol 1e-8) and the SLQ lml lies within 0.2 of the
    dense lml (512 probes), the JAX tests' bounds; both equal the JAX
    package's."""
    X, Y = _setup()
    lfx = _latent(_t([1.2, 0.4]), jitter=1e-2)(_t(X))
    jlf = tu.build_latent_gp(jnp.array([1.2, 0.4]))
    jlfx = agp.LatentGP(jlf.f, jlf.lik, 1e-2)(X)
    xs = np.linspace(0.0, 20.0, 17)
    mu_d, var_d = tgp.posterior(tgp.LaplaceApproximation(tol=1e-12), lfx,
                                torch.tensor(Y)).mean_and_var(_t(xs))
    mu_c, var_c = tgp.posterior(tgp.LaplaceCG(tol=1e-12, cg_tol=1e-12), lfx,
                                torch.tensor(Y)).mean_and_var(_t(xs))
    np.testing.assert_allclose(_np(mu_c), _np(mu_d), atol=1e-8)
    np.testing.assert_allclose(_np(var_c), _np(var_d), atol=1e-8)
    jmu, jvar = agp.posterior(JLaplaceCG(tol=1e-12, cg_tol=1e-12), jlfx, Y).mean_and_var(
        jnp.asarray(xs))
    assert _rel(mu_c, jmu) < TOL and _rel(var_c, jvar) < TOL
    probes = _probes(512, 48, seed=3)
    lml = tgp.approx_lml(tgp.LaplaceCG(tol=1e-12, cg_tol=1e-12, num_probes=512,
                                       lanczos_iters=48), lfx, torch.tensor(Y), probes=_t(probes))
    dense = tgp.approx_lml(tgp.LaplaceApproximation(tol=1e-12), lfx, torch.tensor(Y))
    assert abs(lml.item() - dense.item()) < 0.2, (lml.item(), dense.item())
    _patched_normal(monkeypatch, probes)
    jlml = agp.approx_lml(JLaplaceCG(tol=1e-12, cg_tol=1e-12, num_probes=512, lanczos_iters=48),
                          jlfx, Y, key=jax.random.PRNGKey(3))
    assert _rel(lml, jlml) < TOL
    assert _rel(dense, agp.approx_lml(agp.LaplaceApproximation(tol=1e-12), jlfx, Y)) < 1e-10


@pytest.mark.parametrize("route", ["resident", "chunked", "fused"])
def test_torch_logdet_b_gradient_matches_dense_oracle(route):
    """The logdet(B) Function's gradient in √W, the kernel's variance and
    lengthscale, the inputs and the jitter against f64 autograd of
    logdet(I + √W (K + jitter·I) √W) to 1e-8: with the N probes √N·eᵢ the
    stochastic trace is exact.  (The JAX package's test of its rule,
    ``tests/test_ad_rules.py``, calls it with an old signature and fails.)"""
    N = 24
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0.0, 5.0, N))[:, None]
    w0 = 0.5 + 0.3 * np.abs(rng.standard_normal(N))
    storage, mode = ROUTES[route]
    probes = np.sqrt(N) * np.eye(N)

    def inputs():
        return (_t(w0, True), _t(1.3, True), _t(0.7, True), _t(x, True), _t(0.05, True))

    def kern(var, ell):
        return var * tgp.with_lengthscale(tgp.SqExponentialKernel(), ell)

    w, var, ell, xt, jit = ins = inputs()
    opts = TLC._SLQOptions(N, 1e-13, 2000, None, 0, storage)
    leaves, build = TLC._tree(TLC._LogdetInputs(w, kern(var, ell), xt, jit, _t(probes)))
    with config_context(matvec_mode=mode):
        val = TLC._LogdetBSLQ.apply(opts, build, *leaves)
        g = torch.autograd.grad(val, ins)
    w, var, ell, xt, jit = ref_ins = inputs()
    K = kern(var, ell).gram(xt) + jit * torch.eye(N, dtype=torch.float64)
    B = torch.eye(N, dtype=torch.float64) + w[:, None] * K * w[None, :]
    dense = torch.linalg.slogdet(B)[1]
    g_ref = torch.autograd.grad(dense, ref_ins)
    for name, a, b in zip(("Wsqrt", "variance", "lengthscale", "x", "jitter"), g, g_ref):
        assert _rel(a, b) < 1e-8, (name, _rel(a, b))
    assert abs(val.item() - dense.item()) < 1e-8 * abs(dense.item())
