"""The matrix-free exact GP (``models/iterative.py``), its hyperparameter
step (``utils/training.py::make_slq_hyperopt_step``) and the exact posterior
(``core/gp.py``) on the CPU in f64, against the JAX package on the same
numpy inputs.

The JAX package runs its XLA routes (its ``"auto"`` declines the Pallas
matvec off the TPU); the port runs its plain block path and, where the test
says ``fused``, the ``gram_matvec`` autograd Function with its plain inner
pass.  The probes of ``logpdf_slq`` are made with numpy and handed to both:
``jax.random.rademacher`` cannot be reproduced.  Tolerances are relative to
each array's largest entry: 1e-10 unless stated (f64, the same algorithm,
sums in other orders); ``logpdf_slq`` values 1e-9 and gradients 1e-7 (CG to
1e-12 inside, whose rounding the surrogate's solves carry)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.core.gp import logpdf as jax_logpdf
from approximategps_tpu.models import iterative as jiter
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu.utils.training import make_slq_hyperopt_step as jax_hyperopt_step
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.models import iterative as titer

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(t, j) -> float:
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _data(N, D=1, seed=0, span=8.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, span, (N, D))
    if D == 1:
        x = np.sort(x, axis=0)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(N)
    return x, y


def _kernels(name="m52", variance=1.5, lengthscale=0.8):
    jcls, tcls = {"m52": (agp.Matern52Kernel, tgp.Matern52Kernel),
                  "se": (agp.SqExponentialKernel, tgp.SqExponentialKernel)}[name]
    return (variance * agp.with_lengthscale(jcls(), lengthscale),
            variance * tgp.with_lengthscale(tcls(), lengthscale))


# -- cg_solve -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["vector", "block", "warm", "precond"])
def test_torch_cg_solve_matches_jax(case):
    rng = np.random.default_rng(1)
    n = 30
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    B = rng.standard_normal((n, 4))
    b = B[:, 0] if case == "vector" else B
    kw_j, kw_t = {}, {}
    if case == "warm":
        x0 = np.linalg.solve(K, B) + 0.01 * rng.standard_normal((n, 4))
        kw_j["x0"], kw_t["x0"] = jnp.asarray(x0), _t(x0)
    if case == "precond":
        d = np.diag(K)
        kw_j["M_inv"] = lambda r: r / jnp.asarray(d)[:, None]
        kw_t["M_inv"] = lambda r: r / _t(d)[:, None]
    Kj, Kt = jnp.asarray(K), _t(K)
    xj, itj = jiter.cg_solve(lambda v: Kj @ v, jnp.asarray(b), tol=1e-12, maxiter=200,
                             return_info=True, **kw_j)
    xt, itt = titer.cg_solve(lambda v: Kt @ v, _t(b), tol=1e-12, maxiter=200,
                             return_info=True, **kw_t)
    assert itt == int(itj)
    assert _rel(xt, xj) <= 1e-10
    assert _rel(xt, np.linalg.solve(K, b)) <= 1e-10


# -- kernel_matvec ------------------------------------------------------------


def _noise(kind, N, rng):
    if kind == "scalar":
        return 0.1
    if kind == "vector":
        return 0.05 + 0.1 * rng.uniform(size=N)
    R = rng.standard_normal((N, N)) / N
    return 0.1 * np.eye(N) + R @ R.T


@pytest.mark.parametrize("noise", ["scalar", "vector", "matrix"])
@pytest.mark.parametrize("route", ["full", "blocked", "fused"])
def test_torch_kernel_matvec_matches_jax(route, noise):
    rng = np.random.default_rng(2)
    x, _ = _data(45, D=2, seed=2)
    nz = _noise(noise, 45, rng)
    V = rng.standard_normal((45, 3))
    jk, tk = _kernels()
    block = 16 if route == "blocked" else None
    jmv = jax.jit(jiter.kernel_matvec(jk, jnp.asarray(x), jnp.asarray(nz), block))
    mode = "fused" if route == "fused" else "plain"
    before = dict(titer.stats)
    with tgp.config_context(matvec_mode=mode):
        tmv = titer.kernel_matvec(tk, _t(x), _t(nz), block)
        for v in (V, V[:, 0]):
            assert _rel(tmv(_t(v)), jmv(jnp.asarray(v))) <= 1e-10
    assert titer.stats[f"matvec_{mode}"] == before[f"matvec_{mode}"] + 2


# -- the preconditioner -------------------------------------------------------


@pytest.mark.parametrize("kernel,D,rank", [("se", 1, 20), ("m52", 2, 30)])
def test_torch_pivoted_cholesky_matches_jax(kernel, D, rank):
    """The pivots first (a pivot row holds its column's largest entry, by
    Cauchy-Schwarz on the residual), then L."""
    x, _ = _data(80, D=D, seed=3, span=10.0)
    jk, tk = _kernels(kernel, 1.5, 1.2)
    Lj = np.asarray(jiter.pivoted_cholesky(jk, jnp.asarray(x), rank))
    Lt = titer.pivoted_cholesky(tk, _t(x), rank)
    assert Lt.shape == (80, rank) and not Lt.requires_grad
    assert bool((Lj ** 2).sum(axis=0).min() > 0)  # every column above the pivot floor
    np.testing.assert_array_equal(Lt.abs().argmax(dim=0).numpy(), np.abs(Lj).argmax(axis=0))
    assert _rel(Lt, Lj) <= 1e-10


def _factor(N=60, rank=15, seed=4):
    x, _ = _data(N, seed=seed)
    jk, _ = _kernels()
    return np.asarray(jiter.pivoted_cholesky(jk, jnp.asarray(x), rank))


def test_torch_woodbury_preconditioner_matches_jax():
    Lk = _factor()
    rng = np.random.default_rng(5)
    V = rng.standard_normal((60, 3))
    pj = jax.jit(jiter.woodbury_preconditioner(jnp.asarray(Lk), 0.1))
    pt = titer.woodbury_preconditioner(_t(Lk), 0.1)
    for v in (V, V[:, 0]):
        assert _rel(pt(_t(v)), pj(jnp.asarray(v))) <= 1e-10
    with pytest.raises(ValueError, match="isotropic"):
        titer.woodbury_preconditioner(_t(Lk), _t(np.full(60, 0.1)))


def test_torch_precond_sqrt_ops_match_jax():
    Lk = np.concatenate([_factor(), np.zeros((60, 2))], axis=1)  # two dead columns
    rng = np.random.default_rng(6)
    V = rng.standard_normal((60, 3))
    hj, ldj = jiter._precond_sqrt_ops(jnp.asarray(Lk), 0.1)
    hj = jax.jit(hj, static_argnums=1)
    ht, ldt = titer._precond_sqrt_ops(_t(Lk), 0.1)
    assert abs(ldt.item() - float(ldj)) <= 1e-10 * abs(float(ldj))
    for v in (V, V[:, 0]):
        for sign in (1, -1):
            assert _rel(ht(_t(v), sign), hj(jnp.asarray(v), sign)) <= 1e-10


# -- Lanczos and the quadrature ----------------------------------------------


def _spd(n=48, seed=7):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T + n * np.eye(n), np.sign(rng.standard_normal((n, 7)))


def test_torch_lanczos_block_matches_per_probe_and_jax():
    A, V0 = _spd()
    At = _t(A)
    a_blk, b_blk = titer._lanczos_block(lambda v: At @ v, _t(V0), 12)
    for r in range(V0.shape[1]):
        a_r, b_r = titer._lanczos_block(lambda v: At @ v, _t(V0[:, r:r + 1]), 12)
        assert _rel(a_blk[:, r], a_r[:, 0]) <= 1e-10 and _rel(b_blk[:, r], b_r[:, 0]) <= 1e-10
    aj, bj = jiter._lanczos_block(lambda v: jnp.asarray(A) @ v, jnp.asarray(V0), 12)
    assert _rel(a_blk, aj) <= 1e-10 and _rel(b_blk, bj) <= 1e-10
    got = titer._slq_quadrature(a_blk, b_blk, 48, 1e-30)
    want = jiter._slq_quadrature(aj, bj, 48, 1e-30)
    assert abs(got.item() - float(want)) <= 1e-10 * abs(float(want))


def test_torch_lanczos_reorth_matches_jax():
    A, V0 = _spd(seed=8)
    At = _t(A)
    Qt, at, bt = titer._lanczos_basis(lambda v: At @ v, _t(V0[:, 0]), 20)
    Qj, aj, bj = jiter._lanczos_basis(lambda v: jnp.asarray(A) @ v, jnp.asarray(V0[:, 0]), 20)
    assert _rel(Qt, Qj) <= 1e-10 and _rel(at, aj) <= 1e-10 and _rel(bt, bj) <= 1e-10
    torch.testing.assert_close(Qt.T @ Qt, torch.eye(20, dtype=torch.float64), atol=1e-12,
                               rtol=0)


def test_torch_lanczos_basis_block_columns_are_their_own_recurrences():
    """A block start (n, S) runs each column's own reorthogonalized
    recurrence: each equals the single-vector call (1e-12)."""
    A, V0 = _spd(seed=9)
    At = _t(A)
    Q, a, b = titer._lanczos_basis(lambda v: At @ v, _t(V0), 20)
    assert Q.shape == (7, 48, 20) and a.shape == (20, 7) and b.shape == (19, 7)
    for r in range(V0.shape[1]):
        Qr, ar, br = titer._lanczos_basis(lambda v: At @ v, _t(V0[:, r]), 20)
        assert _rel(Q[r], Qr) <= 1e-12 and _rel(a[:, r], ar) <= 1e-12
        assert _rel(b[:, r], br) <= 1e-12


@pytest.mark.parametrize("num_iters", [64, 30])
def test_torch_msqrt_matvec_matches_sqrtm_and_jax(num_iters):
    """A^{1/2}b by Lanczos against the dense square root (full Krylov 1e-9,
    30 steps 5e-3: the JAX test's) and the JAX function (1e-10); a block of
    columns equals each column's own call."""
    rng = np.random.default_rng(5)
    N = 64
    R = rng.standard_normal((N, N))
    A = R @ R.T + 0.5 * np.eye(N)
    B = rng.standard_normal((N, 3))
    At = _t(A)
    out = titer.msqrt_matvec(lambda v: At @ v, _t(B[:, 0]), num_iters=num_iters)
    evals, evecs = np.linalg.eigh(A)
    ref = evecs @ (np.sqrt(evals) * (evecs.T @ B[:, 0]))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-9 if num_iters == N else 5e-3)
    want = jiter.msqrt_matvec(lambda v: jnp.asarray(A) @ v, jnp.asarray(B[:, 0]),
                              num_iters=num_iters)
    assert _rel(out, want) <= 1e-10
    blk = titer.msqrt_matvec(lambda v: At @ v, _t(B), num_iters=num_iters)
    for r in range(3):
        col = titer.msqrt_matvec(lambda v: At @ v, _t(B[:, r]), num_iters=num_iters)
        assert _rel(blk[:, r], col) <= 1e-12


def _patch_normals(monkeypatch, arrays):
    """``jax.random.normal`` handing out ``arrays`` in turn, so that the JAX
    samplers draw what the port's generator drew."""
    queue = list(arrays)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(queue.pop(0), dtype))


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_torch_sample_prior_msqrt_matches_jax(mode, monkeypatch):
    """Prior draws from the same normals as the JAX package's (1e-10), the
    S samples as one (N, S) block (one product a Lanczos step, the fused
    Function's where it serves); their covariance at 4000 draws within 0.12
    of K + σ²I (the JAX test's)."""
    N, S = 48, 16
    x = np.linspace(0, 5, N)
    jk = 1.3 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.8)
    tk = 1.3 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.8)
    Z = torch.randn((S, N), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    titer.reset_stats()
    with tgp.config_context(matvec_mode=mode):
        got = titer.sample_prior_msqrt(4, tk, _t(x), 0.05, S, lanczos_iters=40)
    assert titer.stats["matvec_" + mode] == 40 and got.shape == (S, N)
    _patch_normals(monkeypatch, [Z.numpy()])
    want = jiter.sample_prior_msqrt(jax.random.PRNGKey(0), jk, jnp.asarray(x), 0.05, S,
                                    lanczos_iters=40)
    assert _rel(got, want) <= 1e-10
    draws = titer.sample_prior_msqrt(torch.Generator().manual_seed(0), tk, _t(x), 0.05, 4000,
                                     lanczos_iters=40)
    K = tk.gram(_t(x)[:, None]) + 0.05 * torch.eye(N, dtype=torch.float64)
    assert (draws.T @ draws / 4000 - K).abs().max().item() < 0.12


def test_torch_sample_posterior_msqrt_matches_jax(monkeypatch):
    """Matheron samples from the same normals as the JAX package's (the
    joint prior's, then ε's; 1e-7: the joint prior's covariance carries a
    jitter of 1e-12 only, and the square root of its eigenvalues near 1e-12
    multiplies their rounding by about 10⁶), with the
    preconditioner; at 6000 draws their mean and covariance within 0.08 of
    the exact posterior's (the JAX test's)."""
    N, S = 40, 8
    x = np.linspace(0, 4, N)
    y = np.sin(x) + 0.2 * np.random.default_rng(9).standard_normal(N)
    xs = np.linspace(-0.5, 4.5, 11)
    jk = 1.5 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.9)
    tk = 1.5 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9)
    fx = tgp.GP(tk)(_t(x), 0.05)
    g = torch.Generator().manual_seed(2)
    Zj = torch.randn((S, N + 11), generator=g, dtype=torch.float64)
    Ze = torch.randn((S, N), generator=g, dtype=torch.float64)
    got = titer.sample_posterior_msqrt(2, fx, _t(y), _t(xs), S, lanczos_iters=48, tol=1e-10,
                                       precond_rank=10)
    _patch_normals(monkeypatch, [Zj.numpy(), Ze.numpy()])
    want = jiter.sample_posterior_msqrt(jax.random.PRNGKey(0), agp.GP(jk)(jnp.asarray(x), 0.05),
                                        jnp.asarray(y), jnp.asarray(xs), S, lanczos_iters=48,
                                        tol=1e-10, precond_rank=10)
    assert got.shape == (S, 11) and _rel(got, want) <= 1e-7
    draws = titer.sample_posterior_msqrt(torch.Generator().manual_seed(1), fx, _t(y), _t(xs),
                                         6000, lanczos_iters=48, tol=1e-10)
    mu, cov = tgp.posterior(fx, _t(y)).mean_and_cov(_t(xs))
    np.testing.assert_allclose(draws.mean(0).numpy(), mu.numpy(), atol=0.08)
    np.testing.assert_allclose(np.cov(draws.numpy().T, bias=True), cov.numpy(), atol=0.08)
    with pytest.raises(ValueError, match="isotropic"):
        titer.sample_posterior_msqrt(0, tgp.GP(tk)(_t(x), _t(np.full(N, 0.05))), _t(y),
                                     _t(xs), S)


# -- logpdf_slq: value and stochastic-trace gradients ------------------------

_SLQ_N, _SLQ_P, _SLQ_RANK = 200, 16, 20
# 12 Lanczos steps: on this well-conditioned N = 200 fixture the one-step
# recurrence has converged by about step 20, and past that point it turns
# rounding into new directions, so two implementations' T drift apart (7e-8
# in the value at 30 steps) though both are right to quadrature accuracy
_SLQ = dict(lanczos_iters=12, cg_tol=1e-12)
_THETA = np.log(np.expm1(np.array([1.5, 1.2, 0.1])))  # softplus⁻¹ of (σ², ℓ, σ²_noise)


def _jax_build(theta, x):
    kern = jsoftplus(theta[0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                      jsoftplus(theta[1]))
    return agp.GP(kern)(x, jsoftplus(theta[2]))


@functools.lru_cache(maxsize=None)
def _slq_case():
    x, y = _data(_SLQ_N, D=2, seed=9, span=10.0)
    rng = np.random.default_rng(10)
    probes = rng.choice([-1.0, 1.0], size=(_SLQ_P, _SLQ_N))
    # a carried factor from other hyperparameters (stale)
    stale = _jax_build(jnp.asarray(_THETA + np.array([0.4, -0.3, 0.0])), jnp.asarray(x))
    Lk = np.asarray(jiter.pivoted_cholesky(stale.f.kernel, jnp.asarray(x), _SLQ_RANK))
    return x, y, probes, Lk


@functools.lru_cache(maxsize=None)
def _jax_slq(precond):
    x, y, probes, Lk = _slq_case()

    def lml(theta, x, y):
        fx = _jax_build(theta, x)
        L, fresh = None, True
        if precond == "fresh":
            L = jax.lax.stop_gradient(jiter.pivoted_cholesky(fx.f.kernel, x, _SLQ_RANK))
        elif precond == "carried":
            L, fresh = jnp.asarray(Lk), False
        return jiter._logpdf_slq_core(_SLQ["lanczos_iters"], _SLQ["cg_tol"], 1000, None, False,
                                      True, fresh, None, "data", fx, y, jnp.asarray(probes), L)

    v, g = jax.jit(jax.value_and_grad(lml, argnums=(0, 1, 2)))(
        jnp.asarray(_THETA), jnp.asarray(x), jnp.asarray(y))
    return float(v), [np.asarray(a) for a in g]


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("precond", ["none", "fresh", "carried"])
def test_torch_logpdf_slq_matches_jax(precond, mode):
    """N = 200, D = 2, SE from θ = softplus⁻¹(1.5, 1.2, 0.1): the value to
    1e-9 and the gradients in θ, x and y to 1e-7 against ``_logpdf_slq_core``
    with the same probes; without a preconditioner, with a fresh factor, and
    with a carried stale one (Ritz floor eps, not 1)."""
    x, y, probes, Lk = _slq_case()
    jv, jg = _jax_slq(precond)
    theta, xt, yt = (_t(a).requires_grad_() for a in (_THETA, x, y))
    kw = dict(_SLQ, probes=_t(probes))
    if precond == "fresh":
        kw["precond_rank"] = _SLQ_RANK
    elif precond == "carried":
        kw["precond_Lk"] = _t(Lk)
    before = dict(titer.stats)
    with tgp.config_context(matvec_mode=mode):
        v = tgp.logpdf_slq(convert.build_exact_fx(theta, xt), yt, **kw)
        grads = torch.autograd.grad(v, (theta, xt, yt))
    used = {k: titer.stats[k] - before[k] for k in ("matvec_fused", "matvec_plain")}
    assert used[f"matvec_{'plain' if mode == 'fused' else 'fused'}"] == 0 and min(used.values()) == 0
    assert abs(v.item() - jv) <= 1e-9 * abs(jv)
    for what, g, j in zip(("theta", "x", "y"), grads, jg):
        assert _rel(g, j) <= 1e-7, (what, _rel(g, j))


@pytest.mark.parametrize("precond", ["none", "fresh"])
def test_torch_logpdf_slq_reorth_matches_jax(precond):
    """``reorth=True`` (every probe's recurrence reorthogonalized against
    its own basis, the probes as one block) against ``_logpdf_slq_core``
    with reorth, the same probes: the value to 1e-9."""
    x, y, probes, _ = _slq_case()

    def jlml(theta):
        fx = _jax_build(theta, jnp.asarray(x))
        L = None
        if precond == "fresh":
            L = jiter.pivoted_cholesky(fx.f.kernel, jnp.asarray(x), _SLQ_RANK)
        return jiter._logpdf_slq_core(_SLQ["lanczos_iters"], _SLQ["cg_tol"], 1000, None, True,
                                      True, True, None, "data", fx, jnp.asarray(y),
                                      jnp.asarray(probes), L)

    jv = float(jlml(jnp.asarray(_THETA)))
    kw = dict(_SLQ, probes=_t(probes), reorth=True)
    if precond == "fresh":
        kw["precond_rank"] = _SLQ_RANK
    v = tgp.logpdf_slq(convert.build_exact_fx(_t(_THETA), _t(x)), _t(y), **kw)
    assert abs(v.item() - jv) <= 1e-9 * abs(jv)


def test_torch_logpdf_slq_gradient_needs_no_value_solves():
    """The forward keeps only its inputs: a value without a gradient runs
    one CG solve (α), the backward two more (α again and W)."""
    x, y, probes, _ = _slq_case()
    fx = convert.build_exact_fx(_t(_THETA).requires_grad_(), _t(x))
    titer.reset_stats()
    with torch.no_grad():
        tgp.logpdf_slq(fx, _t(y), probes=_t(probes), **_SLQ)
    assert titer.stats["cg_solves"] == 1
    v = tgp.logpdf_slq(fx, _t(y), probes=_t(probes), **_SLQ)
    assert titer.stats["cg_solves"] == 2
    v.backward()
    assert titer.stats["cg_solves"] == 4
    assert titer.stats["cg_host_syncs"] >= titer.stats["cg_iterations"]


# -- posterior_cg -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_torch_posterior_cg_matches_jax(mode):
    x, y = _data(150, seed=11)
    xs = np.linspace(0.0, 8.0, 25)[:, None]
    jk, tk = _kernels("m52", 1.3, 0.9)

    @jax.jit
    def jax_serve(x, y, xs):
        post = jiter.posterior_cg(agp.GP(jk)(x, 0.01), y, tol=1e-12, precond_rank=20,
                                  block_size=16)
        return (*post.mean_and_var(xs), post.cov(xs))

    jmu, jvar, jcov = jax_serve(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
    with tgp.config_context(matvec_mode=mode):
        tpost = tgp.posterior_cg(tgp.GP(tk)(_t(x), 0.01), _t(y), tol=1e-12, precond_rank=20,
                                 block_size=16)
        assert isinstance(tpost, tgp.CGPosterior)
        tmu, tvar = tpost.mean_and_var(_t(xs))
        tcov = tpost.cov(_t(xs))
    assert _rel(tmu, jmu) <= 1e-10 and _rel(tvar, jvar) <= 1e-10 and _rel(tcov, jcov) <= 1e-10
    # and the dense exact posterior of the port
    emu, evar = tgp.core.gp.posterior(tgp.GP(tk)(_t(x), 0.01), _t(y)).mean_and_var(_t(xs))
    assert _rel(tmu, emu) <= 1e-8 and _rel(tvar, evar) <= 1e-8


# -- make_slq_hyperopt_step ---------------------------------------------------


def test_torch_make_slq_hyperopt_step_matches_jax(monkeypatch):
    """Four Adam steps against the JAX package's own step (optax's Adam)
    with the same probes: losses and θ to 1e-7; and the refresh schedule of
    ``tests/test_iterative.py``: step 1 (t = 0) skips the refresh, step 2
    carries, step 3 (t = 2) refreshes with moved hyperparameters."""
    x, y = _data(50, seed=12, span=6.0)
    probes = np.random.default_rng(13).choice([-1.0, 1.0], size=(8, 50))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype: jnp.asarray(probes, dtype).reshape(shape))
    kw = dict(learning_rate=0.1, precond_rank=12, refresh_every=2, lanczos_iters=30,
              cg_tol=1e-10)

    def jbuild(theta):
        kern = jax.nn.softplus(theta[0]) * agp.with_lengthscale(agp.Matern52Kernel(),
                                                                 jax.nn.softplus(theta[1]))
        return agp.GP(kern)(jnp.asarray(x), 0.1)

    def tbuild(theta):
        kern = torch.nn.functional.softplus(theta[0]) * tgp.with_lengthscale(
            tgp.Matern52Kernel(), torch.nn.functional.softplus(theta[1]))
        return tgp.GP(kern)(_t(x), 0.1)

    jstep, jinit = jax_hyperopt_step(jbuild, jnp.asarray(y), jax.random.PRNGKey(1),
                                     num_probes=8, **kw)
    tstep, tinit = tgp.make_slq_hyperopt_step(tbuild, _t(y), None, probes=_t(probes), **kw)
    jcarry = jinit(jnp.array([0.2, 0.2]))
    tcarry = tinit(_t([0.2, 0.2]))
    Lks = []
    for _ in range(4):
        Lks.append(tcarry[2].clone())
        jcarry, jloss = jstep(jcarry)
        tcarry, tloss = tstep(tcarry)
        assert abs(tloss.item() - float(jloss)) <= 1e-7 * abs(float(jloss))
        assert _rel(tcarry[0], jcarry[0]) <= 1e-7
        assert _rel(tcarry[2], jcarry[2]) <= 1e-10
    assert torch.equal(Lks[1], Lks[0]) and torch.equal(Lks[2], Lks[1])
    assert (Lks[3] - Lks[2]).abs().max() > 0
    assert isinstance(tcarry[1], torch.optim.Adam) and tcarry[3] == 4


def test_torch_optax_adam_is_the_default():
    """The default optimiser's constants are optax.adam's (β = 0.9, 0.999;
    ε = 1e-8 outside the square root)."""
    _, init = tgp.make_slq_hyperopt_step(lambda t: None, _t(np.zeros(4)), 0, precond_rank=0,
                                         learning_rate=0.1, num_probes=2)
    _, adam, Lk, t = init(_t([0.0]))
    group = adam.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (0.1, (0.9, 0.999), 1e-8)
    assert Lk is None and t == 0


# -- the exact posterior and logpdf (core/gp.py) -----------------------------


def test_torch_exact_logpdf_and_posterior_match_jax():
    x, y = _data(40, seed=14)
    xs = np.linspace(-1.0, 9.0, 11)[:, None]
    jk, tk = _kernels()

    @jax.jit
    def jax_exact(x, y, xs):
        fx = agp.GP(jk)(x, 0.1)
        post = agp.posterior(fx, y)
        return (jax_logpdf(fx, y), *post.mean_and_var(xs), post.mean_and_cov(xs)[1],
                post.cov(xs, xs[:4]))

    want, jmu, jvar, jcov, jcross = jax_exact(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
    tfx = tgp.GP(tk)(_t(x), 0.1)
    assert abs(tgp.logpdf(tfx, _t(y)).item() - float(want)) <= 1e-12 * abs(float(want))
    tpost = tgp.posterior(tfx, _t(y))
    assert isinstance(tpost, tgp.core.gp.PosteriorGP)
    tmu, tvar = tpost.mean_and_var(_t(xs))
    assert _rel(tmu, jmu) <= 1e-10 and _rel(tvar, jvar) <= 1e-10
    assert _rel(tpost.mean_and_cov(_t(xs))[1], jcov) <= 1e-10
    assert _rel(tpost.cov(_t(xs), _t(xs[:4])), jcross) <= 1e-10
    mu, var = tgp.core.gp.predict_in_blocks(tpost, _t(xs), block_size=4)
    assert _rel(mu, jmu) <= 1e-10 and _rel(var, jvar) <= 1e-10
