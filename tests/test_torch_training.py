"""The training slice's modules on the CPU, f64, against the JAX package:
the epilogue's pullback, ``chol_with_inv`` with its gradient, the minibatch
``elbo`` with its gradients, ``adam_fit``, and the repaired posterior build
that gradients now flow through.

The JAX package runs its Pallas kernels in interpret mode or its XLA
routes; the port, on CPU tensors, runs each kernel's plain version (the
closed-form pullbacks of its autograd Functions are what is checked).
Inputs come from numpy with a fixed seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.core.linalg import chol_with_inv as jax_chol_with_inv
from approximategps_tpu.ops.panel_chol import pallas_chol_inv
from approximategps_tpu.ops.svgp_epilogue import svgp_data_epilogue as jax_epilogue
from approximategps_tpu.utils import training as jtraining
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.core import linalg as tlinalg
from approximategps_tpu_torch.models import svgp as tsvgp
from approximategps_tpu_torch.ops import panel_chol, svgp_epilogue
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

KERNELS = {
    "se": (jk.SqExponentialKernel, tk.SqExponentialKernel),
    "matern52": (jk.Matern52Kernel, tk.Matern52Kernel),
}


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)


def _close(t, j, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


# -- kernel 3: the epilogue's pullback ---------------------------------------


def _epilogue_inputs(M=16, B=24, D=3, seed=0):
    rng = np.random.default_rng(seed)
    Zs = rng.standard_normal((M, D))
    Xs = rng.standard_normal((B, D))
    S0 = rng.standard_normal((M, M))
    Se = 0.5 * (S0 + S0.T)
    ae = rng.standard_normal(M)
    wm, wv = rng.standard_normal(B), rng.standard_normal(B)
    return (Xs, Zs, Se, ae), wm, wv


_LOSSES = {
    # the loss of test_svgp_epilogue.py's backward test, then each output alone
    "mu_and_var": lambda mu, var, wm, wv, np_: np_.sum(mu * wm) + np_.sum(np_.sin(var) * wv),
    "mu_only": lambda mu, var, wm, wv, np_: np_.sum(mu),
    "var_only": lambda mu, var, wm, wv, np_: np_.sum(var),
}


@pytest.mark.parametrize("loss", list(_LOSSES))
def test_torch_epilogue_grads_match_pallas_interpret(loss, monkeypatch):
    """All four cotangents against jax.grad of the Pallas epilogue in
    interpret mode (blocks 128 / 8), rtol 1e-10; on the CPU the port's
    backward is the closed form ``svgp_data_epilogue_bwd_plain``."""
    (Xs, Zs, Se, ae), wm, wv = _epilogue_inputs()
    lf = _LOSSES[loss]

    def jloss(*a):
        mu, var = jax_epilogue(*a, jk.SqExponentialKernel.k_of_r2, 128, 8)
        return lf(mu, var, jnp.asarray(wm), jnp.asarray(wv), jnp)

    with config_context(pallas_interpret=True, use_pallas=True):
        gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (Xs, Zs, Se, ae)))

    calls = []
    plain = svgp_epilogue.svgp_data_epilogue_bwd_plain
    monkeypatch.setattr(svgp_epilogue, "svgp_data_epilogue_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = svgp_epilogue.svgp_data_epilogue_bwd.launches
    ts = [_leaf(a) for a in (Xs, Zs, Se, ae)]
    mu, var = svgp_epilogue.svgp_data_epilogue(*ts, tk.SqExponentialKernel().kernel_map())
    lf(mu, var, torch.from_numpy(wm), torch.from_numpy(wv), torch).backward()
    assert calls == [1]
    assert svgp_epilogue.svgp_data_epilogue_bwd.launches == before
    for name, t, j in zip(("Xs", "Zs", "Se", "ae"), ts, gj):
        _close(t.grad, j, rtol=1e-10, atol=1e-12, what=name)


@pytest.mark.parametrize("tcls", [tk.Matern12Kernel, tk.Matern32Kernel, tk.Matern52Kernel],
                         ids=["m12", "m32", "m52"])
def test_torch_epilogue_bwd_plain_matches_autograd(tcls):
    """The closed-form pullback against autograd of the dense definition
    (exact broadcast distances), for the maps whose g′ is not taken
    through K."""
    (Xs, Zs, Se, ae), wm, wv = _epilogue_inputs(20, 33, 4, seed=3)
    ts = [_leaf(a) for a in (Xs, Zs, Se, ae)]
    K0 = tcls.k_of_r2(((ts[1][:, None, :] - ts[0][None, :, :]) ** 2).sum(-1))
    mu, var = K0.T @ ts[3], torch.einsum("aj,ab,bj->j", K0, ts[2], K0)
    dmu, dvar = torch.from_numpy(wm), torch.from_numpy(wv)
    ref = torch.autograd.grad((mu * dmu).sum() + (var * dvar).sum(), ts)
    got = svgp_epilogue.svgp_data_epilogue_bwd_plain(
        *(t.detach() for t in ts), dmu, dvar, tcls().kernel_map())
    for name, g, r in zip(("Xs", "Zs", "Se", "ae"), got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12, msg=name)


# -- kernel 4: (L, L⁻¹) of a given matrix, with its gradient ----------------


def _spd(M, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    A = (Q * np.geomspace(0.05, 5.0, M)) @ Q.T
    return A + 1e-3 * rng.standard_normal((M, M))  # the symmetric part is factored


def test_torch_chol_with_inv_matches_pallas_interpret():
    A = _spd(256, 0)
    Lj, Jj = jax.jit(lambda A: pallas_chol_inv(A, panel=64, interpret=True))(
        jnp.asarray(0.5 * (A + A.T)))
    L, J = tlinalg.chol_with_inv(torch.from_numpy(A))
    _close(L, Lj, rtol=0, atol=1e-11, what="L")
    _close(J, Jj, rtol=0, atol=1e-10, what="J")
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("cotangents", ["L_and_J", "J_only"])
def test_torch_chol_with_inv_grads_match_xla_route(cotangents, monkeypatch):
    A = _spd(96, 1)
    rng = np.random.default_rng(2)
    wL, wJ = rng.standard_normal((2, 96, 96))
    use_L = cotangents == "L_and_J"

    def jloss(A):
        L, J = jax_chol_with_inv(A)
        return (jnp.sum(L * wL) if use_L else 0.0) + jnp.sum(J * wJ)

    with config_context(chol_mode="xla"):
        (Lj, Jj), gj = jax_chol_with_inv(jnp.asarray(A)), jax.grad(jloss)(jnp.asarray(A))
    calls = []
    monkeypatch.setattr(panel_chol, "chol_inv_plain",
                        lambda A: calls.append(1) or tlinalg.chol_with_inv_plain(A))
    At = _leaf(A)
    L, J = tlinalg.chol_with_inv(At)
    ((L * torch.from_numpy(wL)).sum() * use_L + (J * torch.from_numpy(wJ)).sum()).backward()
    assert calls == [1]  # the CPU forward of the kernel route
    _close(L, Lj, rtol=0, atol=1e-11, what="L")
    _close(J, Jj, rtol=0, atol=1e-10, what="J")
    _close(At.grad, gj, rtol=1e-9, atol=1e-10, what="A_bar")


def test_torch_chol_with_inv_plain_mode_and_pullback_against_autograd(monkeypatch):
    """chol_mode="plain" skips the kernel route; the Φ-sandwich pullback
    equals autograd through torch.linalg."""
    A = _spd(40, 3)
    rng = np.random.default_rng(4)
    wL, wJ = (torch.from_numpy(w) for w in rng.standard_normal((2, 40, 40)))
    monkeypatch.setattr(panel_chol, "chol_inv", lambda A: pytest.fail("kernel route taken"))
    At = _leaf(A)
    with tgp.config_context(chol_mode="plain"):
        L, J = tlinalg.chol_with_inv(At)
    g, = torch.autograd.grad((L * wL).sum() + (J * wJ).sum(), At)
    At2 = _leaf(A)
    L2 = torch.linalg.cholesky(0.5 * (At2 + At2.T))
    J2 = torch.linalg.solve_triangular(L2, torch.eye(40, dtype=torch.float64), upper=False)
    g2, = torch.autograd.grad((L2 * wL).sum() + (J2 * wJ).sum(), At2)
    torch.testing.assert_close(g, g2, rtol=1e-9, atol=1e-10)


def test_torch_diag_quad_sym_pullback_against_autograd():
    rng = np.random.default_rng(5)
    S0 = rng.standard_normal((12, 12))
    S, K = _leaf(S0 + S0.T), _leaf(rng.standard_normal((12, 30)))
    w = torch.from_numpy(rng.standard_normal(30))
    gS, gK = torch.autograd.grad((tlinalg.diag_quad_sym(S, K) * w).sum(), (S, K))
    S2, K2 = _leaf(S0 + S0.T), _leaf(K.detach().numpy())
    rS, rK = torch.autograd.grad((torch.sum(K2 * (S2 @ K2), 0) * w).sum(), (S2, K2))
    torch.testing.assert_close(gK, rK, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gS, 0.5 * (rS + rS.T), rtol=1e-12, atol=1e-12)


# -- the minibatch step -------------------------------------------------------

M, B, D, NUM_DATA = 64, 128, 3, 1000


def _bench_params(seed=0):
    """bench.py's parameter dict with a non-trivial q."""
    rng = np.random.default_rng(seed)
    return {
        "k": np.array([0.4, -0.2]),
        "z": 1.2 * rng.standard_normal((M, D)),
        "m": 0.3 * rng.standard_normal(M),
        "A": 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M))),
    }


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D))
    return x, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(B)


def _jax_loss(jcls):
    def loss(p, xb, yb):
        kernel = jsoftplus(p["k"][0]) * agp.with_lengthscale(jcls(), jsoftplus(p["k"][1]))
        f = agp.GP(kernel)
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        sva = agp.SparseVariationalApproximation(f(p["z"], 1e-6), q)
        return -agp.elbo(sva, f(xb, 0.1), yb, num_data=NUM_DATA)

    return loss


def _torch_loss(tcls):
    def loss(p, xb, yb):
        kernel = tsoftplus(p["k"][0]) * tgp.with_lengthscale(tcls(), tsoftplus(p["k"][1]))
        f = tgp.GP(kernel)
        q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
        sva = tgp.SparseVariationalApproximation(f(p["z"], 1e-6), q)
        return -tgp.elbo(sva, f(xb, 0.1), yb, num_data=NUM_DATA)

    return loss


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_torch_elbo_value_and_grads_match_jax(kernel, monkeypatch):
    """The minibatch ELBO and its gradients for k, z, m and A, rtol 1e-8.
    The JAX reference takes its _whitened_cache_fused route (off the TPU its
    gram-fused composite declines); the port on the CPU takes its gram-fused
    Function, so this checks that Function's backward, and the data term
    declines the epilogue (no prefer)."""
    jcls, tcls = KERNELS[kernel]
    params = _bench_params()
    xb, yb = _batch(1)
    with config_context(solve_mode="inv_matmul"):
        vj, gj = jax.value_and_grad(_jax_loss(jcls))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xb), jnp.asarray(yb))
    probes = {"gram_chol_inv_plain": [], "svgp_data_epilogue_plain": []}
    for mod, name in ((panel_chol, "gram_chol_inv_plain"),
                      (svgp_epilogue, "svgp_data_epilogue_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _c=probes[name]: _c.append(1) or _f(*a))
    tp = {k: _leaf(v) for k, v in params.items()}
    gram_calls = []
    fused = tsvgp._WhitenedCacheFusedGram.apply
    monkeypatch.setattr(tsvgp._WhitenedCacheFusedGram, "apply",
                        lambda *a: gram_calls.append(1) or fused(*a))
    with tgp.config_context(solve_mode="inv_matmul"):
        vt = _torch_loss(tcls)(tp, torch.from_numpy(xb), torch.from_numpy(yb))
        vt.backward()
    assert gram_calls == [1] and probes["gram_chol_inv_plain"] == [1]
    assert probes["svgp_data_epilogue_plain"] == []
    _close(vt, vj, rtol=1e-8, what="loss")
    for k in params:
        _close(tp[k].grad, gj[k], rtol=1e-8, atol=1e-10, what=k)


def test_torch_adam_fit_matches_optax():
    """Three adam_fit steps on the same batches: torch.optim.Adam against
    optax.adam through the JAX package's adam_fit, rtol 1e-7."""
    params = _bench_params(2)
    batches = [_batch(10 + i) for i in range(3)]
    with config_context(solve_mode="inv_matmul"):
        pj, lj = jtraining.adam_fit(
            _jax_loss(jk.SqExponentialKernel), {k: jnp.asarray(v) for k, v in params.items()},
            [tuple(jnp.asarray(a) for a in b) for b in batches], learning_rate=1e-2)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    with tgp.config_context(solve_mode="inv_matmul"):
        pt, lt = tgp.adam_fit(_torch_loss(tk.SqExponentialKernel), tp,
                              [tuple(torch.from_numpy(a) for a in b) for b in batches],
                              learning_rate=1e-2)
    assert pt is tp and len(lt) == len(lj) == 3
    _close(torch.stack(lt), np.asarray(lj), rtol=1e-7, what="losses")
    for k in params:
        _close(pt[k], pj[k], rtol=1e-7, atol=1e-9, what=k)


def test_torch_adam_fit_takes_svgp_params_and_another_optimizer():
    params = tgp.init_svgp_params(torch.zeros((4, 2), dtype=torch.float64))
    sgd = lambda leaves: torch.optim.SGD(leaves, lr=0.5)  # noqa: E731
    out, losses = tgp.adam_fit(lambda p, c: (p.m - c).pow(2).sum(), params,
                               [(torch.ones(4, dtype=torch.float64),)] * 5, num_steps=2,
                               optimizer=sgd)
    assert out is params and len(losses) == 2
    torch.testing.assert_close(params.m.detach(), torch.ones(4, dtype=torch.float64))


# -- the repairs: gradients flow through the posterior build ----------------


# which cache outputs the loss reads: alpha and S_corr is the training
# step's fast path of the pullback; the others take the general assembly
_CACHE_OUTPUTS = {
    "alpha_and_S": ("alpha", "S_corr"),
    "alpha_only": ("alpha",),
    "all": ("alpha", "S_corr", "Lk_inv", "Kuu_L"),
}


@pytest.mark.parametrize("outputs", list(_CACHE_OUTPUTS))
@pytest.mark.parametrize("gram_chol", ["auto", "off"])
def test_torch_posterior_build_is_differentiable(gram_chol, outputs):
    """The sum of the chosen cache outputs from leaf tensors: gradients for
    z, m, A, both raw hyperparameters and the jitter, equal to the JAX
    package's.  "auto" takes the gram-fused Function (σ² and jitter reach it
    as tensors), "off" the given-Kuu one."""
    params = _bench_params(3)
    jitter = 1e-3
    names = _CACHE_OUTPUTS[outputs]
    # Lk_inv's entries grow with cond(Kuu): weight them down to the others'
    weights = {"alpha": 1.0, "S_corr": 1.0, "Lk_inv": 1e-2, "Kuu_L": 1.0}

    def jfn(p, jit):
        kernel = jsoftplus(p["k"][0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                             jsoftplus(p["k"][1]))
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        post = agp.posterior(agp.SparseVariationalApproximation(agp.GP(kernel)(p["z"], jit), q))
        return sum(weights[n] * jnp.sum(getattr(post.cache, n)) for n in names)

    with config_context(solve_mode="inv_matmul"):
        gj, gjit = jax.grad(jfn, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(jitter))
    tp = {k: _leaf(v) for k, v in params.items()}
    tjit = _leaf(jitter)
    with tgp.config_context(solve_mode="inv_matmul", gram_chol=gram_chol):
        kernel = tsoftplus(tp["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                              tsoftplus(tp["k"][1]))
        q = tgp.MultivariateNormal(tp["m"], torch.tril(tp["A"]))
        post = tgp.posterior(tgp.SparseVariationalApproximation(tgp.GP(kernel)(tp["z"], tjit), q))
        sum(weights[n] * getattr(post.cache, n).sum() for n in names).backward()
    for k in params:
        _close(tp[k].grad, gj[k], rtol=1e-8, atol=1e-10, what=k)
    _close(tjit.grad, gjit, rtol=1e-8, what="jitter")


def test_torch_three_argument_posterior_checks_the_prior():
    params = _bench_params(4)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    f = tgp.GP(0.8 * tgp.SqExponentialKernel())
    q = tgp.MultivariateNormal(tp["m"], torch.tril(tp["A"]))
    sva = tgp.SparseVariationalApproximation(f(tp["z"], 1e-6), q)
    x = torch.zeros((5, D), dtype=torch.float64)
    post = tgp.posterior(sva, f(x, 0.1), torch.zeros(5, dtype=torch.float64))
    assert post.cache.alpha.shape == (M,)
    tgp.posterior(sva, tgp.GP(0.8 * tgp.SqExponentialKernel())(x, 0.1), None)  # equal values
    with pytest.raises(ValueError, match="values differ"):
        tgp.posterior(sva, tgp.GP(0.7 * tgp.SqExponentialKernel())(x, 0.1), None)
    with pytest.raises(ValueError, match="not consistent"):
        tgp.posterior(sva, tgp.GP(0.8 * tgp.Matern32Kernel())(x, 0.1), None)


def test_torch_quadrature_matches_jax():
    """Gauss–Hermite against the JAX package's and against the closed form
    (exact for the Gaussian's quadratic log-density); Analytic raises for a
    likelihood without a closed form."""
    from approximategps_tpu.core import likelihoods as jlik
    from approximategps_tpu.core import quadrature as jquad
    from approximategps_tpu_torch.core import likelihoods as tlik
    from approximategps_tpu_torch.core import quadrature as tquad

    rng = np.random.default_rng(7)
    mean, var, y = rng.standard_normal(50), rng.uniform(0.01, 2.0, 50), rng.standard_normal(50)
    var[0] = -1e-12  # a variance from a cancellation: clamped at zero
    tl, jl = tlik.GaussianLikelihood(0.3), jlik.GaussianLikelihood(0.3)
    args_t = [torch.from_numpy(a) for a in (mean, var, y)]
    gh = tquad.expected_loglikelihood(tquad.GaussHermite(12), tl, *args_t)
    _close(gh, jquad.expected_loglikelihood(jquad.GaussHermite(12), jl,
                                            *(jnp.asarray(a) for a in (mean, var, y))),
           rtol=1e-12, what="GaussHermite")
    analytic = tquad.expected_loglikelihood(tquad.Analytic(), tl, *args_t)
    torch.testing.assert_close(gh[1:], analytic[1:], rtol=1e-12, atol=0)
    torch.testing.assert_close(
        tquad.expected_loglikelihood(tquad.DefaultExpectationMethod(), tl, *args_t), analytic)
    with pytest.raises(ValueError, match="no analytic"):
        tquad.Analytic().expected_loglik(tlik.Likelihood(), *args_t)


def test_torch_centered_approx_lml_matches_jax():
    """The Centered parametrization (prior KL through kl_divergence, the
    plain chol_with_inv route) through approx_lml with a LatentGP, value
    and gradients against the JAX package, rtol 1e-8."""
    params = _bench_params(5)
    xb, yb = _batch(6)

    def jloss(p):
        kernel = jsoftplus(p["k"][0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                             jsoftplus(p["k"][1]))
        f = agp.GP(kernel)
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        sva = agp.SparseVariationalApproximation(f(p["z"], 1e-6), q, agp.Centered())
        lfx = agp.LatentGP(f, agp.GaussianLikelihood(jnp.asarray(0.1)), 1e-6)(jnp.asarray(xb))
        return -agp.approx_lml(sva, lfx, jnp.asarray(yb), num_data=NUM_DATA)

    with config_context(solve_mode="inv_matmul"):
        vj, gj = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: _leaf(v) for k, v in params.items()}
    kernel = tsoftplus(tp["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                          tsoftplus(tp["k"][1]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(tp["m"], torch.tril(tp["A"]))
    sva = tgp.SparseVariationalApproximation(f(tp["z"], 1e-6), q, tgp.Centered())
    lfx = tgp.LatentGP(f, tgp.GaussianLikelihood(0.1), 1e-6)(torch.from_numpy(xb))
    with tgp.config_context(solve_mode="inv_matmul"):
        vt = -tgp.approx_lml(sva, lfx, torch.from_numpy(yb), num_data=NUM_DATA)
    vt.backward()
    _close(vt, vj, rtol=1e-8, what="loss")
    for k in params:
        _close(tp[k].grad, gj[k], rtol=1e-8, atol=1e-10, what=k)
