"""The multi-latent SVGP of the PyTorch port (``models/multi_latent.py``) on
the CPU against the JAX package, f64: both likelihoods' log-densities, the
tensor-product Gauss–Hermite expectation and the Monte-Carlo one with
JAX's normals handed to the port, ``multi_latent_elbo``'s value and
gradients (``convert.heteroscedastic_svgp``'s model, and a softmax model),
each to 1e-10 relative to the largest entry; and a counterpart of each test
of ``tests/test_multi_latent.py`` on the port's own draws.  No JAX function
here reaches a Pallas kernel; the port runs row 1's plain version on the
CPU (the posterior builds take the triangular route there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.models.multi_latent import expected_loglik_multi as jax_ell
from approximategps_tpu.models.multi_latent import multi_latent_elbo as jax_elbo
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.models import multi_latent as tml

torch.set_num_threads(1)
TOL = 1e-10


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _moments(N=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, 2)), rng.uniform(0.05, 0.4, (N, 2)),
            rng.standard_normal(N))


def test_torch_gh_grid_is_the_jax_grid():
    from approximategps_tpu.models.multi_latent import _gh_grid as jgrid

    for n, L in ((5, 1), (7, 2), (4, 3)):
        jn, jw = jgrid(n, L)
        tn, tw = tml._gh_grid(n, L)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tw, jw)


def test_torch_expected_loglik_multi_gh_and_mc_match_jax():
    """Gauss–Hermite at 30 points a latent; Monte Carlo with the same
    normals (JAX's draws from its key, passed to the port's estimator)."""
    mu, var, y = _moments()
    lik_j, lik_t = agp.HeteroscedasticGaussianLikelihood(), tgp.HeteroscedasticGaussianLikelihood()
    gh_j = jax_ell(lik_j, jnp.asarray(mu), jnp.asarray(var), jnp.asarray(y), n_points=30)
    gh_t = tml.expected_loglik_multi(lik_t, _t(mu), _t(var), _t(y), n_points=30)
    assert _rel(gh_t, gh_j) < TOL
    key = jax.random.PRNGKey(4)
    mc_j = jax_ell(lik_j, jnp.asarray(mu), jnp.asarray(var), jnp.asarray(y), mc_key=key,
                   n_samples=64)
    eps = _t(jax.random.normal(key, (64,) + mu.shape))
    mc_t = tml._mc_expectation(lik_t, _t(mu), torch.sqrt(_t(var)), _t(y), eps)
    assert _rel(mc_t, mc_j) < TOL


def test_torch_gh_grid_matches_mc():
    """Tensor-product GH against the port's Monte Carlo (its generator,
    4·10⁵ draws) on the heteroscedastic likelihood."""
    mu, var, y = _moments(seed=1)
    lik = tgp.HeteroscedasticGaussianLikelihood()
    gh = tml.expected_loglik_multi(lik, _t(mu), _t(var), _t(y), n_points=30)
    mc = tml.expected_loglik_multi(lik, _t(mu), _t(var), _t(y),
                                   mc_generator=torch.Generator().manual_seed(0),
                                   n_samples=400_000)
    np.testing.assert_allclose(_np(gh), _np(mc), rtol=2e-2, atol=2e-2)


def test_torch_heteroscedastic_reduces_to_gaussian_when_logvar_frozen():
    """The log-variance latent pinned at log σ² with zero variance: the data
    term equals the single-latent Gaussian one."""
    from approximategps_tpu_torch.core.quadrature import GaussHermite, expected_loglikelihood

    rng = np.random.default_rng(2)
    N = 15
    mu = _t(rng.standard_normal(N))
    var = _t(rng.uniform(0.05, 0.3, N))
    y = torch.sin(mu)
    sigma2 = 0.17
    ell1 = expected_loglikelihood(GaussHermite(40), tgp.GaussianLikelihood(sigma2), mu, var, y)
    q_means = torch.stack([mu, torch.full((N,), np.log(sigma2), dtype=torch.float64)], -1)
    q_vars = torch.stack([var, torch.zeros(N, dtype=torch.float64)], -1)
    ell2 = tml.expected_loglik_multi(tgp.HeteroscedasticGaussianLikelihood(), q_means, q_vars, y,
                                     n_points=40)
    np.testing.assert_allclose(_np(ell2), _np(ell1), rtol=1e-8)


def test_torch_softmax_two_class_matches_sigmoid_structure():
    rng = np.random.default_rng(3)
    F = _t(rng.standard_normal((10, 2)))
    y = torch.tensor((rng.uniform(size=10) > 0.5).astype(np.int64))
    lp = tgp.SoftmaxLikelihood(2).log_prob(F, y)
    gap = torch.where(y == 1, F[:, 1] - F[:, 0], F[:, 0] - F[:, 1])
    np.testing.assert_allclose(_np(lp), _np(torch.nn.functional.logsigmoid(gap)), rtol=1e-12)


@pytest.mark.parametrize("C", [2, 3, 5])
def test_torch_softmax_log_prob_matches_jax(C):
    rng = np.random.default_rng(C)
    F = rng.standard_normal((4, 6, C))
    y = rng.integers(0, C, (4, 6))
    lp_j = agp.SoftmaxLikelihood(C).log_prob(jnp.asarray(F), jnp.asarray(y))
    lp_t = tgp.SoftmaxLikelihood(C).log_prob(_t(F), torch.tensor(y))
    assert _rel(lp_t, lp_j) < TOL
    lp_j = agp.HeteroscedasticGaussianLikelihood().log_prob(jnp.asarray(F[..., :2]),
                                                           jnp.asarray(F[..., 0]))
    lp_t = tgp.HeteroscedasticGaussianLikelihood().log_prob(_t(F[..., :2]), _t(F[..., 0]))
    assert _rel(lp_t, lp_j) < TOL


def test_torch_conditional_samples_have_the_likelihoods_moments():
    gen = torch.Generator().manual_seed(5)
    F = torch.tensor([[0.5, np.log(0.09)]], dtype=torch.float64).expand(200_000, 2)
    s = tgp.HeteroscedasticGaussianLikelihood().conditional_sample(gen, F)
    assert abs(s.mean().item() - 0.5) < 5e-3 and abs(s.var().item() - 0.09) < 3e-3
    logits = torch.tensor([[0.0, 1.0, -1.0]], dtype=torch.float64).expand(200_000, 3)
    c = tgp.SoftmaxLikelihood(3).conditional_sample(gen, logits)
    freq = torch.bincount(c, minlength=3).double() / c.shape[0]
    np.testing.assert_allclose(_np(freq), _np(torch.softmax(logits[0], 0)), atol=5e-3)


def _hetero_params(M=6, D=2, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for tag, k in (("mean", [0.5, 0.5]), ("logvar", [0.3, 1.2])):
        out[tag] = {"k": np.array(k), "z": rng.standard_normal((M, D)),
                    "m": 0.3 * rng.standard_normal(M),
                    "A": 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M)))}
    return out


def _jax_hetero(params, jitter=1e-6):
    svas = []
    for tag in ("mean", "logvar"):
        p = params[tag]
        kern = jax.nn.softplus(p["k"][0]) * agp.with_lengthscale(
            agp.SqExponentialKernel(), jax.nn.softplus(p["k"][1]))
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        svas.append(agp.SparseVariationalApproximation(agp.GP(kern)(p["z"], jitter), q))
    return agp.MultiLatentSVGP(tuple(svas), agp.HeteroscedasticGaussianLikelihood())


def test_torch_multi_latent_elbo_matches_jax():
    """``convert.heteroscedastic_loss`` (GH, 10 points a latent, a minibatch
    scaled to num_data) against the JAX ELBO: value and the gradients in
    every parameter of both latents."""
    params = _hetero_params()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((20, 2))
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(20)

    def jloss(p):
        return -jax_elbo(_jax_hetero(p), jnp.asarray(x), jnp.asarray(y), num_data=500, n_gh=10)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = {tag: {k: _t(v, True) for k, v in d.items()} for tag, d in params.items()}
    tv = convert.heteroscedastic_loss(tp, _t(x), _t(y), num_data=500, n_gh=10)
    leaves = [tp[tag][k] for tag in tp for k in tp[tag]]
    tg = torch.autograd.grad(tv, leaves)
    assert _rel(tv, jv) < TOL
    for (tag, k), g in zip([(tag, k) for tag in tp for k in tp[tag]], tg):
        assert _rel(g, jg[tag][k]) < TOL, (tag, k)


def test_torch_softmax_elbo_posterior_and_approx_lml_match_jax():
    """A 3-class model: ``multi_latent_elbo`` = ``approx_lml`` in both
    packages, and ``posterior`` gives each latent's posterior."""
    C, M = 3, 5
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 6, 30)
    y = np.clip(x // 2.0, 0, C - 1).astype(np.int64)
    z = np.linspace(0, 6, M)
    ms = 0.2 * rng.standard_normal((C, M))

    def build(pkg, t):
        f = pkg.GP(2.0 * pkg.with_lengthscale(pkg.SqExponentialKernel(), 1.0))
        svas = tuple(pkg.SparseVariationalApproximation(
            f(t(z), 1e-6), pkg.MultivariateNormal(t(ms[c]), 0.8 * t(np.eye(M))))
            for c in range(C))
        return pkg.MultiLatentSVGP(svas, pkg.SoftmaxLikelihood(C)), f

    jml, jf = build(agp, jnp.asarray)
    tml_, tf = build(tgp, _t)
    jv = agp.approx_lml(jml, jf(jnp.asarray(x)), jnp.asarray(y), n_gh=6)
    tv = tgp.approx_lml(tml_, tf(_t(x)), torch.tensor(y), n_gh=6)
    assert _rel(tv, jv) < TOL
    assert _rel(tv, tml.multi_latent_elbo(tml_, _t(x), torch.tensor(y), n_gh=6)) < 1e-15
    tposts, jposts = tgp.posterior(tml_), agp.posterior(jml)
    assert len(tposts) == C
    xt = np.linspace(0, 6, 7)
    for tp, jp in zip(tposts, jposts):
        assert _rel(tp.mean(_t(xt)), jp.mean(jnp.asarray(xt))) < TOL


def _train(loss, params, steps, lr):
    opt = torch.optim.Adam(params, lr=lr)
    vals = []
    for _ in range(steps):
        opt.zero_grad()
        v = loss()
        v.backward()
        opt.step()
        vals.append(v.item())
    return np.array(vals)


def test_torch_heteroscedastic_training_recovers_noise_field():
    """Noise s.d. ramping 0.05 → 0.8 over the inputs: after Adam the learned
    log-variance rises left to right by at least half the true log ratio,
    and the mean latent tracks sin(x) where the noise is low."""
    N, M = 400, 24
    x = torch.linspace(-3.0, 3.0, N, dtype=torch.float64)
    sd = 0.05 + 0.75 * (x - x.min()) / (x.max() - x.min())
    gen = torch.Generator().manual_seed(0)
    y = torch.sin(x) + sd * torch.randn(N, generator=gen, dtype=torch.float64)
    z = torch.linspace(-3.0, 3.0, M, dtype=torch.float64)
    p = {"k_m": _t([0.5, 0.5], True), "m_m": _t(np.zeros(M), True), "A_m": _t(np.eye(M), True),
         "k_v": _t([0.5, 1.5], True), "m_v": _t(np.full(M, -1.0), True),
         "A_v": _t(np.eye(M) * 0.3, True)}

    def build():
        svas = []
        for tag in ("m", "v"):
            k = p[f"k_{tag}"]
            f = tgp.GP(tgp.utils.softplus(k[0]) * tgp.with_lengthscale(
                tgp.SqExponentialKernel(), tgp.utils.softplus(k[1])))
            q = tgp.MultivariateNormal(p[f"m_{tag}"], torch.tril(p[f"A_{tag}"]))
            svas.append(tgp.SparseVariationalApproximation(f(z, 1e-6), q))
        return tgp.MultiLatentSVGP(tuple(svas), tgp.HeteroscedasticGaussianLikelihood())

    vals = _train(lambda: -tgp.multi_latent_elbo(build(), x, y, n_gh=10), list(p.values()),
                  800, 3e-2)
    assert np.isfinite(vals).all() and vals[-1] < vals[0]
    with torch.no_grad():
        post_m, post_v = tgp.posterior(build())
        logvar = post_v.mean(torch.tensor([-2.5, 2.5], dtype=torch.float64))
        true_gap = 2 * (np.log(0.8) - np.log(0.05 + 0.75 / 6))
        assert float(logvar[1] - logvar[0]) > 0.5 * true_gap, logvar
        xl = torch.tensor([-2.0, -1.0], dtype=torch.float64)
        np.testing.assert_allclose(_np(post_m.mean(xl)), _np(torch.sin(xl)), atol=0.25)


def test_torch_softmax_classification_learns():
    """Three bands of classes: Adam lifts the accuracy above 0.9."""
    N, M, C = 300, 16, 3
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(N, generator=gen, dtype=torch.float64) * 6.0
    y = torch.clamp((x // 2.0).long(), 0, C - 1)
    z = torch.linspace(0.0, 6.0, M, dtype=torch.float64)
    m = torch.zeros((C, M), dtype=torch.float64, requires_grad=True)
    A = torch.eye(M, dtype=torch.float64).repeat(C, 1, 1).requires_grad_()
    f = tgp.GP(2.0 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.0))

    def build():
        return tgp.MultiLatentSVGP(tuple(tgp.SparseVariationalApproximation(
            f(z, 1e-6), tgp.MultivariateNormal(m[c], torch.tril(A[c]))) for c in range(C)),
            tgp.SoftmaxLikelihood(C))

    _train(lambda: -tgp.multi_latent_elbo(build(), x, y, n_gh=8), [m, A], 400, 5e-2)
    with torch.no_grad():
        logits = torch.stack([p.mean(x) for p in tgp.posterior(build())], -1)
        acc = float((torch.argmax(logits, -1) == y).double().mean())
    assert acc > 0.9, acc
