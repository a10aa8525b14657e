"""The PyTorch port's utilities on the CPU, f64: the hyperpriors and MAP
objective (``utils/priors.py``: values and gradients against the JAX
package to 1e-10 relative, and scipy's densities to 1e-12), checkpoints
(``utils/checkpoint.py``), minibatches (``utils/data.py``), profiling
(``utils/profiling.py``), the bijectors ``positive`` and
``fill_triangular_inverse``, ``DiagNormal``, ``ScaleTransform``,
``inducing_points`` and the ``SVGP`` alias, and ``test_utils`` (its fixed
data and latent GP against the JAX package's, its conformance checks run on
the port's Laplace, Vecchia and SVGP posteriors).  Counterparts of the
priors, checkpoint and data tests of ``tests/test_utils_and_ops.py``.
``test_utils`` is imported as a module: its functions are named ``test_*``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch
from scipy import stats

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu import test_utils as jtu
from approximategps_tpu.utils import bijectors as jbj
from approximategps_tpu.utils import priors as JP
from approximategps_tpu_torch import test_utils as ttu
from approximategps_tpu_torch.utils import bijectors as tbj
from approximategps_tpu_torch.utils import priors as TP
from approximategps_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from approximategps_tpu_torch.utils.data import epoch_batches, minibatch_iterator
from approximategps_tpu_torch.utils.profiling import StepTimer, named_scope, time_fn, trace

torch.set_num_threads(1)
TOL = 1e-10
CPU = torch.device("cpu")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# -- priors ----------------------------------------------------------------------------


def test_torch_priors_match_scipy():
    theta = _t([0.3, 1.7, 2.4])
    th = _np(theta)
    np.testing.assert_allclose(TP.normal_prior(0.5, 2.0)(theta).item(),
                               stats.norm.logpdf(th, 0.5, 2.0).sum(), rtol=1e-12)
    np.testing.assert_allclose(TP.lognormal_prior(0.1, 0.9)(theta).item(),
                               stats.lognorm.logpdf(th, 0.9, scale=np.exp(0.1)).sum(), rtol=1e-12)
    np.testing.assert_allclose(TP.gamma_prior(2.0, 3.0)(theta).item(),
                               stats.gamma.logpdf(th, 2.0, scale=1.0 / 3.0).sum(), rtol=1e-12)
    np.testing.assert_allclose(TP.halfnormal_prior(1.5)(theta).item(),
                               stats.halfnorm.logpdf(th, scale=1.5).sum(), rtol=1e-12)


_PRIORS = {"var": ("gamma_prior", (2.0, 1.0)), "ls": ("lognormal_prior", (0.1, 0.7)),
           "mu": ("normal_prior", (0.5, 2.0)), "s": ("halfnormal_prior", (1.5,))}


@pytest.mark.parametrize("transform", ["softplus", None])
def test_torch_log_prior_and_map_objective_match_jax(transform):
    """``log_prior`` (with softplus's log-Jacobian, or on the raw values)
    and ``map_objective``: values and gradients against the JAX package."""
    raw = {"var": np.array(0.3), "ls": np.array([0.2, 0.4]), "mu": np.array(0.9),
           "s": np.array(1.1)}
    jpri = {k: getattr(JP, n)(*a) for k, (n, a) in _PRIORS.items()}
    tpri = {k: getattr(TP, n)(*a) for k, (n, a) in _PRIORS.items()}
    jtr = jbj.softplus if transform else None
    ttr = tbj.softplus if transform else None

    def jneg(r):
        return jnp.sum(r["ls"] ** 2) + r["var"] * r["mu"]

    def tneg(r):
        return torch.sum(r["ls"] ** 2) + r["var"] * r["mu"]

    jobj = JP.map_objective(jneg, jpri, jtr)
    tobj = TP.map_objective(tneg, tpri, ttr)
    jv, jg = jax.value_and_grad(jobj)({k: jnp.asarray(v) for k, v in raw.items()})
    tr = {k: _t(v, True) for k, v in raw.items()}
    tv = tobj(tr)
    tg = torch.autograd.grad(tv, list(tr.values()))
    assert _rel(tv, jv) < TOL
    for k, g in zip(tr, tg):
        assert _rel(g, jg[k]) < TOL, k
    assert _rel(TP.log_prior(tr, tpri, ttr), JP.log_prior(
        {k: jnp.asarray(v) for k, v in raw.items()}, jpri, jtr)) < TOL


def test_torch_map_objective_jacobian_correction():
    """A sharp lognormal prior on the lengthscale pulls the MAP optimum of
    the Laplace objective toward the prior mode 1."""
    X, Y = ttu.generate_data(device=CPU)
    obj = tgp.build_laplace_objective(ttu.build_latent_gp, X, Y, newton_tol=1e-10)

    def neg_lml(raw):
        return obj(torch.stack([raw["var"], raw["ls"]]))

    map_obj = TP.map_objective(neg_lml, {"ls": TP.lognormal_prior(0.0, 0.05)})

    def minimize(fn):
        r = scipy.optimize.minimize(
            lambda t: float(fn({"var": _t(t[0]), "ls": _t(t[1])})), np.array([2.0, 2.0]),
            method="Nelder-Mead", options={"maxiter": 150})
        return r.x

    t_ml, t_map = minimize(neg_lml), minimize(map_obj)
    ls_ml = tbj.softplus(_t(t_ml[1])).item()
    ls_map = tbj.softplus(_t(t_map[1])).item()
    assert abs(np.log(ls_map)) < 0.25, ls_map
    assert abs(np.log(ls_map)) < abs(np.log(ls_ml)), (ls_ml, ls_map)


def test_torch_log_prior_gradients_finite():
    raw = {"var": _t(0.3, True), "ls": _t(-0.2, True)}
    lp = TP.log_prior(raw, {"var": TP.gamma_prior(2.0, 1.0), "ls": TP.lognormal_prior()})
    g = torch.autograd.grad(lp, list(raw.values()))
    assert all(bool(torch.isfinite(x)) for x in g)


# -- bijectors, distributions, kernels, SVGP names -------------------------------------


def test_torch_fill_triangular_inverse_and_positive_match_jax():
    rng = np.random.default_rng(0)
    n = 5
    flat = rng.standard_normal(n * (n + 1) // 2)
    L = tbj.fill_triangular(_t(flat), n)
    assert bool(torch.equal(L, torch.tril(L)))
    np.testing.assert_array_equal(_np(tbj.fill_triangular_inverse(L)), flat)
    np.testing.assert_array_equal(_np(tbj.fill_triangular_inverse(L)),
                                  np.asarray(jbj.fill_triangular_inverse(jnp.asarray(_np(L)))))
    assert tbj.tril_from_flat is tbj.fill_triangular
    assert tbj.flat_from_tril is tbj.fill_triangular_inverse
    x = rng.standard_normal(7)
    assert _rel(tbj.positive(_t(x)), jbj.positive(jnp.asarray(x))) < 1e-15
    y = _t([0.1, 1.0, 5.0, 20.0])
    np.testing.assert_allclose(_np(tbj.softplus(tbj.invsoftplus(y))), _np(y), rtol=1e-10)


def test_torch_diag_normal_matches_jax_and_samples():
    rng = np.random.default_rng(1)
    mean, var = rng.standard_normal(6), rng.uniform(0.2, 2.0, 6)
    x = rng.standard_normal((3, 6))
    jd = agp.DiagNormal(jnp.asarray(mean), jnp.asarray(var))
    td = tgp.DiagNormal(_t(mean), _t(var))
    assert _rel(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x))) < TOL
    assert _rel(td.stddev(), jd.stddev()) < 1e-15
    s = td.sample(torch.Generator().manual_seed(0), (100_000,))
    assert s.shape == (100_000, 6)
    np.testing.assert_allclose(_np(s.mean(0)), mean, atol=2e-2)
    np.testing.assert_allclose(_np(s.var(0)), var, rtol=3e-2)


def test_torch_finite_gp_marginals_sample_and_mvn_sample():
    f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.5))
    x = torch.linspace(0, 1, 4, dtype=torch.float64)
    fx = f(x, 0.1)
    m, v = fx.marginals().marginals()
    assert _rel(v, fx.var()) < 1e-15 and _rel(m + 1.0, fx.mean() + 1.0) < 1e-15
    s = fx.sample(torch.Generator().manual_seed(3), (50_000,))
    assert s.shape == (50_000, 4)
    np.testing.assert_allclose(np.cov(_np(s).T), _np(fx.cov()), atol=2e-2)
    assert fx.rand(torch.Generator().manual_seed(3)).shape == (4,)


def test_torch_scale_transform_inducing_points_and_svgp_alias():
    k = tgp.ScaleTransform(2.0)(tgp.SqExponentialKernel())
    jk = agp.ScaleTransform(2.0)(agp.SqExponentialKernel())
    X = np.linspace(0, 1, 5)
    assert isinstance(k, tgp.InputScaledKernel)
    assert _rel(k.gram(_t(X)), jk.gram(jnp.asarray(X))) < 1e-15
    fz = tgp.GP(k)(_t(X), 1e-6)
    q = tgp.MultivariateNormal(torch.zeros(5, dtype=torch.float64),
                               torch.eye(5, dtype=torch.float64))
    with pytest.warns(DeprecationWarning):
        sva = tgp.SVGP(fz, q)
    assert isinstance(sva.parametrization, tgp.Centered)
    assert tgp.inducing_points(tgp.posterior(sva)) is fz.x


# -- checkpoints -----------------------------------------------------------------------


def test_torch_checkpoint_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((3, 2), generator=gen, dtype=torch.float64),
              "nested": {"b": torch.arange(4.0), "n": np.arange(3.0)},
              "pack": tgp.SVGPParams(*(torch.randn(2, generator=gen) for _ in range(5))),
              "step": 12}
    path = save_checkpoint(str(tmp_path), params, step=7)
    assert os.path.basename(path) == "ckpt_000000007.pt" and latest_step(str(tmp_path)) == 7
    template = {"a": torch.zeros((3, 2), dtype=torch.float64),
                "nested": {"b": torch.zeros(4), "n": np.zeros(3)},
                "pack": tgp.SVGPParams(*(torch.zeros(2) for _ in range(5))), "step": 0}
    restored = restore_checkpoint(str(tmp_path), template)
    assert torch.equal(restored["a"], params["a"]) and restored["a"].dtype == torch.float64
    assert torch.equal(restored["nested"]["b"], params["nested"]["b"])
    np.testing.assert_array_equal(restored["nested"]["n"], params["nested"]["n"])
    assert isinstance(restored["pack"], tgp.SVGPParams)
    assert all(torch.equal(a, b) for a, b in zip(restored["pack"], params["pack"]))
    assert restored["step"] == 12
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), template)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"a": template["a"]})


def test_torch_async_checkpointer(tmp_path):
    """Every scheduled step lands, and updating the live tensors in place
    after ``save`` leaves the saved values as they were at the call."""
    params = {"a": torch.randn(8, generator=torch.Generator().manual_seed(1)),
              "s": torch.zeros(3)}
    saved = {}
    with AsyncCheckpointer(str(tmp_path), max_pending=2) as ck:
        for step in range(4):
            saved[step] = {k: v.clone() for k, v in params.items()}
            ck.save(params, step)
            for v in params.values():
                v.add_(1.0)
    assert latest_step(str(tmp_path)) == 3
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in (0, 3):
        restored = restore_checkpoint(str(tmp_path), template, step=step)
        assert torch.equal(restored["a"], saved[step]["a"])
        assert torch.equal(restored["s"], saved[step]["s"])


# -- minibatches -----------------------------------------------------------------------


def test_torch_minibatch_iterator():
    gen = torch.Generator().manual_seed(0)
    x = torch.arange(20.0)
    y = 2 * x
    batches = list(minibatch_iterator(gen, (x, y), batch_size=5, epochs=2))
    assert len(batches) == 8
    for xb, yb in batches:
        assert xb.shape == (5,)
        assert torch.equal(yb, 2 * xb)
    first = torch.sort(torch.cat([b[0] for b in batches[:4]])).values
    assert torch.equal(first, x)
    assert not torch.equal(torch.cat([b[0] for b in batches[:4]]),
                           torch.cat([b[0] for b in batches[4:]]))
    ordered = list(minibatch_iterator(gen, (x,), batch_size=5, epochs=1, shuffle=False))
    assert torch.equal(torch.cat([b[0] for b in ordered]), x)
    with pytest.raises(ValueError):
        next(minibatch_iterator(gen, (x,), batch_size=6, drop_remainder=False))
    eb = epoch_batches(gen, 20, 6)
    assert eb.shape == (3, 6) and len(set(eb.ravel().tolist())) == 18


# -- profiling -------------------------------------------------------------------------


def test_torch_profiling_helpers(tmp_path):
    """``trace`` writes a Chrome trace holding the ``named_scope`` label;
    the timers wait and summarise."""
    a = torch.randn(64, 64)
    with trace(str(tmp_path)):
        with named_scope("agp_labelled_region"):
            (a @ a).sum()
    files = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "agp_labelled_region" in names
    timer = StepTimer()
    for _ in range(3):
        timer.tick(out=(a @ a, {"x": a}))
    assert sorted(timer.summary()) == ["mean_ms", "min_ms", "n", "p50_ms", "steps_per_sec"]
    assert timer.summary()["n"] == 2
    assert time_fn(lambda: a @ a, warmup=1, iters=2) > 0.0


# -- test_utils ------------------------------------------------------------------------


def test_torch_test_utils_data_and_latent_gp_match_jax():
    X, Y = ttu.generate_data(device=CPU)
    JX, JY = jtu.generate_data()
    np.testing.assert_array_equal(_np(X), np.asarray(JX))
    np.testing.assert_array_equal(_np(Y), np.asarray(JY))
    theta = np.array([0.4, 1.3])
    tl, jl = ttu.build_latent_gp(_t(theta)), jtu.build_latent_gp(jnp.asarray(theta))
    assert _rel(tl(X).fx.cov(), jl(JX).fx.cov()) < TOL
    assert isinstance(tl.lik, tgp.BernoulliLikelihood)


def test_torch_test_utils_conformance_checks_pass_on_the_port():
    """The shipped checks on the port's Laplace approximation (predictions
    and evidence) and on Vecchia at k = N − 1 (evidence)."""
    ttu.test_approximation_predictions(tgp.LaplaceApproximation(), device=CPU)
    ttu.test_approx_lml(tgp.LaplaceApproximation(), device=CPU)
    ttu.test_approx_lml(tgp.NearestNeighbors(5), device=CPU)


@pytest.mark.parametrize("centered", [True, False], ids=["centered", "noncentered"])
def test_torch_check_internal_gp_interface_on_svgp(centered):
    f = tgp.GP(tgp.with_lengthscale(tgp.Matern52Kernel(), 0.8))
    z = torch.linspace(-1, 1, 5, dtype=torch.float64)
    q = tgp.MultivariateNormal(0.2 * torch.ones(5, dtype=torch.float64),
                               0.7 * torch.eye(5, dtype=torch.float64))
    par = tgp.Centered() if centered else tgp.NonCentered()
    post = tgp.posterior(tgp.SparseVariationalApproximation(f(z, 1e-6), q, par))
    gen = torch.Generator().manual_seed(0)
    ttu.check_internal_gp_interface(gen, post, torch.linspace(-1.2, 1.2, 6, dtype=torch.float64),
                                    torch.randn(7, generator=gen, dtype=torch.float64))
