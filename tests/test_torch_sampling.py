"""Pathwise sampling of the PyTorch port (``models/sampling.py``) on the CPU
against the JAX package, f64.

Parity: JAX's draws are rebuilt here with ``jax.random`` on the JAX
sampler's own key-split sequence (``rff_features``: split(key) into ω's and
b's keys, a Matérn's ω key split again into z's and g's; the samplers:
split(key, 3) into φ's, w's and u's or ε's keys) and handed to the port's
deterministic pathwise part; the sample functions then agree with the JAX
ones to 1e-10 relative to the largest entry (the RFF map and the SVGP
sampler), and to 1e-8 through the CG solve at tol 1e-10.  Moments: the
port's own generator draws against the kernel (RFF, atol 2e-2 at 2·10⁵
features) and the posterior (2000 samples, atol 0.1), as the JAX tests
hold the JAX draws.  No JAX function here reaches a Pallas kernel; the
port's row 5 and row 11 routes run their plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.models import sampling as jsampling
from approximategps_tpu.models.vfe import optimal_variational_posterior as jax_opt_q
from approximategps_tpu_torch.models import sampling as tsampling

torch.set_num_threads(1)
TOL = 1e-10
CG_TOL = 1e-8

# (name, variance, lengthscale, spectral ν: None for SE)
KERNELS = [("se", 2.0, 0.7, None), ("m32", 1.0, 1.2, 3), ("m52", 0.5, 1.0, 5),
           ("m12", 1.0, 1.0, 1)]
_BASES = {None: "SqExponentialKernel", 1: "Matern12Kernel", 3: "Matern32Kernel",
          5: "Matern52Kernel"}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _kernels(var, ls, df):
    base = _BASES[df]
    return (var * agp.with_lengthscale(getattr(agp, base)(), ls),
            var * tgp.with_lengthscale(getattr(tgp, base)(), ls))


def _jax_rff_draws(key, df, D, F):
    """ω and b as ``rff_features`` draws them from ``key``."""
    k_omega, k_b = jax.random.split(key)
    if df is None:
        omega = jax.random.normal(k_omega, (F, D))
    else:
        kz, kg = jax.random.split(k_omega)
        z = jax.random.normal(kz, (F, D))
        g = 2.0 * jax.random.gamma(kg, df / 2.0, (F, 1))
        omega = z * jnp.sqrt(df / g)
    b = jax.random.uniform(k_b, (F,), maxval=2.0 * np.pi)
    return tsampling.RFFDraws(_t(omega), _t(b))


@pytest.mark.parametrize("name,var,ls,df", KERNELS, ids=[k[0] for k in KERNELS])
def test_torch_rff_map_matches_jax(name, var, ls, df):
    """The same ω and b through both feature maps, D = 2."""
    jk, tk = _kernels(var, ls, df)
    key = jax.random.PRNGKey(3)
    X = np.random.default_rng(0).standard_normal((11, 2))
    jphi = jsampling.rff_features(key, jk, 2, 64)
    tphi = tsampling.rff_map(tk, _jax_rff_draws(key, df, 2, 64))
    assert _rel(tphi(_t(X)), jphi(jnp.asarray(X))) < TOL


@pytest.mark.parametrize("name,var,ls,df", KERNELS, ids=[k[0] for k in KERNELS])
def test_torch_rff_approximates_kernel(name, var, ls, df):
    """The port's own draws (χ²_ν as ν squared normals for a Matérn):
    φφᵀ ≈ K at 2·10⁵ features."""
    _, tk = _kernels(var, ls, df)
    X = torch.linspace(-1.5, 1.5, 9, dtype=torch.float64)[:, None]
    gen = torch.Generator().manual_seed(1)
    P = tgp.rff_features(gen, tk, 1, 200_000, dtype=torch.float64)(X)
    np.testing.assert_allclose(_np(P @ P.T), _np(tk.gram(X)), atol=2e-2)


def test_torch_rff_draw_dtype_device_and_unsupported_kernels():
    gen = torch.Generator().manual_seed(0)
    draws = tsampling.draw_rff(gen, tgp.Matern32Kernel(), 3, 16, dtype=torch.float64)
    assert draws.omega.shape == (16, 3) and draws.b.shape == (16,)
    assert draws.omega.dtype == torch.float64 and draws.omega.device.type == "cpu"
    assert bool((draws.b >= 0).all() and (draws.b < 2 * np.pi).all())
    seeded = tsampling.draw_rff(0, tgp.SqExponentialKernel(), 2, 8, device="cpu")
    assert seeded.omega.device.type == "cpu" and seeded.omega.dtype == torch.float32
    for kern in (tgp.RationalQuadraticKernel(), tgp.PeriodicKernel(),
                 tgp.SqExponentialKernel() + tgp.Matern12Kernel()):
        with pytest.raises(NotImplementedError):
            tsampling.draw_rff(gen, kern, 1, 4)


def _svgp_pair(centered: bool):
    """One SVGP posterior in both packages: z on [0, 3], q from numpy."""
    rng = np.random.default_rng(5)
    M = 6
    z = np.linspace(0.0, 3.0, M)
    m = 0.3 * rng.standard_normal(M)
    L = np.tril(0.1 * rng.standard_normal((M, M)), -1) + np.diag(0.4 + 0.3 * rng.uniform(size=M))
    jk, tk = _kernels(1.5, 0.8, None)
    jpar = agp.Centered() if centered else agp.NonCentered()
    tpar = tgp.Centered() if centered else tgp.NonCentered()
    jpost = agp.posterior(agp.SparseVariationalApproximation(
        agp.GP(jk)(jnp.asarray(z), 1e-6), agp.MultivariateNormal(jnp.asarray(m), jnp.asarray(L)),
        jpar))
    tpost = tgp.posterior(tgp.SparseVariationalApproximation(
        tgp.GP(tk)(_t(z), 1e-6), tgp.MultivariateNormal(_t(m), _t(L)), tpar))
    return jpost, tpost


@pytest.mark.parametrize("gram_mode", ["auto", "fused"])
@pytest.mark.parametrize("centered", [True, False], ids=["centered", "noncentered"])
def test_torch_svgp_pathwise_matches_jax(centered, gram_mode):
    """sample_svgp_functions' draws rebuilt from the JAX key, the port's
    pathwise part against the JAX sampler; ``gram_mode="fused"`` puts the
    cross-Gram on row 11's plain version."""
    jpost, tpost = _svgp_pair(centered)
    S, F, M = 7, 128, 6
    key = jax.random.PRNGKey(11)
    k_phi, k_w, k_u = jax.random.split(key, 3)
    rff = _jax_rff_draws(k_phi, None, 1, F)
    w = _t(jax.random.normal(k_w, (S, F)))
    eps = _t(jax.random.normal(k_u, (S, M)))
    xt = np.linspace(-0.5, 3.5, 13)
    jfs = jsampling.sample_svgp_functions(key, jpost, S, F)
    with tgp.config_context(gram_mode=gram_mode):
        got = tsampling.svgp_pathwise(tpost, rff, w, eps)(_t(xt))
    assert got.shape == (S, 13)
    assert _rel(got, jfs(jnp.asarray(xt))) < TOL


def test_torch_pathwise_samples_match_posterior_moments():
    """Centered SVGP at the optimal q with z = x (the exact posterior): the
    port's 2000 samples' mean and variance against ``mean_and_var``."""
    N = 12
    kern = 1.5 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.8)
    f = tgp.GP(kern)
    x = torch.linspace(0, 4, N, dtype=torch.float64)
    fx = f(x, 0.05)
    y = fx.sample(torch.Generator().manual_seed(2))
    fz = f(x, 1e-8)
    q = tgp.optimal_variational_posterior(fz, fx, y)
    post = tgp.posterior(tgp.SparseVariationalApproximation(fz, q, tgp.Centered()))
    fs = tgp.sample_svgp_functions(torch.Generator().manual_seed(3), post, num_samples=2000,
                                   num_features=2048)
    xt = torch.linspace(-0.5, 4.5, 15, dtype=torch.float64)
    samples = fs(xt)
    mu, var = post.mean_and_var(xt)
    np.testing.assert_allclose(_np(samples.mean(0)), _np(mu), atol=0.1)
    np.testing.assert_allclose(_np(samples.var(0, unbiased=False)), _np(var), atol=0.1)


def test_torch_pathwise_noncentered_matches_centered():
    """A whitened q: the samples' moments against ``mean_and_var`` (an int
    seed for the generator)."""
    N, M = 10, 5
    f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.0))
    x = torch.linspace(0, 3, N, dtype=torch.float64)
    fz = f(x[:M], 1e-6)
    q = tgp.MultivariateNormal(torch.linspace(-0.2, 0.3, M, dtype=torch.float64),
                               0.5 * torch.eye(M, dtype=torch.float64))
    post = tgp.posterior(tgp.SparseVariationalApproximation(fz, q, tgp.NonCentered()))
    fs = tgp.sample_svgp_functions(7, post, num_samples=2000, num_features=2048)
    xt = torch.linspace(0, 3, 7, dtype=torch.float64)
    samples = fs(xt)
    mu, var = post.mean_and_var(xt)
    np.testing.assert_allclose(_np(samples.mean(0)), _np(mu), atol=0.1)
    np.testing.assert_allclose(_np(samples.var(0, unbiased=False)), _np(var), atol=0.1)


def _exact_pair(N=24):
    jk, tk = _kernels(1.5, 0.8, None)
    x = np.linspace(0, 4, N)
    y = np.sin(2.0 * x) + 0.2 * np.random.default_rng(4).standard_normal(N)
    return (agp.GP(jk)(jnp.asarray(x), 0.05), jnp.asarray(y),
            tgp.GP(tk)(_t(x), 0.05), _t(y))


@pytest.mark.parametrize("matvec_mode", ["auto", "fused"])
def test_torch_cg_pathwise_matches_jax(matvec_mode):
    """sample_posterior_functions_cg's draws rebuilt from the JAX key
    (ε's unit normals), block CG at tol 1e-10 in blocks of 8 with a rank-6
    preconditioner; ``matvec_mode="fused"`` runs the solve and the update
    through row 5's Functions (their plain passes)."""
    jfx, jy, tfx, ty = _exact_pair()
    S, F, N = 5, 64, 24
    key = jax.random.PRNGKey(9)
    k_phi, k_w, k_eps = jax.random.split(key, 3)
    rff = _jax_rff_draws(k_phi, None, 1, F)
    w = _t(jax.random.normal(k_w, (S, F)))
    eps = _t(jax.random.normal(k_eps, (S, N)))
    kw = dict(tol=1e-10, block_size=8, precond_rank=6)
    xt = np.linspace(-0.5, 4.5, 13)
    jfs = jsampling.sample_posterior_functions_cg(key, jfx, jy, S, F, **kw)
    with tgp.config_context(matvec_mode=matvec_mode):
        got = tsampling.cg_pathwise(tfx, ty, rff, w, eps, **kw)(_t(xt))
    assert _rel(got, jfs(jnp.asarray(xt))) < CG_TOL


def test_torch_cg_pathwise_samples_match_exact_posterior():
    """The port's own draws: 2000 Matheron CG samples (blocks of 8, rank-6
    preconditioner) against the exact posterior's moments."""
    _, _, tfx, ty = _exact_pair()
    exact = tgp.posterior(tfx, ty)
    fs = tgp.sample_posterior_functions_cg(torch.Generator().manual_seed(5), tfx, ty,
                                           num_samples=2000, num_features=2048, tol=1e-10,
                                           block_size=8, precond_rank=6)
    xt = torch.linspace(-0.5, 4.5, 13, dtype=torch.float64)
    samples = fs(xt)
    mu, var = exact.mean_and_var(xt)
    np.testing.assert_allclose(_np(samples.mean(0)), _np(mu), atol=0.1)
    np.testing.assert_allclose(_np(samples.var(0, unbiased=False)), _np(var), atol=0.1)


def test_torch_cg_sampler_requires_isotropic_noise():
    f = tgp.GP(tgp.SqExponentialKernel())
    x = torch.linspace(0, 1, 5, dtype=torch.float64)
    with pytest.raises(ValueError):
        tgp.sample_posterior_functions_cg(0, f(x, torch.full((5,), 0.1, dtype=torch.float64)),
                                          torch.zeros(5, dtype=torch.float64), 2)


def test_torch_cg_update_takes_row5_where_the_fused_dispatch_does():
    """Vᵀ K(X, x) through the cross Function (``matvec_mode="fused"``) equals
    the Gram and matmul route, and the pass counts as one launch of row 5's
    plain version (no kernel launch on the CPU)."""
    rng = np.random.default_rng(8)
    X, Xq, V = _t(rng.standard_normal((40, 2))), _t(rng.standard_normal((9, 2))), \
        _t(rng.standard_normal((40, 3)))
    kern = 0.7 * tgp.with_lengthscale(tgp.Matern52Kernel(), torch.tensor([0.9, 1.3]))
    ref = V.T @ kern.gram(X, Xq)
    with tgp.config_context(matvec_mode="fused"):
        got = tsampling._cross_update(kern, X, Xq, V)
    assert _rel(got, ref) < 1e-13
    assert _rel(tsampling._cross_update(kern, X, Xq, V), ref) < 1e-13


def test_torch_svgp_sampler_at_the_optimal_q_matches_jax_moments():
    """The JAX and port samplers at one optimal q, each with its own draws:
    both sample means within 0.1 of the (shared) posterior mean."""
    N = 10
    jk, tk = _kernels(1.0, 0.7, 5)
    x = np.linspace(0, 3, N)
    y = np.cos(x)
    jfz, tfz = agp.GP(jk)(jnp.asarray(x), 1e-8), tgp.GP(tk)(_t(x), 1e-8)
    jq = jax_opt_q(jfz, agp.GP(jk)(jnp.asarray(x), 0.05), jnp.asarray(y))
    tq = tgp.optimal_variational_posterior(tfz, tgp.GP(tk)(_t(x), 0.05), _t(y))
    assert _rel(tq.mean, jq.mean) < TOL
    tpost = tgp.posterior(tgp.SparseVariationalApproximation(tfz, tq, tgp.Centered()))
    xt = torch.linspace(0, 3, 9, dtype=torch.float64)
    s = tgp.sample_svgp_functions(torch.Generator().manual_seed(1), tpost, 1500, 2048)(xt)
    np.testing.assert_allclose(_np(s.mean(0)), _np(tpost.mean(xt)), atol=0.1)
