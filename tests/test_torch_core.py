"""The PyTorch port's core math against the JAX package, CPU f64.

Inputs come from numpy with a fixed seed and go through both packages;
tolerance 1e-12 (both sides compute the same f64 expressions, up to the
order of a few sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.core import kernels as jk
from approximategps_tpu_torch.core import kernels as tk

torch.set_num_threads(1)

ATOL = 1e-12
MAPS = [
    (jk.SqExponentialKernel, tk.SqExponentialKernel, tk.KernelMapId.SE),
    (jk.Matern12Kernel, tk.Matern12Kernel, tk.KernelMapId.MATERN12),
    (jk.Matern32Kernel, tk.Matern32Kernel, tk.KernelMapId.MATERN32),
    (jk.Matern52Kernel, tk.Matern52Kernel, tk.KernelMapId.MATERN52),
]
MAP_IDS = [m[2].name for m in MAPS]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _points(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d))


@pytest.mark.parametrize("jcls,tcls,map_id", MAPS, ids=MAP_IDS)
def test_torch_kernel_maps(jcls, tcls, map_id):
    r2 = np.concatenate([[0.0, 1e-30], np.random.default_rng(0).uniform(0, 9, 50)])
    np.testing.assert_allclose(
        tcls.k_of_r2(_t(r2)).numpy(), np.asarray(jcls.k_of_r2(jnp.asarray(r2))), atol=ATOL
    )
    assert tcls().kernel_map().id == map_id


@pytest.mark.parametrize("ard", [False, True], ids=["scalar", "ard"])
@pytest.mark.parametrize("jcls,tcls,map_id", MAPS, ids=MAP_IDS)
def test_torch_with_lengthscale_gram(jcls, tcls, map_id, ard):
    X, Z = _points(23, 3, 1), _points(17, 3, 2)
    ls = np.array([0.7, 1.3, 2.1]) if ard else 0.8
    jker = 1.7 * agp.with_lengthscale(jcls(), jnp.asarray(ls))
    tker = 1.7 * tgp.with_lengthscale(tcls(), _t(ls) if ard else ls)
    np.testing.assert_allclose(
        tker.gram(_t(X), _t(Z)).numpy(), np.asarray(jker.gram(X, Z)), atol=ATOL
    )
    np.testing.assert_allclose(tker.gram(_t(X)).numpy(), np.asarray(jker.gram(X)), atol=ATOL)
    np.testing.assert_allclose(tker.diag(_t(X)).numpy(), np.asarray(jker.diag(X)), atol=ATOL)


@pytest.mark.parametrize("tmode,jmode", [("broadcast", "broadcast"), ("matmul", "mxu")])
def test_torch_pairwise_sq_dist(tmode, jmode):
    # offset data: the matmul mode's centring is what keeps it accurate
    X, Z = 30.0 + _points(19, 4, 3), 30.0 + _points(11, 4, 4)
    got = tk.pairwise_sq_dist(_t(X), _t(Z), mode=tmode).numpy()
    want = np.asarray(jk.pairwise_sq_dist(X, Z, mode=jmode))
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert got.min() >= 0.0


@pytest.mark.parametrize("jcls,tcls,map_id", MAPS, ids=MAP_IDS)
def test_torch_unwrap_stationary(jcls, tcls, map_id):
    ls = np.array([0.5, 2.0])
    jparts = jk.unwrap_stationary(0.3 * (2.0 * agp.with_lengthscale(jcls(), jnp.asarray(ls))))
    tparts = tk.unwrap_stationary(0.3 * (2.0 * tgp.with_lengthscale(tcls(), _t(ls))))
    kmap, scale, variance = tparts
    assert kmap.id == map_id and kmap.k_of_r2 is tcls.k_of_r2
    assert jparts[0] is jcls.k_of_r2
    np.testing.assert_allclose(scale.numpy(), np.asarray(jparts[1]), atol=ATOL)
    np.testing.assert_allclose(variance.numpy(), np.asarray(jparts[2]), atol=ATOL)
    bare = tk.unwrap_stationary(tcls())
    assert bare[0].id == map_id and bare[1] is None and bare[2] is None
    assert tk.unwrap_stationary(2.0 * tk.Kernel()) is None


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_torch_gp_finite_gp_cov_var(noise):
    X = _points(21, 2, 5)
    nz = 0.05 if noise == "scalar" else np.linspace(0.01, 0.2, 21)
    jf = agp.GP(1.4 * agp.with_lengthscale(agp.Matern32Kernel(), 0.9))
    tf = tgp.GP(1.4 * tgp.with_lengthscale(tgp.Matern32Kernel(), 0.9))
    jfx = jf(X, jnp.asarray(nz))
    tfx = tf(_t(X), _t(nz) if noise == "vector" else nz)
    np.testing.assert_allclose(tfx.cov().numpy(), np.asarray(jfx.cov()), atol=ATOL)
    np.testing.assert_allclose(tfx.var().numpy(), np.asarray(jfx.var()), atol=ATOL)
    np.testing.assert_allclose(tfx.mean().numpy(), np.asarray(jfx.mean()), atol=ATOL)
    np.testing.assert_allclose(tf.var(_t(X)).numpy(), np.asarray(jf.var(X)), atol=ATOL)
    np.testing.assert_allclose(
        tfx.scale_tril().numpy(), np.asarray(jfx.scale_tril()), atol=1e-10
    )
    assert tfx.is_isotropic_noise == jfx.is_isotropic_noise


def test_torch_means_match_jax():
    X = _points(9, 2, 6)
    np.testing.assert_array_equal(tk.as_points(_t(X[:, 0])).shape, (9, 1))
    pairs = [
        (agp.core.means.ZeroMean(), tgp.core.means.ZeroMean()),
        (agp.core.means.ConstMean(0.7), tgp.core.means.ConstMean(0.7)),
        (agp.core.means.FunctionMean(lambda x: jnp.sin(x[0]) * x[1]),
         tgp.core.means.FunctionMean(lambda x: torch.sin(x[0]) * x[1])),
    ]
    for jm, tm in pairs:
        np.testing.assert_allclose(tm(_t(X)).numpy(), np.asarray(jm(X)), atol=ATOL)
    # a GP with a mean function carries it into FiniteGP.mean
    tf = tgp.GP(tgp.SqExponentialKernel(), tgp.core.means.ConstMean(0.7))
    np.testing.assert_allclose(tf(_t(X), 0.1).mean().numpy(), np.full(9, 0.7), atol=ATOL)


def test_torch_multivariate_normal_matches_jax():
    rng = np.random.default_rng(7)
    m = rng.standard_normal(6)
    L = np.tril(rng.standard_normal((6, 6))) + 3 * np.eye(6)
    jd = agp.MultivariateNormal(jnp.asarray(m), jnp.asarray(L))
    td = tgp.MultivariateNormal(_t(m), _t(L))
    assert td.dim == 6
    np.testing.assert_allclose(td.cov().numpy(), np.asarray(jd.cov()), atol=ATOL)
    np.testing.assert_allclose(td.var().numpy(), np.asarray(jd.var()), atol=ATOL)
    np.testing.assert_allclose(td.stddev().numpy(), np.asarray(jd.stddev()), atol=ATOL)
    for a, b in zip(td.marginals(), jd.marginals()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
