"""Parameters carried across from the JAX package (``convert.py``) and the
port's SVGP parameter pack (``utils/training.py``), CPU f64.

Both forms the repo uses: ``bench.py``'s dict and ``SVGPParams``.  The
constrained models agree to 1e-12 (the same f64 expressions); posteriors
built from them to 1e-9 (LAPACK factorizations of the same Gram)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
import bench
from approximategps_tpu.config import config_context
from approximategps_tpu.utils.bijectors import invsoftplus as jax_invsoftplus
from approximategps_tpu.utils.bijectors import softplus as jax_softplus
from approximategps_tpu.utils.training import build_svgp as jax_build_svgp
from approximategps_tpu.utils.training import init_svgp_params as jax_init_svgp_params
from approximategps_tpu_torch import convert

torch.set_num_threads(1)


def _bench_params(M=64, D=3):
    """``bench.py``'s parameters with a non-trivial q: the bench's own m = 0,
    A = I give S = 0 and α = 0, which any kernel returning zeros matches."""
    p = dict(bench._svgp_params(M, D, jax.random.PRNGKey(0), jnp.float64))
    rng = np.random.default_rng(0)
    p["m"] = jnp.asarray(0.3 * rng.standard_normal(M))
    p["A"] = jnp.asarray(0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M))))
    return p


def _jax_bench_posterior(params):
    """The posterior ``bench.svgp_predict_sweep`` builds."""
    kernel = jax_softplus(params["k"][0]) * agp.with_lengthscale(
        agp.SqExponentialKernel(), jax_softplus(params["k"][1])
    )
    fz = agp.GP(kernel)(params["z"], 1e-6)
    q = agp.MultivariateNormal(params["m"], jnp.tril(params["A"]))
    return agp.posterior(agp.SparseVariationalApproximation(fz, q))


def test_torch_from_jax_params_bench_dict():
    jparams = _bench_params()
    tparams = convert.from_jax_params(jparams, device="cpu", dtype=torch.float64)
    assert set(tparams) == set(jparams)
    for k, v in tparams.items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))
    f32 = convert.from_jax_params(jparams, device="cpu", dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in f32.values())

    xs = np.random.default_rng(1).standard_normal((40, 3))
    with config_context(solve_mode="inv_matmul", data_term_mode="xla"):
        jmu, jvar = _jax_bench_posterior(jparams).mean_and_var(jnp.asarray(xs))
    with tgp.config_context(solve_mode="inv_matmul"):
        tpost = convert.build_posterior_from_bench_params(tparams)
        tmu, tvar = tpost.predict_blocks(torch.from_numpy(xs), block_size=16)
    assert isinstance(tpost.approx.parametrization, tgp.NonCentered)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-9)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=1e-9)


@pytest.mark.parametrize("kernel", ["se", "matern52"])
def test_torch_from_jax_params_svgp_params_build_parity(kernel):
    jcls, tcls = {
        "se": (agp.SqExponentialKernel, tgp.SqExponentialKernel),
        "matern52": (agp.Matern52Kernel, tgp.Matern52Kernel),
    }[kernel]
    rng = np.random.default_rng(2)
    M, D = 24, 2
    jparams = jax_init_svgp_params(jnp.asarray(rng.standard_normal((M, D))), 1.3, 0.7)
    jparams = jparams._replace(
        m=jnp.asarray(rng.standard_normal(M)),
        L_flat=jparams.L_flat + 0.1 * jnp.asarray(rng.standard_normal(jparams.L_flat.shape)),
    )
    tparams = convert.from_jax_params(jparams, device="cpu", dtype=torch.float64)
    assert isinstance(tparams, tgp.SVGPParams)
    for name in tgp.SVGPParams._fields:
        np.testing.assert_array_equal(
            getattr(tparams, name).numpy(), np.asarray(getattr(jparams, name))
        )
    jsva, jf = jax_build_svgp(jparams, jitter=1e-5, kernel_cls=jcls)
    tsva, tf = tgp.build_svgp(tparams, jitter=1e-5, kernel_cls=tcls)
    np.testing.assert_allclose(tsva.fz.cov().numpy(), np.asarray(jsva.fz.cov()), atol=1e-12)
    np.testing.assert_allclose(tsva.q.mean.numpy(), np.asarray(jsva.q.mean), atol=1e-12)
    np.testing.assert_allclose(
        tsva.q.scale_tril.numpy(), np.asarray(jsva.q.scale_tril), atol=1e-12
    )
    X = rng.standard_normal((7, D))
    np.testing.assert_allclose(tf.cov(torch.from_numpy(X)).numpy(), np.asarray(jf.cov(X)),
                               atol=1e-12)


def test_torch_init_svgp_params_matches_jax():
    z = np.random.default_rng(3).standard_normal((10, 2))
    jp = jax_init_svgp_params(jnp.asarray(z), 2.0, 0.5)
    tp = tgp.init_svgp_params(torch.from_numpy(z), 2.0, 0.5)
    for name in tgp.SVGPParams._fields:
        np.testing.assert_allclose(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), atol=1e-12, err_msg=name
        )


def test_torch_softplus_matches_jax_past_the_linear_cutoff():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0])
    np.testing.assert_allclose(
        tgp.utils.softplus(torch.from_numpy(x)).numpy(), np.asarray(jax_softplus(x)),
        rtol=1e-15, atol=0,
    )


def test_torch_from_jax_params_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    the default device resolves to CUDA (checked without making a tensor,
    which this machine could not place there)."""
    default = inspect.signature(convert.from_jax_params).parameters["device"].default
    assert torch.device(default).type == "cuda"


def test_torch_from_jax_params_exact_theta_builds_the_same_fx():
    """The exact GP's raw θ carried across and ``build_exact_fx`` against
    ``build_fx(θ)`` of ``tests/test_iterative.py``: the same covariance and
    noise to 1e-12."""
    theta = np.asarray(jax_invsoftplus(jnp.array([1.5, 1.2, 0.1])))
    x = np.random.default_rng(4).uniform(0.0, 10.0, (30, 2))
    ttheta = convert.from_jax_params(jnp.asarray(theta), device="cpu", dtype=torch.float64)
    assert ttheta.shape == (3,) and ttheta.dtype == torch.float64
    tfx = convert.build_exact_fx(ttheta, torch.from_numpy(x))
    kern = jax_softplus(theta[0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                        jax_softplus(theta[1]))
    jfx = agp.GP(kern)(jnp.asarray(x), jax_softplus(theta[2]))
    np.testing.assert_allclose(tfx.cov().numpy(), np.asarray(jfx.cov()), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(tfx.noise), 0.1, rtol=1e-12)


def test_torch_from_jax_params_rejects_other_forms():
    with pytest.raises(ValueError, match="bench dict"):
        convert.from_jax_params({"k": 1.0, "z": 2.0})
    with pytest.raises(TypeError, match="SVGPParams"):
        convert.from_jax_params([1.0, 2.0])
