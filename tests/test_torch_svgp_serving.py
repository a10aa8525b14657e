"""The serving slice as a whole, CPU f64: the same SVGP parameters, carried
across with ``convert.from_jax_params``, give the same posterior cache and
the same ``predict_blocks`` mean and variance in both packages.

The JAX package runs its XLA routes (``data_term_mode="xla"``; off the TPU
its gram-fused build declines too).  The port, on CPU tensors, runs the
plain versions of both of its kernels, which a probe on each plain
function checks.  atol 1e-9: both sides factor the same f64 Gram with
LAPACK, and cond(Kuu) stays near 1e3 at these inputs."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.config import config_context
from approximategps_tpu.utils.training import SVGPParams as JaxSVGPParams
from approximategps_tpu.utils.training import build_svgp as jax_build_svgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.config import kernel_device, resolve_solve_mode
from approximategps_tpu_torch.models import svgp as tsvgp
from approximategps_tpu_torch.ops import panel_chol, svgp_epilogue

torch.set_num_threads(1)

ATOL = 1e-9
M, D, NTEST, BLOCK = 128, 3, 301, 64
KERNELS = {
    "se": (agp.SqExponentialKernel, tgp.SqExponentialKernel),
    "matern32": (agp.Matern32Kernel, tgp.Matern32Kernel),
}


def _jax_params(seed=0):
    rng = np.random.default_rng(seed)
    Lq = np.tril(0.05 * rng.standard_normal((M, M)), -1) + np.diag(
        rng.uniform(-1.5, 0.5, M)
    )
    return JaxSVGPParams(
        raw_variance=jnp.asarray(0.4),
        raw_lengthscale=jnp.asarray(-0.3),
        z=jnp.asarray(1.5 * rng.standard_normal((M, D))),
        m=jnp.asarray(0.3 * rng.standard_normal(M)),
        L_flat=jnp.asarray(Lq[np.tril_indices(M)]),
    )


def _xs(seed=1):
    return 1.5 * np.random.default_rng(seed).standard_normal((NTEST, D))


def _probe(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_torch_svgp_serving_matches_jax(kernel, monkeypatch):
    jcls, tcls = KERNELS[kernel]
    jparams = _jax_params()
    xs = _xs()
    with config_context(solve_mode="inv_matmul", data_term_mode="xla"):
        jsva, _ = jax_build_svgp(jparams, kernel_cls=jcls)
        jpost = agp.posterior(jsva)
        jmu, jvar = jpost.predict_blocks(jnp.asarray(xs), block_size=BLOCK)

    chol_calls = _probe(monkeypatch, panel_chol, "gram_chol_inv_plain")
    epi_calls = _probe(monkeypatch, svgp_epilogue, "svgp_data_epilogue_plain")
    tparams = convert.from_jax_params(jparams, device="cpu", dtype=torch.float64)
    with tgp.config_context(solve_mode="inv_matmul"):
        tsva, _ = tgp.build_svgp(tparams, kernel_cls=tcls)
        tpost = tgp.posterior(tsva)
        tmu, tvar = tpost.predict_blocks(torch.from_numpy(xs), block_size=BLOCK)
    assert chol_calls == [1]
    assert len(epi_calls) == -(-NTEST // BLOCK)

    jc, tc = jpost.cache, tpost.cache
    for name in ("Kuu_L", "Lk_inv", "alpha", "S_corr", "B"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), atol=ATOL, err_msg=name
        )
    # exactly symmetric: the epilogue kernel reads only its upper triangle
    assert torch.equal(tc.S_corr, tc.S_corr.T)
    assert tmu.shape == tvar.shape == (NTEST,)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=ATOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=ATOL)
    # the variance is a real correction of the prior's, not the prior's
    assert np.ptp(tvar.numpy()) > 1e-2
    # the unfused prediction methods agree with the sweep
    mu2, var2 = tpost.mean_and_var(torch.from_numpy(xs[:50]))
    np.testing.assert_allclose(mu2.numpy(), tmu.numpy()[:50], atol=ATOL)
    np.testing.assert_allclose(var2.numpy(), tvar.numpy()[:50], atol=ATOL)
    np.testing.assert_allclose(tpost.var(torch.from_numpy(xs[:50])).numpy(), var2.numpy(), atol=ATOL)


@pytest.mark.parametrize("solve_mode", ["triangular", "inv_matmul"])
@pytest.mark.parametrize("param", ["centered", "noncentered"])
def test_torch_svgp_posterior_routes_match_jax(param, solve_mode):
    """The plain posterior routes: Centered, and the triangular solve mode."""
    jparams = _jax_params(2)
    xs = _xs(3)[:80]
    jpar = agp.Centered() if param == "centered" else agp.NonCentered()
    tpar = tgp.Centered() if param == "centered" else tgp.NonCentered()
    with config_context(solve_mode=solve_mode, data_term_mode="xla"):
        jsva, _ = jax_build_svgp(jparams, parametrization=jpar)
        jmu, jvar = agp.posterior(jsva).mean_and_var(jnp.asarray(xs))
    tparams = convert.from_jax_params(jparams, device="cpu", dtype=torch.float64)
    with tgp.config_context(solve_mode=solve_mode):
        tsva, _ = tgp.build_svgp(tparams, parametrization=tpar)
        tpost = tgp.posterior(tsva)
        tmu, tvar = tpost.predict_blocks(torch.from_numpy(xs), block_size=32)
    assert (tpost.cache.S_corr is not None) == (solve_mode == "inv_matmul")
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=ATOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=ATOL)


def test_torch_resolve_solve_mode_gate():
    """"auto" takes the S-correction route only on the kernel device (a CUDA
    tensor in f32 or f64) at M >= 512, as the JAX package does on the TPU."""
    cpu = torch.zeros(3, dtype=torch.float32)
    # stands in for a CUDA tensor: the gate reads only these two attributes
    cuda = {dt: SimpleNamespace(is_cuda=True, dtype=dt) for dt in (torch.float32, torch.float64,
                                                                  torch.float16)}
    assert tgp.config.solve_mode == "auto"
    assert resolve_solve_mode(cpu, size=2048) == "triangular"
    assert resolve_solve_mode(cuda[torch.float32], size=2048) == "inv_matmul"
    assert resolve_solve_mode(cuda[torch.float64], size=512) == "inv_matmul"
    assert resolve_solve_mode(cuda[torch.float32], size=511) == "triangular"
    assert resolve_solve_mode(cuda[torch.float16], size=2048) == "triangular"
    with tgp.config_context(solve_mode="inv_matmul"):
        assert resolve_solve_mode(cpu, size=16) == "inv_matmul"
    assert not kernel_device(cpu) and kernel_device(cuda[torch.float32])


def test_torch_epilogue_gate_raises_on_the_kernel_device():
    """Where the fused epilogue does not take the prior or the shape, a CPU
    sweep is served by mean_and_var and a CUDA one raises rather than
    quietly leaving the kernel out; data_term_mode="plain" opts out.  The
    serving callers pass prefer=True; without it (the minibatch ELBO) the
    gate declines in mode "auto" and nothing raises."""
    z = torch.zeros((2048, 8), dtype=torch.float32)
    se_prior = tgp.GP(0.7 * tgp.SqExponentialKernel())
    other_prior = SimpleNamespace(kernel=object())  # a kernel that does not unwrap
    cpu_S = torch.zeros((1, 1), dtype=torch.float32)
    # stands in for a CUDA S_corr: the gate reads only its device and dtype
    cuda_S = SimpleNamespace(is_cuda=True, dtype=torch.float32, device=torch.device("cuda"))
    kmap = tsvgp._epilogue_ready(se_prior, z, cuda_S, prefer=True)[0]
    assert kmap == tgp.SqExponentialKernel().kernel_map()
    assert tsvgp._epilogue_ready(other_prior, z, cpu_S, prefer=True) is None
    with pytest.raises(NotImplementedError, match="stationary kernel"):
        tsvgp._epilogue_ready(other_prior, z, cuda_S, prefer=True)
    # the SIMT forward (f64, and f32 with D > 8) needs its (block_b, M) K0
    # tile in shared memory; the f32 tensor-core forward (D <= 8) has none
    cpu_S64 = torch.zeros((1, 1), dtype=torch.float64)
    cuda_S64 = SimpleNamespace(is_cuda=True, dtype=torch.float64, device=torch.device("cuda"))
    z9 = torch.zeros((2048, 9), dtype=torch.float32)
    with tgp.config_context(epilogue_block_b=2):
        assert tsvgp._epilogue_ready(se_prior, z, cuda_S, prefer=True)[0] == kmap
        assert tsvgp._epilogue_ready(se_prior, z, cpu_S, prefer=True)[0] == kmap
        for zz, S in ((z, cpu_S64), (z9, cpu_S)):
            assert tsvgp._epilogue_ready(se_prior, zz, S, prefer=True) is None
        for zz, S in ((z, cuda_S64), (z9, cuda_S)):
            with pytest.raises(NotImplementedError, match="no tiling over M"):
                tsvgp._epilogue_ready(se_prior, zz, S, prefer=True)
    with tgp.config_context(data_term_mode="plain"):
        assert tsvgp._epilogue_ready(other_prior, z, cuda_S, prefer=True) is None
    with tgp.config_context(use_kernels=False):
        assert tsvgp._epilogue_ready(other_prior, z, cuda_S, prefer=True) is None


def test_torch_epilogue_gate_declines_without_prefer():
    """prefer=False, the minibatch ELBO's call: mode "auto" declines on
    either device, even for a prior the epilogue would reject, so the raise
    applies only where the epilogue would be taken."""
    z = torch.zeros((2048, 8), dtype=torch.float32)
    se_prior = tgp.GP(0.7 * tgp.SqExponentialKernel())
    other_prior = SimpleNamespace(kernel=object())
    cpu_S = torch.zeros((1, 1), dtype=torch.float32)
    cuda_S = SimpleNamespace(is_cuda=True, dtype=torch.float32, device=torch.device("cuda"))
    for prior in (se_prior, other_prior):
        for S in (cpu_S, cuda_S):
            assert tsvgp._epilogue_ready(prior, z, S) is None
            assert tsvgp._epilogue_ready(prior, z, S, prefer=False) is None
    with tgp.config_context(epilogue_block_b=2):
        assert tsvgp._epilogue_ready(se_prior, z, cuda_S, prefer=False) is None
