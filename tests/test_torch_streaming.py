"""The full-data streaming ELBO (``models/svgp_streaming.py``) on the CPU,
f64, against the JAX package's ``streaming_elbo`` under
``data_term_mode="xla"``: value and gradients for k, z, m and A.

N = 100 in blocks of 32, so the tail block is ragged and padded.  The port
takes ``chol_with_inv``'s kernel route (its plain version on the CPU) and,
in mode "auto", the fused epilogue for every block, whose backward on the
CPU is the closed-form ``svgp_data_epilogue_bwd_plain``; in mode "plain" the
checkpointed Gram blocks.  rtol 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.models.svgp_streaming import streaming_elbo as jax_streaming_elbo
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import panel_chol, svgp_epilogue
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

M, D, N, BLOCK = 24, 2, 100, 32
KERNELS = {
    "se": (jk.SqExponentialKernel, tk.SqExponentialKernel),
    "matern32": (jk.Matern32Kernel, tk.Matern32Kernel),
}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "k": np.array([0.3, -0.4]),
        "z": 1.1 * rng.standard_normal((M, D)),
        "m": 0.3 * rng.standard_normal(M),
        "A": 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M))),
    }


def _data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D))
    return x, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(N)


def _sva(p, mod, softplus, tril, cls):
    kernel = softplus(p["k"][0]) * mod.with_lengthscale(cls(), softplus(p["k"][1]))
    q = mod.MultivariateNormal(p["m"], tril(p["A"]))
    return mod.SparseVariationalApproximation(mod.GP(kernel)(p["z"], 1e-6), q)


def _jax_reference(jcls, params, x, y, num_data):
    def loss(p):
        sva = _sva(p, agp, jsoftplus, jnp.tril, jcls)
        lik = agp.GaussianLikelihood(jnp.asarray(0.1))
        return -jax_streaming_elbo(sva, lik, jnp.asarray(x), jnp.asarray(y), block_size=BLOCK,
                                   num_data=num_data)

    with config_context(data_term_mode="xla"):
        return jax.value_and_grad(loss)({k: jnp.asarray(v) for k, v in params.items()})


def _probe(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or fn(*a))
    return calls


def _torch_value_and_grad(tcls, params, x, y, num_data):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sva = _sva(tp, tgp, tsoftplus, torch.tril, tcls)
    lik = tgp.GaussianLikelihood(0.1)
    val = -tgp.streaming_elbo(sva, lik, torch.from_numpy(x), torch.from_numpy(y),
                              block_size=BLOCK, num_data=num_data)
    val.backward()
    return val, {k: t.grad for k, t in tp.items()}


@pytest.mark.parametrize("mode", ["auto", "plain"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_torch_streaming_elbo_matches_jax(kernel, mode, monkeypatch):
    jcls, tcls = KERNELS[kernel]
    params = _params()
    x, y = _data()
    vj, gj = _jax_reference(jcls, params, x, y, num_data=5000)
    chol = _probe(monkeypatch, panel_chol, "chol_inv_plain")
    fwd = _probe(monkeypatch, svgp_epilogue, "svgp_data_epilogue_plain")
    bwd = _probe(monkeypatch, svgp_epilogue, "svgp_data_epilogue_bwd_plain")
    with tgp.config_context(data_term_mode=mode):
        vt, gt = _torch_value_and_grad(tcls, params, x, y, num_data=5000)
    n_blocks = -(-N // BLOCK)
    assert chol == [1]
    assert (len(fwd), len(bwd)) == ((n_blocks, n_blocks) if mode == "auto" else (0, 0))
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-8)
    for k in params:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-8, atol=1e-10,
                                   err_msg=k)


def test_torch_streaming_elbo_equals_batch_elbo():
    """Without a num_data scale the streaming ELBO over all N points is the
    minibatch ELBO over the same points, gradients included."""
    params = _params(2)
    x, y = _data(3)
    vs, gs = _torch_value_and_grad(tk.SqExponentialKernel, params, x, y, num_data=None)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sva = _sva(tp, tgp, tsoftplus, torch.tril, tk.SqExponentialKernel)
    f = sva.fz.f
    with tgp.config_context(solve_mode="inv_matmul"):
        vb = -tgp.elbo(sva, f(torch.from_numpy(x), 0.1), torch.from_numpy(y))
    vb.backward()
    np.testing.assert_allclose(vs.item(), vb.item(), rtol=1e-10)
    for k in params:
        torch.testing.assert_close(gs[k], tp[k].grad, rtol=1e-8, atol=1e-10, msg=k)


def test_torch_streaming_data_term_mask():
    """A 0/1 mask drops points from the sum exactly."""
    params = _params(4)
    x, y = _data(5)
    keep = np.random.default_rng(6).random(N) < 0.6
    tp = {k: torch.tensor(v) for k, v in params.items()}
    sva = _sva(tp, tgp, tsoftplus, torch.tril, tk.SqExponentialKernel)
    lik = tgp.GaussianLikelihood(0.1)
    term = tgp.models.svgp_streaming.streaming_data_term
    masked = term(sva, lik, torch.from_numpy(x), torch.from_numpy(y), block_size=BLOCK,
                  mask=torch.from_numpy(keep))
    kept = term(sva, lik, torch.from_numpy(x[keep]), torch.from_numpy(y[keep]), block_size=BLOCK)
    np.testing.assert_allclose(masked.item(), kept.item(), rtol=1e-12)
