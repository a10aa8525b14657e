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
from approximategps_tpu_torch.models import svgp_streaming
from approximategps_tpu_torch.ops import panel_chol, svgp_epilogue
from approximategps_tpu_torch.utils import profiling
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


# -- blocks a call: several blocks through one epilogue call on the card ------

CELL_BUDGET = 1000 * 16384  # the (M, block) Gram at M = 1000, blocks of 16384


@pytest.mark.parametrize("scratch, n_blocks, want", [
    (lambda b: 87 * b + 5_700_000, 43, 7),  # the pullback's layout at the full-data cell
    (lambda b: 87 * b + 5_700_000, 5, 5),  # capped at the blocks there are
    (lambda b: 87 * b + 5_700_000, 1, 1),
    (lambda b: 0, 43, 43),
    (lambda b: CELL_BUDGET + 1, 43, 1),  # not even one block fits: still one a call
    (lambda b: 2 * CELL_BUDGET if b > 3 * 16384 else 0, 43, 3),
], ids=["cell", "capped", "one block", "no scratch", "over budget", "step"])
def test_torch_streaming_blocks_a_call_fit_the_budget(scratch, n_blocks, want):
    asked = []

    def probe(b):
        asked.append(b)
        return scratch(b)

    k = svgp_streaming._blocks_fitting(n_blocks, 16384, CELL_BUDGET, probe)
    assert k == want
    assert 1 <= k <= n_blocks
    assert k == 1 or all(scratch(j * 16384) <= CELL_BUDGET for j in range(1, k + 1))
    assert k == n_blocks or scratch((k + 1) * 16384) > CELL_BUDGET
    assert max(asked, default=0) <= n_blocks * 16384


def _chunks(run):
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = run()
    n = sum(1 for name, *_ in profiling.spans() if name == "streaming.chunk")
    profiling.reset_spans()
    return out, n


@pytest.mark.parametrize("mode", ["auto", "plain"])
def test_torch_streaming_takes_one_block_a_call_off_the_card(mode, monkeypatch):
    """On CPU tensors (the epilogue's CPU version forms K0 in full) and on
    the checkpointed plain route a call takes one block, one
    ``streaming.chunk`` span each, and the card is never asked."""
    params = _params()
    x, y = _data()
    picked = []
    pick = svgp_streaming._blocks_per_call
    monkeypatch.setattr(svgp_streaming, "_blocks_per_call",
                        lambda *a: picked.append(pick(*a)) or picked[-1])
    monkeypatch.setattr(svgp_streaming, "epilogue_bwd_scratch", None)
    with tgp.config_context(data_term_mode=mode):
        _, n = _chunks(lambda: _torch_value_and_grad(tk.SqExponentialKernel, params, x, y,
                                                     num_data=5000))
    assert picked == [1]
    assert n == -(-N // BLOCK)


@pytest.mark.parametrize("per_call", [2, 3, 4])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_torch_streaming_grouped_blocks_match_jax(kernel, per_call, monkeypatch):
    """The loop with several blocks a call, as it runs on the card, held on
    the CPU (fused epilogue, closed-form pullback) against the JAX package:
    the tail group is short and its last block padded; one epilogue call
    and one ``streaming.chunk`` span a group.  rtol 1e-8."""
    jcls, tcls = KERNELS[kernel]
    params = _params()
    x, y = _data()
    vj, gj = _jax_reference(jcls, params, x, y, num_data=5000)
    monkeypatch.setattr(svgp_streaming, "_blocks_per_call", lambda *a: per_call)
    fwd = _probe(monkeypatch, svgp_epilogue, "svgp_data_epilogue_plain")
    bwd = _probe(monkeypatch, svgp_epilogue, "svgp_data_epilogue_bwd_plain")
    (vt, gt), n = _chunks(lambda: _torch_value_and_grad(tcls, params, x, y, num_data=5000))
    groups = -(-(-(-N // BLOCK)) // per_call)
    assert (len(fwd), len(bwd), n) == (groups, groups, groups)
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-8)
    for k in params:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-8, atol=1e-10,
                                   err_msg=k)


def test_torch_streaming_grouped_mask():
    """A 0/1 mask drops points from the sum exactly with several blocks a
    call, as with one."""
    params = _params(4)
    x, y = _data(5)
    keep = torch.from_numpy(np.random.default_rng(6).random(N) < 0.6)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    sva = _sva(tp, tgp, tsoftplus, torch.tril, tk.SqExponentialKernel)
    lik = tgp.GaussianLikelihood(0.1)
    term = svgp_streaming.streaming_data_term
    one = term(sva, lik, torch.from_numpy(x), torch.from_numpy(y), block_size=BLOCK, mask=keep)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(svgp_streaming, "_blocks_per_call", lambda *a: 3)
        grouped = term(sva, lik, torch.from_numpy(x), torch.from_numpy(y), block_size=BLOCK,
                       mask=keep)
    np.testing.assert_allclose(grouped.item(), one.item(), rtol=1e-12)
