"""The port's fused data-term epilogue (``ops/svgp_epilogue.py``) on the
CPU, where the wrapper runs its plain version, against the JAX package's
Pallas kernel in interpret mode.

f64, atol 1e-9: both sides form K0 by the same centred |x|²-identity, and
sum M = 64 terms in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.ops.svgp_epilogue import svgp_data_epilogue as jax_epilogue
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import svgp_epilogue

torch.set_num_threads(1)

ATOL = 1e-9


def _inputs(M, B, D, seed=0):
    rng = np.random.default_rng(seed)
    Zs = 0.8 * rng.standard_normal((M, D)) + 2.0
    Xs = 0.8 * rng.standard_normal((B, D)) + 2.0
    R = rng.standard_normal((M, M)) / np.sqrt(M)
    Se = R @ R.T + 0.1 * np.eye(M)  # random SPD
    ae = rng.standard_normal(M)
    return Xs, Zs, Se, ae


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_torch_svgp_epilogue_matches_pallas_interpret():
    Xs, Zs, Se, ae = _inputs(64, 200, 3)  # B = 200: ragged against every tile
    with config_context(pallas_interpret=True, use_pallas=True):
        mu_j, var_j = jax_epilogue(
            *(jnp.asarray(a) for a in (Xs, Zs, Se, ae)), jk.SqExponentialKernel.k_of_r2
        )
    mu, var = svgp_epilogue.svgp_data_epilogue(
        *_torch(Xs, Zs, Se, ae), tk.SqExponentialKernel().kernel_map()
    )
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), atol=ATOL)


@pytest.mark.parametrize(
    "tcls", [tk.Matern12Kernel, tk.Matern32Kernel, tk.Matern52Kernel], ids=["m12", "m32", "m52"]
)
def test_torch_svgp_epilogue_plain_matches_dense_form(tcls):
    """Each map against the dense definition: exact broadcast distances,
    K0ᵀ ae and diag(K0ᵀ Se K0) by einsum."""
    Xs, Zs, Se, ae = _inputs(48, 37, 4, seed=1)
    K0 = tcls.k_of_r2(torch.from_numpy(((Zs[:, None, :] - Xs[None, :, :]) ** 2).sum(-1)))
    K0 = K0.numpy()
    mu, var = svgp_epilogue.svgp_data_epilogue(*_torch(Xs, Zs, Se, ae), tcls().kernel_map())
    np.testing.assert_allclose(mu.numpy(), K0.T @ ae, atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.einsum("aj,ab,bj->j", K0, Se, K0), atol=ATOL)


def test_torch_svgp_epilogue_cpu_takes_plain_version(monkeypatch):
    calls = []
    plain = svgp_epilogue.svgp_data_epilogue_plain
    monkeypatch.setattr(
        svgp_epilogue, "svgp_data_epilogue_plain", lambda *a: calls.append(1) or plain(*a)
    )
    before = svgp_epilogue.svgp_data_epilogue.launches
    svgp_epilogue.svgp_data_epilogue(
        *_torch(*_inputs(16, 10, 2)), tk.SqExponentialKernel().kernel_map()
    )
    assert calls == [1]
    assert svgp_epilogue.svgp_data_epilogue.launches == before


def test_torch_epilogue_block_b_fits_shared_memory():
    """The tile the SIMT forward takes (f64, and f32 with D > 8): 16 points
    where the (16, M) K0 tile fits the shared-memory budget, fewer where it
    does not, none past that.  The f32 tensor-core forward (D <= 8) keeps
    no tile of M, so it takes every M these do and those past them."""
    assert svgp_epilogue.epilogue_block_b(2048, 8, torch.float32) == 16
    assert svgp_epilogue.epilogue_block_b(2048, 8, torch.float64) == 8
    assert svgp_epilogue.epilogue_block_b(6000, 8, torch.float32) == 8
    assert svgp_epilogue.epilogue_block_b(1 << 16, 8, torch.float32) is None
    assert svgp_epilogue.epilogue_block_b(2048, 8, torch.float16) is None
    for M in (64, 2048, 4096, 6000):
        for dtype in (torch.float32, torch.float64):
            bb = svgp_epilogue.epilogue_block_b(M, 8, dtype)
            size = torch.empty((), dtype=dtype).element_size()
            assert svgp_epilogue._smem_bytes(bb, M, 8, size) <= 227 * 1024
    for M in (64, 2048, 6000, 1 << 16):
        assert svgp_epilogue.epilogue_part(M, 8, torch.float32) == "mma"
        part64 = svgp_epilogue.epilogue_part(M, 8, torch.float64)
        assert part64 == ("simt" if svgp_epilogue.epilogue_block_b(M, 8, torch.float64) else None)
