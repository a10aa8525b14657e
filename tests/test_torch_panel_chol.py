"""The port's gram-fused (L, L⁻¹) factorization (``ops/panel_chol.py``) on
the CPU, where the wrapper runs its plain version, against the JAX
package's Pallas kernel in interpret mode and its plain XLA route.

f64 throughout.  Tolerances are those of the JAX package's own
``test_gram_panel_chol_matches_reference``: L to 1e-10, J to 1e-7 (the
inverse's error is amplified by cond(K))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.core.linalg import chol_with_inv as jax_chol_with_inv
from approximategps_tpu.ops.panel_chol import pallas_gram_chol_inv
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import panel_chol

torch.set_num_threads(1)

M, D = 256, 5
SIG2, JITTER = 1.7, 1e-6


def _z(seed=11):
    return 1.3 * np.random.default_rng(seed).standard_normal((M, D))


def _assert_lower(L, J):
    assert not np.any(np.triu(L, 1))
    assert not np.any(np.triu(J, 1))


def test_torch_gram_chol_inv_matches_pallas_interpret():
    Z = _z()
    Lj, Jj = jax.jit(
        lambda Z: pallas_gram_chol_inv(
            Z, SIG2, JITTER, jk.SqExponentialKernel.k_of_r2, panel=64, interpret=True
        )
    )(jnp.asarray(Z))
    kmap = tk.SqExponentialKernel().kernel_map()
    L, J = panel_chol.gram_chol_inv(torch.from_numpy(Z), SIG2, JITTER, kmap)
    L, J = L.numpy(), J.numpy()
    np.testing.assert_allclose(L, np.asarray(Lj), atol=1e-10)
    np.testing.assert_allclose(J, np.asarray(Jj), atol=1e-7)
    _assert_lower(L, J)


@pytest.mark.parametrize(
    "jcls,tcls",
    [(jk.SqExponentialKernel, tk.SqExponentialKernel), (jk.Matern52Kernel, tk.Matern52Kernel)],
    ids=["se", "matern52"],
)
def test_torch_gram_chol_inv_matches_xla_route(jcls, tcls):
    Z = _z(12)
    K = SIG2 * jcls().gram(jnp.asarray(Z)) + JITTER * jnp.eye(M)
    with config_context(chol_mode="xla"):
        Lj, Jj = jax_chol_with_inv(K)
    L, J = panel_chol.gram_chol_inv(torch.from_numpy(Z), SIG2, JITTER, tcls().kernel_map())
    L, J = L.numpy(), J.numpy()
    np.testing.assert_allclose(L, np.asarray(Lj), atol=1e-10)
    np.testing.assert_allclose(J, np.asarray(Jj), atol=1e-7)
    _assert_lower(L, J)


def test_torch_gram_chol_inv_cpu_takes_plain_version(monkeypatch):
    """A CPU tensor goes to the plain version and launches nothing."""
    calls = []
    plain = panel_chol.gram_chol_inv_plain
    monkeypatch.setattr(
        panel_chol, "gram_chol_inv_plain", lambda *a: calls.append(1) or plain(*a)
    )
    before = panel_chol.gram_chol_inv.launches
    Z = torch.from_numpy(_z()[:64])
    panel_chol.gram_chol_inv(Z, SIG2, JITTER, tk.Matern32Kernel().kernel_map())
    assert calls == [1]
    assert panel_chol.gram_chol_inv.launches == before


def test_torch_gram_chol_inv_rejects_unsupported_inputs():
    assert panel_chol.gram_chol_inv_supported(2048, 8, torch.float32)
    assert panel_chol.gram_chol_inv_supported(100, 64, torch.float64)
    assert not panel_chol.gram_chol_inv_supported(256, 65, torch.float32)
    assert not panel_chol.gram_chol_inv_supported(256, 8, torch.float16)
    # a tensor off the CPU that is no CUDA tensor is refused, not computed
    # by the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        panel_chol.gram_chol_inv(
            torch.empty((64, 3), device="meta"), SIG2, JITTER,
            tk.SqExponentialKernel().kernel_map(),
        )


def test_torch_host_float_parameters_stay_off_the_host():
    """σ² and the jitter reach the kernel without a copy from the host: the
    posterior build's ``_scalar`` makes a float into a 0-dim tensor on
    ``like``'s device in ``like``'s dtype (a meta tensor stands in for the
    card), a tensor keeps its device and takes the dtype; ``_coef`` fills
    the kernel's two-element array from floats and tensors alike."""
    from approximategps_tpu_torch.models.svgp import _scalar

    like = torch.empty(3, dtype=torch.float32, device="meta")
    s = _scalar(1e-6, like)
    assert s.device == like.device and s.dtype == torch.float32 and s.ndim == 0
    t = _scalar(torch.tensor(2.0, dtype=torch.float64), torch.empty(2, dtype=torch.float32))
    assert t.device.type == "cpu" and t.dtype == torch.float32 and t.item() == 2.0
    assert _scalar(0.5, torch.empty(2, dtype=torch.float64)).dtype == torch.float64
    coef = panel_chol._coef(torch.tensor(1.3, dtype=torch.float64), 1e-6,
                            torch.empty(2, dtype=torch.float32))
    assert coef.dtype == torch.float32 and coef.tolist() == [np.float32(1.3), np.float32(1e-6)]
    assert panel_chol._coef(1.3, like.new_full((), 1e-6), like).device == like.device
