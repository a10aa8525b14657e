"""The f32 tensor-core route of the SVGP epilogue (rows 2 and 3,
``csrc/svgp_epilogue_mma.cu`` and ``csrc/svgp_epilogue_bwd_mma.cu``) on the
CPU: the rule that picks the kernel, and a host emulation of the kernels'
schedule and arithmetic in torch.

The emulation follows the kernels: K0 from exact differences of the jointly
centred points; the forward's tiles of 128 inducing columns, each over the
keys from its first column on with Se weighted 2 below the diagonal, 1 on
it and 0 above; the pullback's full T = Se·K0 and the upper tile pairs of
S̄e, mirrored; every product in 3xTF32 (A split by truncation, B by
rounding, the low halves truncated again as the tensor cores read them, f32
sums).  It pins the algebra and the error budget that the kernels' f32
limits rely on (chip_smoke.py phase 3: 1e-4 forward, 1e-3 pullback,
relative to max|plain|): here the emulation stays within 1e-5 of the plain
version in f64 (the plain version in f32 sits about 1e-6 away), and with
one TF32 product in place of three the forward's variance moves about 100
times further, to the forward's limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.ops.svgp_epilogue import svgp_data_epilogue as jax_epilogue
from approximategps_tpu_torch import config_context as torch_config
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.core.kernels import dk_from_k_for
from approximategps_tpu_torch.ops import svgp_epilogue

torch.set_num_threads(1)

TILE = 128  # svgp_epilogue_mma.cuh NA: inducing columns a tile
EMU_RTOL = 1e-5
MAPS = {"se": (tk.SqExponentialKernel, jk.SqExponentialKernel),
        "m12": (tk.Matern12Kernel, jk.Matern12Kernel),
        "m32": (tk.Matern32Kernel, jk.Matern32Kernel),
        "m52": (tk.Matern52Kernel, jk.Matern52Kernel)}

_MASK = -8192  # 0xffffe000: the 13 mantissa bits TF32 drops


def _trunc(x):
    return (x.view(torch.int32) & _MASK).view(torch.float32)


def _round(x):  # tf32_mma.cuh::tf32_split's hi
    return ((x.view(torch.int32) + 0x1000) & _MASK).view(torch.float32)


def _mm(A, B, terms=3):
    """A·B as the kernels form it: A_lo B_hi + A_hi B_lo + A_hi B_hi with A
    split by truncation and B by rounding, each lo truncated by the tensor
    cores; ``terms=1``: one TF32 product A_hi B_hi (A rounded)."""
    A, B = A.contiguous(), B.contiguous()
    bh = _round(B)
    if terms == 1:
        return _round(A) @ bh
    ah = _trunc(A)
    return _trunc(A - ah) @ bh + ah @ _trunc(B - bh) + ah @ bh


def _k0(Xs, Zs, kmap):
    Xc, Zc = svgp_epilogue._centre(Xs, Zs)
    r2 = ((Zc[:, None, :] - Xc[None, :, :]) ** 2).sum(-1)
    return Xc, Zc, r2, kmap.k_of_r2(r2)


def emulate_fwd(Xs, Zs, Se, ae, kmap, tile=TILE, terms=3):
    _, _, _, K0 = _k0(Xs, Zs, kmap)
    M = Zs.shape[0]
    var = torch.zeros(Xs.shape[0], dtype=Xs.dtype)
    for a0 in range(0, M, tile):
        a1 = min(M, a0 + tile)
        c, a = torch.arange(a0, M)[:, None], torch.arange(a0, a1)[None, :]
        w = torch.where(c > a, 2.0, torch.where(c == a, 1.0, 0.0)).to(Xs.dtype)
        D = _mm(K0[a0:].T, w * Se[a0:, a0:a1], terms)  # (B, tile)
        var = var + (D * K0[a0:a1].T).sum(1)
    return K0.T @ ae, var


def emulate_bwd(Xs, Zs, Se, ae, dmu, dvar, kmap, tile=TILE, terms=3):
    Xc, Zc, r2, K0 = _k0(Xs, Zs, kmap)
    M = Zs.shape[0]
    dk = dk_from_k_for(kmap)
    gprime = dk(K0) if dk is not None else kmap.dk_of_r2(r2)
    W = (2.0 * _mm(K0.T, Se, terms).T * dvar + ae[:, None] * dmu) * gprime
    Xs_bar = 2.0 * (Xc * W.sum(0)[:, None] - W.T @ Zc)
    Zs_bar = 2.0 * (Zc * W.sum(1)[:, None] - W @ Xc)
    Se_bar = torch.zeros((M, M), dtype=Xs.dtype)
    for a0 in range(0, M, tile):
        for b0 in range(a0, M, tile):
            Se_bar[a0:a0 + tile, b0:b0 + tile] = _mm(K0[a0:a0 + tile] * dvar,
                                                     K0[b0:b0 + tile].T, terms)
    Se_bar = torch.triu(Se_bar) + torch.triu(Se_bar, 1).T
    return Xs_bar, Zs_bar, Se_bar, K0 @ dmu


def _inputs(M, B, D, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((M, M)) / np.sqrt(M)
    return [rng.standard_normal((B, D)) + 1.5, rng.standard_normal((M, D)) + 1.5,
            R @ R.T + 0.1 * np.eye(M), rng.standard_normal(M), rng.standard_normal(B),
            rng.standard_normal(B)]


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)).double(), torch.as_tensor(np.array(b)).double()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("M,D,dtype,part", [
    (2048, 8, torch.float32, "mma"),     # the path's shape
    (1 << 16, 1, torch.float32, "mma"),  # any M: no K0 tile in shared memory
    (2048, 9, torch.float32, "simt"),    # D > 8: the SIMT kernel
    (2048, 8, torch.float64, "simt"),    # f64 always SIMT
    (1 << 16, 8, torch.float64, None),   # no SIMT tile fits: the wrapper raises
    (2048, 8, torch.float16, None),
])
def test_torch_epilogue_part_rule(M, D, dtype, part):
    assert svgp_epilogue.epilogue_part(M, D, dtype) == part


def test_torch_epilogue_part_ignores_the_simt_tile_cap():
    """config.epilogue_block_b caps only the SIMT forward's tile."""
    with torch_config(epilogue_block_b=2):
        assert svgp_epilogue.epilogue_part(2048, 8, torch.float32) == "mma"
        assert svgp_epilogue.epilogue_part(2048, 8, torch.float64) is None


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_epilogue_mma_emulation_forward(name):
    """M = 300 (three tiles, the last ragged), B = 500, D = 8: mu and var
    within 1e-5 of the plain version in f64."""
    kmap = MAPS[name][0]().kernel_map()
    a64 = [torch.tensor(a) for a in _inputs(300, 500, 8, seed=1)[:4]]
    mu0, var0 = svgp_epilogue.svgp_data_epilogue_plain(*a64, kmap)
    mu, var = emulate_fwd(*(a.float() for a in a64), kmap)
    assert _rel(mu, mu0) <= EMU_RTOL and _rel(var, var0) <= EMU_RTOL


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_epilogue_mma_emulation_pullback(name):
    """The four cotangents within 1e-5 of the closed-form plain pullback in
    f64; S̄e exactly symmetric."""
    kmap = MAPS[name][0]().kernel_map()
    a64 = [torch.tensor(a) for a in _inputs(300, 500, 8, seed=2)]
    ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(*a64, kmap)
    got = emulate_bwd(*(a.float() for a in a64), kmap)
    for what, g, r in zip(("Xs", "Zs", "Se", "ae"), got, ref):
        assert _rel(g, r) <= EMU_RTOL, what
    assert torch.equal(got[2], got[2].T)


def test_torch_epilogue_mma_needs_all_three_products():
    """One TF32 product moves the variance about 100 times further than
    3xTF32 does: the three terms are what keeps it at f32 accuracy."""
    kmap = tk.SqExponentialKernel().kernel_map()
    a64 = [torch.tensor(a) for a in _inputs(300, 500, 8, seed=1)[:4]]
    var0 = svgp_epilogue.svgp_data_epilogue_plain(*a64, kmap)[1]
    e3 = _rel(emulate_fwd(*(a.float() for a in a64), kmap)[1], var0)
    e1 = _rel(emulate_fwd(*(a.float() for a in a64), kmap, terms=1)[1], var0)
    assert e1 >= 30 * e3


@pytest.mark.parametrize("name", ["se", "m52"])
def test_torch_epilogue_mma_emulation_matches_pallas_interpret(name):
    """At small ragged shapes (M = 40 in tiles of 16, B = 70, D = 3) the
    emulation in f32 against the Pallas kernel in interpret mode in f64:
    the forward and its VJP, within 1e-5."""
    tcls, jcls = MAPS[name]
    kmap = tcls().kernel_map()
    a = _inputs(40, 70, 3, seed=3)
    with config_context(pallas_interpret=True, use_pallas=True):
        (mu_j, var_j), vjp = jax.vjp(lambda *x: jax_epilogue(*x, jcls.k_of_r2),
                                     *(jnp.asarray(v) for v in a[:4]))
        grads_j = vjp((jnp.asarray(a[4]), jnp.asarray(a[5])))
    a32 = [torch.tensor(v, dtype=torch.float32) for v in a]
    mu, var = emulate_fwd(*a32[:4], kmap, tile=16)
    assert _rel(mu, mu_j) <= EMU_RTOL and _rel(var, var_j) <= EMU_RTOL
    for what, g, r in zip(("Xs", "Zs", "Se", "ae"), emulate_bwd(*a32, kmap, tile=16), grads_j):
        assert _rel(g, r) <= EMU_RTOL, what
