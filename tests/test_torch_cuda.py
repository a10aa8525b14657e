"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test skips.  Run them on a
machine with one with
``python -m pytest --noconftest -q tests/test_torch_cuda.py`` (the
repository's ``conftest.py`` sets up JAX, which these tests do not use).
f64 tolerances as in the CPU tests: L 1e-10, J 1e-7 (amplified by
cond(K)), epilogue and slice 1e-9; the epilogue's pullback 1e-9 relative
to each cotangent's largest entry."""

import numpy as np
import pytest
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.core import linalg as tlinalg
from approximategps_tpu_torch.ops import panel_chol, svgp_epilogue

pytestmark = pytest.mark.gpu

MAPS = [tk.SqExponentialKernel, tk.Matern12Kernel, tk.Matern32Kernel, tk.Matern52Kernel]
MAP_IDS = ["se", "m12", "m32", "m52"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def _t(a, dev, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_gram_chol_inv_matches_plain(cls, cuda):
    Z = _t(1.2 * np.random.default_rng(0).standard_normal((200, 3)), cuda)  # 200: ragged panels
    kmap = cls().kernel_map()
    before = panel_chol.gram_chol_inv.launches
    L, J = panel_chol.gram_chol_inv(Z, 1.7, 1e-6, kmap)
    L0, J0 = panel_chol.gram_chol_inv_plain(Z, 1.7, 1e-6, kmap)
    assert panel_chol.gram_chol_inv.launches == before + 1
    assert L.shape == J.shape == (200, 200)
    torch.testing.assert_close(L, L0, atol=1e-10, rtol=0)
    torch.testing.assert_close(J, J0, atol=1e-7, rtol=0)
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("M", [200, 520])  # not multiples of the 64-wide panel
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_gram_chol_inv_f32_parts_match_plain(cls, M, cuda):
    """Row 1 in f32 (the panel steps with look-ahead and 3xTF32 products)
    against the plain version in f64 on the same inputs: ||dL||_F/||L||_F
    <= 1e-4 and max|LJ - I| <= 1e-3 (chip_smoke.py phase 3's limits), exact
    zeros above both diagonals, one launch a call, two calls equal
    bitwise."""
    Z = _t(np.random.default_rng(M).standard_normal((M, 8)), cuda, torch.float32)
    kmap = cls().kernel_map()
    before = panel_chol.gram_chol_inv.launches
    L, J = panel_chol.gram_chol_inv(Z, 1.3, 1e-6, kmap)
    L2, J2 = panel_chol.gram_chol_inv(Z, 1.3, 1e-6, kmap)
    assert panel_chol.gram_chol_inv.launches == before + 2
    L0, _ = panel_chol.gram_chol_inv_plain(Z.double(), 1.3, 1e-6, kmap)
    fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
    res = (L.double() @ J.double() - torch.eye(M, dtype=torch.float64, device=cuda)).abs().max()
    assert fro <= 1e-4 and res.item() <= 1e-3, (fro, res.item())
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()
    assert torch.equal(L, L2) and torch.equal(J, J2)


def test_torch_cuda_gram_chol_inv_parts_choose_and_raise(cuda):
    """The kernel is chosen by dtype alone, for both rows: f32 the panel
    steps, f64 the host loop; no route is forced (the wrappers take no
    part), and sig2 and jitter on the card serve as floats do."""
    assert panel_chol.gram_chol_inv_part(2048, 8, torch.float32) == "mma"
    assert panel_chol.gram_chol_inv_part(2048, 8, torch.float64) == "loop"
    kmap = tk.SqExponentialKernel().kernel_map()
    Z = _t(np.random.default_rng(1).standard_normal((70, 3)), cuda)
    with pytest.raises(TypeError):
        panel_chol.gram_chol_inv(Z, 1.0, 1e-6, kmap, "loop")
    for z in (Z, Z.float()):
        on_card = (torch.tensor(1.0, dtype=z.dtype, device=cuda),
                   torch.tensor(1e-6, dtype=z.dtype, device=cuda))
        for a, b in zip(panel_chol.gram_chol_inv(z, 1.0, 1e-6, kmap),
                        panel_chol.gram_chol_inv(z, *on_card, kmap)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_svgp_epilogue_matches_plain(cls, dtype, cuda):
    rng = np.random.default_rng(1)
    M, B = 100, 1001
    R = rng.standard_normal((M, M)) / np.sqrt(M)
    args = [_t(a, cuda, dtype) for a in (
        rng.standard_normal((B, 4)) + 3.0, rng.standard_normal((M, 4)) + 3.0,
        R @ R.T + 0.1 * np.eye(M), rng.standard_normal(M))]
    kmap = cls().kernel_map()
    before = svgp_epilogue.svgp_data_epilogue.launches
    mu, var = svgp_epilogue.svgp_data_epilogue(*args, kmap)
    mu0, var0 = svgp_epilogue.svgp_data_epilogue_plain(*args, kmap)
    assert svgp_epilogue.svgp_data_epilogue.launches == before + 1
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(mu, mu0, atol=tol, rtol=0)
    torch.testing.assert_close(var, var0, atol=tol, rtol=0)


def test_torch_cuda_wrappers_raise_on_what_they_do_not_take(cuda):
    kmap = tk.SqExponentialKernel().kernel_map()
    with pytest.raises(ValueError):
        panel_chol.gram_chol_inv(torch.zeros((64, 3), dtype=torch.bfloat16, device=cuda),
                                 1.0, 1e-6, kmap)
    with pytest.raises(ValueError):
        panel_chol.gram_chol_inv(torch.zeros((64, 65), device=cuda), 1.0, 1e-6, kmap)
    x = torch.zeros((10, 2), device=cuda)
    with pytest.raises(ValueError):
        svgp_epilogue.svgp_data_epilogue(x, torch.zeros((4, 2)), torch.eye(4, device=cuda),
                                         torch.zeros(4, device=cuda), kmap)


def _posterior(dev, dtype, parametrization=None):
    rng = np.random.default_rng(2)
    M = 512
    kernel = 0.9 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.8)
    fz = tgp.GP(kernel)(_t(rng.standard_normal((M, 3)), dev, dtype), 1e-6)
    A = 0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M)))
    q = tgp.MultivariateNormal(_t(0.3 * rng.standard_normal(M), dev, dtype), _t(A, dev, dtype))
    sva = tgp.SparseVariationalApproximation(fz, q, parametrization or tgp.NonCentered())
    return tgp.posterior(sva)


def test_torch_cuda_slice_runs_through_both_kernels(cuda):
    xs = _t(np.random.default_rng(3).standard_normal((5000, 3)), cuda)
    c0, c1 = panel_chol.gram_chol_inv.launches, svgp_epilogue.svgp_data_epilogue.launches
    post = _posterior(cuda, torch.float64)
    mu, var = post.predict_blocks(xs, block_size=2048)
    assert panel_chol.gram_chol_inv.launches == c0 + 1
    assert svgp_epilogue.svgp_data_epilogue.launches == c1 + 3
    with tgp.config_context(use_kernels=False):
        mu0, var0 = _posterior(cuda, torch.float64).mean_and_var(xs)
    torch.testing.assert_close(mu, mu0, atol=1e-9, rtol=0)
    torch.testing.assert_close(var, var0, atol=1e-9, rtol=0)


def test_torch_cuda_sweep_raises_where_the_epilogue_tile_does_not_fit(cuda):
    """The SIMT forward (f64 here) has no tiling over M: where its tile does
    not fit, the sweep raises instead of serving the blocks through the
    plain route.  The f32 tensor-core forward has no such tile and serves."""
    xs = torch.zeros((100, 3), dtype=torch.float64, device=cuda)
    with tgp.config_context(epilogue_block_b=2):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _posterior(cuda, torch.float64).predict_blocks(xs)
        before = svgp_epilogue.svgp_data_epilogue.launches
        mu, var = _posterior(cuda, torch.float32).predict_blocks(xs.float())
        assert svgp_epilogue.svgp_data_epilogue.launches == before + 1
        assert torch.isfinite(mu).all() and torch.isfinite(var).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_cuda_chol_inv_matches_plain(dtype, cuda):
    """Kernel 4: (L, L⁻¹) of a given matrix, M = 200 (ragged panels); the
    kernel factors the symmetric part of a slightly asymmetric A."""
    rng = np.random.default_rng(4)
    R = rng.standard_normal((200, 200))
    A = R @ R.T / 200 + 0.5 * np.eye(200) + 1e-4 * rng.standard_normal((200, 200))
    At = _t(A, cuda, dtype)
    before = panel_chol.chol_inv.launches
    L, J = panel_chol.chol_inv(At)
    L0, J0 = panel_chol.chol_inv_plain(At)
    assert panel_chol.chol_inv.launches == before + 1
    tol = (1e-10, 1e-9) if dtype == torch.float64 else (1e-4, 1e-3)
    torch.testing.assert_close(L, L0, atol=tol[0], rtol=0)
    torch.testing.assert_close(J, J0, atol=tol[1], rtol=0)
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("M,offset", [(200, 0), (201, 0), (520, 0), (2048, 0), (200, 1)],
                         ids=["200", "201", "520", "2048", "200-unaligned"])
def test_torch_cuda_chol_inv_f32_steps_match_plain(M, offset, cuda):
    """Row 4 in f32 on the panel steps, A's tiles read and symmetrized
    (16-byte row reads where M is a multiple of 4 and A is aligned, scalar
    ones at M = 201 and for an A that starts one float past an aligned
    address), against the plain version in f64 on the same inputs:
    ||dL||_F/||L||_F <= 1e-4 and max|LJ - I| <= 1e-3 (chip_smoke.py phase 3's
    limits), exact zeros above both diagonals, two calls equal bitwise."""
    rng = np.random.default_rng(M + offset)
    Z = rng.standard_normal((M, 8))
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    A = 1.3 * np.exp(-0.5 * r2) + 1e-6 * np.eye(M) + 1e-7 * np.triu(np.ones((M, M)), 1)
    buf = torch.empty(M * M + offset, dtype=torch.float32, device=cuda)
    At = buf[offset:].view(M, M)
    At.copy_(_t(A, cuda, torch.float32))
    before = panel_chol.chol_inv.launches
    L, J = panel_chol.chol_inv(At)
    L2, J2 = panel_chol.chol_inv(At)
    assert panel_chol.chol_inv.launches == before + 2
    L0, _ = panel_chol.chol_inv_plain(At.double())
    fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
    res = (L.double() @ J.double() - torch.eye(M, dtype=torch.float64, device=cuda)).abs().max()
    assert fro <= 1e-4 and res.item() <= 1e-3, (fro, res.item())
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()
    assert torch.equal(L, L2) and torch.equal(J, J2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_cuda_chol_inv_at_m8192_matches_plain(dtype, cuda):
    """Row 4 at M = 8192, the posterior build's shape above s_corr_max_m
    (128 panel steps in f32, 128 panels of the host loop in f64), on the SE
    Gram of 8192 points N(0, 1) in D = 8 plus jitter 1e-6, against the plain
    version (cuSOLVER) in f64: ||dL||_F/||L||_F and max|LJ - I| within
    chip_smoke.py's limits for that M (LARGE_F32_* or LARGE_F64_*), zeros above
    both diagonals."""
    import chip_smoke as cs

    gen = torch.Generator(device=cuda).manual_seed(8192)
    Z = torch.randn((8192, 8), generator=gen, device=cuda, dtype=torch.float64)
    r2 = tk.pairwise_sq_dist(Z, Z, mode="broadcast")
    A = 1.3 * torch.exp(-0.5 * r2) + 1e-6 * torch.eye(8192, dtype=torch.float64, device=cuda)
    del r2
    L0, _ = panel_chol.chol_inv_plain(A)
    before = panel_chol.chol_inv.launches
    L, J = panel_chol.chol_inv(A.to(dtype))
    assert panel_chol.chol_inv.launches == before + 1
    fro = (torch.linalg.norm(L.double() - L0) / torch.linalg.norm(L0)).item()
    res = (L.double() @ J.double() - torch.eye(8192, dtype=torch.float64, device=cuda)).abs().max()
    lim = (cs.LARGE_F32_FRO, cs.LARGE_F32_RES) if dtype == torch.float32 else \
        (cs.LARGE_F64_FRO, cs.LARGE_F64_RES)
    assert fro <= lim[0] and res.item() <= lim[1], (fro, res.item())
    assert not torch.triu(L, 1).any() and not torch.triu(J, 1).any()


@pytest.mark.parametrize("setting", ["defaults", "float32", "dense"])
def test_torch_cuda_m8192_step_launches_row4_once(setting, cuda):
    """Phase 22's step at M = 8192 (a smaller batch): the posterior build
    above s_corr_max_m launches row 4 once and row 1 never, in each of the
    three settings; under the defaults the projections are stored in bf16
    (compute_dtype "auto" on the card at M >= bf16_storage_min_m) and the
    value and gradients are finite."""
    from approximategps_tpu_torch.models import svgp as tsvgp

    cfg = {"defaults": {}, "float32": {"compute_dtype": "float32"},
           "dense": {"compute_dtype": "float32", "tri_matmul_min_m": 1 << 14}}[setting]
    gen = torch.Generator(device=cuda).manual_seed(22)
    M, B = 8192, 1024
    z = torch.randn((M, 8), generator=gen, device=cuda).requires_grad_()
    x = torch.randn((B, 8), generator=gen, device=cuda)
    y = torch.sin(x[:, 0])
    raw = torch.tensor([0.5, 0.5], device=cuda, requires_grad=True)
    with tgp.config_context(**cfg):
        f = tgp.GP(tgp.utils.softplus(raw[0]) * tgp.with_lengthscale(
            tgp.SqExponentialKernel(), tgp.utils.softplus(raw[1])))
        m = torch.zeros(M, device=cuda, requires_grad=True)
        sva = tgp.SparseVariationalApproximation(
            f(z, 1e-6), tgp.MultivariateNormal(m, torch.eye(M, device=cuda)))
        before = (panel_chol.chol_inv.launches, panel_chol.gram_chol_inv.launches)
        post = tgp.posterior(sva)
        assert post.cache.S_corr is None
        _, Kuf = post._A_and_Kuf(x)
        assert Kuf.dtype == (torch.bfloat16 if setting == "defaults" else torch.float32)
        assert tsvgp._tri_proj(M) == (setting != "dense")
        e = tgp.elbo(sva, f(x, 0.1), y, num_data=10 ** 6)
        grads = torch.autograd.grad(e, (raw, z, m))
    assert panel_chol.chol_inv.launches == before[0] + 2  # the posterior above and the elbo's
    assert panel_chol.gram_chol_inv.launches == before[1]
    assert bool(torch.isfinite(e)) and all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_svgp_epilogue_bwd_matches_plain(cls, cuda):
    """Kernel 3: all four cotangents against the closed-form plain version,
    M and B ragged against the tiles."""
    rng = np.random.default_rng(5)
    M, B = 150, 1001
    S0 = rng.standard_normal((M, M))
    args = [_t(a, cuda) for a in (
        rng.standard_normal((B, 4)) + 3.0, rng.standard_normal((M, 4)) + 3.0,
        0.5 * (S0 + S0.T), rng.standard_normal(M), rng.standard_normal(B),
        rng.standard_normal(B))]
    kmap = cls().kernel_map()
    before = svgp_epilogue.svgp_data_epilogue_bwd.launches
    got = svgp_epilogue.svgp_data_epilogue_bwd(*args, kmap)
    ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(*args, kmap)
    assert svgp_epilogue.svgp_data_epilogue_bwd.launches == before + 1
    for name, g, r in zip(("Xs", "Zs", "Se", "ae"), got, ref):
        assert (g - r).abs().max() <= 1e-9 * r.abs().max(), name
    assert torch.equal(got[2], got[2].T)


def test_torch_cuda_epilogue_autograd_launches_both_kernels(cuda):
    rng = np.random.default_rng(6)
    M, B = 64, 300
    S0 = rng.standard_normal((M, M))
    ts = [_t(a, cuda).requires_grad_() for a in (
        rng.standard_normal((B, 3)), rng.standard_normal((M, 3)), 0.5 * (S0 + S0.T),
        rng.standard_normal(M))]
    kmap = tk.SqExponentialKernel().kernel_map()
    c0 = svgp_epilogue.svgp_data_epilogue.launches
    c1 = svgp_epilogue.svgp_data_epilogue_bwd.launches
    mu, var = svgp_epilogue.svgp_data_epilogue(*ts, kmap)
    (mu.sum() + var.sum()).backward()
    assert svgp_epilogue.svgp_data_epilogue.launches == c0 + 1
    assert svgp_epilogue.svgp_data_epilogue_bwd.launches == c1 + 1
    ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(
        *(t.detach() for t in ts), torch.ones(B, dtype=torch.float64, device=cuda),
        torch.ones(B, dtype=torch.float64, device=cuda), kmap)
    for t, r in zip(ts, ref):
        torch.testing.assert_close(t.grad, r, atol=1e-9, rtol=1e-9)


# -- rows 2 and 3 in f32: the tensor-core kernels beside the SIMT ones ------


def _epilogue_args(M, B, D, dev, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((M, M)) / np.sqrt(M)
    return [_t(a, dev, torch.float32) for a in (
        rng.standard_normal((B, D)) + 3.0, rng.standard_normal((M, D)) + 3.0,
        R @ R.T + 0.1 * np.eye(M), rng.standard_normal(M), rng.standard_normal(B),
        rng.standard_normal(B))]


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


@pytest.mark.parametrize("part", ["mma", "simt"])
@pytest.mark.parametrize("shape", [(150, 1001, 3), (2050, 4097, 8), (64, 130, 1)],
                         ids=["150x1001", "2050x4097", "64x130"])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_svgp_epilogue_f32_parts_match_plain(cls, shape, part, cuda):
    """Both f32 forwards and pullbacks, M and B ragged against the 128-wide
    tiles and 128-point blocks, against the plain versions in f64 on the same
    inputs where the kernel takes r² by exact differences (the tensor-core
    kernels) and in f32 where it shares the plain version's |x|² identity
    (the SIMT kernels): relative to the largest entry, 1e-4 forward and 1e-3
    pullback (sums over M and B in other orders, signed cotangents that
    cancel); one launch a call; two runs equal bitwise; S̄e exactly
    symmetric.  At D = 1 some points lie very close to an inducing point,
    where the identity loses the digits of r² and Matérn-1/2's g′ ∝ 1/r
    carries that into X̄s of both identity routes; the tensor-core kernels,
    which take exact differences, stay within the limit of f64 there."""
    M, B, D = shape
    args = _epilogue_args(M, B, D, cuda, seed=10)
    a64 = [a.double() for a in args] if part == "mma" else args
    kmap = cls().kernel_map()
    before = svgp_epilogue.svgp_data_epilogue.launches
    mu, var = svgp_epilogue.svgp_data_epilogue(*args[:4], kmap, part)
    assert svgp_epilogue.svgp_data_epilogue.launches == before + 1
    mu0, var0 = svgp_epilogue.svgp_data_epilogue_plain(*a64[:4], kmap)
    assert _rel(mu, mu0) <= 1e-4 and _rel(var, var0) <= 1e-4
    again = svgp_epilogue.svgp_data_epilogue(*args[:4], kmap, part)
    assert torch.equal(mu, again[0]) and torch.equal(var, again[1])
    before = svgp_epilogue.svgp_data_epilogue_bwd.launches
    got = svgp_epilogue.svgp_data_epilogue_bwd(*args, kmap, part)
    assert svgp_epilogue.svgp_data_epilogue_bwd.launches == before + 1
    ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(*a64, kmap)
    for name, g, r in zip(("Xs", "Zs", "Se", "ae"), got, ref):
        assert _rel(g, r) <= 1e-3, name
    again = svgp_epilogue.svgp_data_epilogue_bwd(*args, kmap, part)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[2], got[2].T)


def test_torch_cuda_epilogue_autograd_f32_launches_the_mma_kernels(cuda):
    """f32 autograd through the Function: one launch of each tensor-core
    kernel (the default part at D <= 8), gradients as the closed form's."""
    rng = np.random.default_rng(11)
    M, B = 200, 700
    S0 = rng.standard_normal((M, M)) / np.sqrt(M)
    ts = [_t(a, cuda, torch.float32).requires_grad_() for a in (
        rng.standard_normal((B, 5)), rng.standard_normal((M, 5)), 0.5 * (S0 + S0.T),
        rng.standard_normal(M))]
    assert svgp_epilogue.epilogue_part(M, 5, torch.float32) == "mma"
    kmap = tk.Matern32Kernel().kernel_map()
    c0 = svgp_epilogue.svgp_data_epilogue.launches
    c1 = svgp_epilogue.svgp_data_epilogue_bwd.launches
    mu, var = svgp_epilogue.svgp_data_epilogue(*ts, kmap)
    (mu.sum() + var.sum()).backward()
    assert svgp_epilogue.svgp_data_epilogue.launches == c0 + 1
    assert svgp_epilogue.svgp_data_epilogue_bwd.launches == c1 + 1
    ones = torch.ones(B, dtype=torch.float32, device=cuda)
    ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(*(t.detach() for t in ts), ones, ones, kmap)
    for t, r in zip(ts, ref):
        assert _rel(t.grad, r) <= 1e-3


def test_torch_cuda_epilogue_parts_raise_on_what_they_do_not_take(cuda):
    """The tensor-core kernels take f32 with D <= 8 only; the SIMT forward
    needs its tile in shared memory; a part that does not exist raises."""
    kmap = tk.SqExponentialKernel().kernel_map()
    f64 = [a.double() for a in _epilogue_args(64, 100, 3, cuda, seed=12)]
    d9 = _epilogue_args(64, 100, 9, cuda, seed=12)
    for args in (f64, d9):
        with pytest.raises(ValueError, match="mma"):
            svgp_epilogue.svgp_data_epilogue(*args[:4], kmap, "mma")
        with pytest.raises(ValueError, match="mma"):
            svgp_epilogue.svgp_data_epilogue_bwd(*args, kmap, "mma")
    f32 = _epilogue_args(64, 100, 3, cuda, seed=12)
    with pytest.raises(ValueError, match="wmma"):
        svgp_epilogue.svgp_data_epilogue(*f32[:4], kmap, "wmma")
    with tgp.config_context(epilogue_block_b=2):
        with pytest.raises(ValueError, match="no tile"):
            svgp_epilogue.svgp_data_epilogue(*f32[:4], kmap, "simt")
        svgp_epilogue.svgp_data_epilogue(*f32[:4], kmap)  # the mma default serves


@pytest.mark.parametrize("case", ["mma", "simt f64", "mma mask"])
def test_torch_cuda_streaming_takes_several_blocks_a_call(case, cuda):
    """The full-data data term with several blocks a fused-epilogue call:
    N = 50,000 in blocks of 4096 (13 blocks, the last ragged), M = 256,
    D = 8, ARD SE, a non-trivial q; f32 on the tensor-core kernels, f64 on
    the SIMT ones, and f32 with a 0/1 mask.  The value and every leaf's
    gradient against the same sum built here one ``svgp_data_epilogue``
    call a block (the tail unpadded), and against ``use_kernels=False``
    (the checkpointed Gram blocks): relative to the largest entry, 1e-3 in
    f32 (the f32 streaming check's limit), 1e-9 in f64.  Each kernel
    launches once a group, ceil(13 / k) times, where k > 1 blocks fit
    the (M, block) Gram's size."""
    from approximategps_tpu_torch.core.quadrature import (DefaultExpectationMethod,
                                                          expected_loglikelihood)
    from approximategps_tpu_torch.models import svgp as msvgp
    from approximategps_tpu_torch.models import svgp_streaming
    from approximategps_tpu_torch.utils.bijectors import softplus

    dtype = torch.float64 if case == "simt f64" else torch.float32
    limit = 1e-9 if dtype == torch.float64 else 1e-3
    N, M, D, block = 50_000, 256, 8, 4096
    n_blocks = -(-N // block)
    rng = np.random.default_rng(21)
    x = _t(rng.standard_normal((N, D)), cuda, dtype)
    y = torch.sin(x[:, 0]) + 0.1 * _t(rng.standard_normal(N), cuda, dtype)
    w = _t(rng.random(N) < 0.7, cuda, dtype) if case == "mma mask" else None
    leaves = {"k": np.r_[0.5, np.full(D, 1.0)], "z": rng.standard_normal((M, D)),
              "m": 0.3 * rng.standard_normal(M),
              "A": 0.6 * np.eye(M) + 0.02 * np.tril(rng.standard_normal((M, M)))}
    lik = tgp.GaussianLikelihood(0.1)

    def sva_of(p):
        kern = softplus(p["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                          softplus(p["k"][1:]))
        q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
        return tgp.SparseVariationalApproximation(tgp.GP(kern)(p["z"], 1e-6), q)

    def streamed(p):
        sva = sva_of(p)
        if w is None:
            return tgp.streaming_elbo(sva, lik, x, y, block_size=block)
        return (svgp_streaming.streaming_data_term(sva, lik, x, y, block_size=block, mask=w)
                - msvgp.prior_kl(sva))

    def per_block(p):
        sva = sva_of(p)
        prior = sva.fz.f
        _, Lk_inv = tlinalg.chol_with_inv(sva.fz.cov())
        B = sva.q.scale_tril
        eye = torch.eye(M, dtype=dtype, device=cuda)
        S = tlinalg.symmetrize(Lk_inv.T @ ((B @ B.T - eye) @ Lk_inv))
        operands = msvgp._epilogue_operands(prior, sva.fz.x, Lk_inv.T @ sva.q.mean, S,
                                            prefer=True)
        total = 0.0
        for s in range(0, N, block):
            mu, var = msvgp._epilogue_mu_var(prior, x[s:s + block], operands)
            ell = expected_loglikelihood(DefaultExpectationMethod(), lik, mu, var,
                                         y[s:s + block])
            total = total + torch.sum(ell if w is None else ell * w[s:s + block])
        return total - msvgp.prior_kl(sva)

    def value_and_grad(fn):
        p = {k: _t(v, cuda, dtype).requires_grad_() for k, v in leaves.items()}
        v = fn(p)
        return v, dict(zip(p, torch.autograd.grad(v, list(p.values()))))

    k = svgp_streaming._fused_blocks_per_call(n_blocks, block, M, D, dtype, cuda)
    assert 1 < k < n_blocks
    groups = -(-n_blocks // k)
    runs = []
    for fn in (streamed, per_block):
        c0 = svgp_epilogue.svgp_data_epilogue.launches
        c1 = svgp_epilogue.svgp_data_epilogue_bwd.launches
        runs.append(value_and_grad(fn))
        assert (svgp_epilogue.svgp_data_epilogue.launches - c0,
                svgp_epilogue.svgp_data_epilogue_bwd.launches - c1) == \
            ((groups, groups) if fn is streamed else (n_blocks, n_blocks))
    with tgp.config_context(use_kernels=False):
        runs.append(value_and_grad(streamed))
    (v, g), *refs = runs
    for name, (v0, g0) in zip(("per block", "plain"), refs):
        assert _rel(v, v0) <= limit, name
        for leaf in leaves:
            assert _rel(g[leaf], g0[leaf]) <= limit, (name, leaf)


def test_torch_cuda_centered_posterior_runs_through_chol_inv(cuda):
    """Centered needs the (L, L⁻¹) kernel of a given matrix: one launch of
    chol_inv, and the same posterior as the plain route."""
    before = panel_chol.chol_inv.launches
    post = _posterior(cuda, torch.float64, tgp.Centered())
    assert panel_chol.chol_inv.launches == before + 1
    with tgp.config_context(use_kernels=False):
        plain = _posterior(cuda, torch.float64, tgp.Centered())
    # relative to each array's largest entry: S = J^T (B B^T - I) J with
    # B = J Lq carries J four times, so its error grows with cond(Kuu)^2
    for name in ("Kuu_L", "Lk_inv", "alpha", "S_corr"):
        a, b = getattr(post.cache, name), getattr(plain.cache, name)
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= 1e-7, (name, err)


def test_torch_cuda_chol_with_inv_gradient(cuda):
    rng = np.random.default_rng(7)
    R = rng.standard_normal((130, 130))
    A = _t(R @ R.T / 130 + 0.5 * np.eye(130), cuda).requires_grad_()
    before = panel_chol.chol_inv.launches
    L, J = tlinalg.chol_with_inv(A)
    J.sum().backward()
    assert panel_chol.chol_inv.launches == before + 1
    A2 = A.detach().clone().requires_grad_()
    with tgp.config_context(chol_mode="plain"):
        tlinalg.chol_with_inv(A2)[1].sum().backward()
    torch.testing.assert_close(A.grad, A2.grad, atol=1e-9, rtol=1e-9)


# -- kernel 5: the fused Gram matvec -----------------------------------------


# each pass kernel, whichever pass_part picks (None), and each forced: the
# narrow SIMT pass in both types, the wide tensor-core pass in f32
PARTS = [(None, torch.float64), (None, torch.float32), ("simt", torch.float64),
         ("simt", torch.float32), ("mma", torch.float32)]
PART_IDS = ["dtype0", "dtype1", "simt-f64", "simt-f32", "mma-f32"]


@pytest.mark.parametrize("R", [1, 2, 8, 16, 17, 32, 48, 128])
@pytest.mark.parametrize("part,dtype", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_gram_matvec_matches_plain(cls, part, dtype, R, cuda):
    """The three maps g, g′ and r²·g′ (the lengthscale's cotangent),
    N = 3001 and M = 2500 ragged against the 64-, 128- and 256-row blocks
    and the 32-, 64- and 128-key tiles, D = 3 padded to 4; one launch a call
    at every width (R = 48 and 128 included); relative to the largest
    entry: f64 1e-12, f32 1e-5 (sums over 2500 keys in another order)."""
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(8)
    Xq = _t(rng.uniform(0.0, 3.0, (3001, 3)), cuda, dtype)
    Zk = _t(rng.uniform(0.0, 3.0, (2500, 3)), cuda, dtype)
    V = _t(rng.standard_normal((2500, R) if R > 1 else 2500), cuda, dtype)
    kmap = cls().kernel_map()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for deriv in (False, True, 2):
        before = gram_matvec.gram_matvec.launches
        out = gram_matvec.gram_matvec_pass(Xq, Zk, V, kmap, deriv, part=part)
        assert gram_matvec.gram_matvec.launches == before + 1
        ref = gram_matvec.gram_matvec_plain(Xq, Zk, V, kmap, deriv)
        assert out.shape == ref.shape
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= tol, deriv


@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_gram_matvec_self_gram_pullback(cls, cuda):
    """The Function on the self-Gram (r² = 0 on the diagonal) against
    autograd through the plain pass, f64, 1e-10 relative; the launches are
    the forward and the passes its pullback counted."""
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(9)
    X = rng.uniform(0.0, 3.0, (1500, 2))
    V, W = rng.standard_normal((1500, 16)), rng.standard_normal((1500, 16))
    kmap = cls().kernel_map()
    ts = [_t(a, cuda).requires_grad_() for a in (X, X, V)]
    before, passes = gram_matvec.gram_matvec.launches, gram_matvec.pullback_passes["passes"]
    got = torch.autograd.grad(gram_matvec.gram_matvec(*ts, kmap), ts, _t(W, cuda))
    assert gram_matvec.gram_matvec.launches - before == \
        1 + gram_matvec.pullback_passes["passes"] - passes == 4
    ref = torch.autograd.grad(gram_matvec.gram_matvec_plain(*ts, kmap), ts, _t(W, cuda))
    for name, g, r in zip(("Xq", "Zk", "V"), got, ref):
        assert ((g - r).abs().max() / r.abs().max()).item() <= 1e-10, name


@pytest.mark.parametrize("R", [1, 16, 32, 48])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_gram_matvec_self_pullback(cls, dtype, R, cuda):
    """``gram_matvec_self`` on 1500 points with repeats (r² = 0 off the
    diagonal): X̄ and V̄ against autograd through the plain pass in f64 on
    the same inputs, f64 1e-10 and f32 1e-4 relative to each cotangent's
    largest entry.  In f32 the pullback is one launch at every width (two
    chunks inside it at R = 48); in f64 it is the general pullback's
    passes."""
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(90 + R)
    X = rng.uniform(0.0, 3.0, (1500, 2))
    X[1000:1100] = X[:100]
    V = rng.standard_normal((1500, R) if R > 1 else 1500)
    W = rng.standard_normal(V.shape)
    kmap = cls().kernel_map()
    Xt, Vt = _t(X, cuda, dtype).requires_grad_(), _t(V, cuda, dtype).requires_grad_()
    before, passes = gram_matvec.gram_matvec.launches, gram_matvec.pullback_passes["passes"]
    out = gram_matvec.gram_matvec_self(Xt, Vt, kmap)
    assert gram_matvec.gram_matvec.launches == before + 1
    got = torch.autograd.grad(out, (Xt, Vt), _t(W, cuda, dtype))
    added = gram_matvec.gram_matvec.launches - before - 1
    assert added == gram_matvec.pullback_passes["passes"] - passes
    assert added == 1 if dtype == torch.float32 else added > 1
    ts = [Xt.detach().double().requires_grad_() for _ in range(2)]
    ts.append(Vt.detach().double().requires_grad_())
    ref = torch.autograd.grad(gram_matvec.gram_matvec_plain(*ts, kmap), ts, _t(W, cuda))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for name, g, r in (("X", got[0], ref[0] + ref[1]), ("V", got[1], ref[2])):
        assert g.dtype == dtype
        assert ((g.double() - r).abs().max() / r.abs().max()).item() <= tol, name


@pytest.mark.parametrize("what,R", [("simt", 1), ("simt", 16), ("mma", 16), ("mma", 48),
                                    ("self_bwd", 1), ("self_bwd", 16), ("self_bwd", 48)])
def test_torch_cuda_gram_matvec_repeats_bitwise(what, R, cuda):
    """Each block writes its rows once in a fixed order: two runs of each
    kernel agree bit for bit (f32, N = M = 4099, D = 2, Matérn-5/2)."""
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(7)
    X = _t(rng.uniform(0.0, 10.0, (4099, 2)), cuda, torch.float32)
    V, W = (_t(rng.standard_normal((4099, R)), cuda, torch.float32) for _ in range(2))
    kmap = tk.Matern52Kernel().kernel_map()
    if what == "self_bwd":
        run = lambda: torch.cat(gram_matvec.gram_matvec_self_bwd(X, V, W, kmap), 1)  # noqa: E731
    else:
        run = lambda: gram_matvec.gram_matvec_pass(X, X, V, kmap, part=what)  # noqa: E731
    assert torch.equal(run(), run())


def test_torch_cuda_gram_matvec_raises_on_what_it_does_not_take(cuda):
    from approximategps_tpu_torch.ops import gram_matvec

    kmap = tk.SqExponentialKernel().kernel_map()
    x = torch.zeros((10, 2), device=cuda)
    for args in [
        (x.bfloat16(), x.bfloat16(), torch.zeros(10, device=cuda).bfloat16()),
        (torch.zeros((10, 9), device=cuda), torch.zeros((10, 9), device=cuda),
         torch.zeros(10, device=cuda)),
        (x, x, torch.zeros((10, 129), device=cuda)),
        (x, x.cpu(), torch.zeros(10, device=cuda)),
        (x, x.double(), torch.zeros(10, device=cuda)),
    ]:
        with pytest.raises(ValueError):
            gram_matvec.gram_matvec_pass(*args, kmap)
    with pytest.raises(ValueError):  # the wide pass is f32 only
        gram_matvec.gram_matvec_pass(x.double(), x.double(), torch.zeros(10, device=cuda).double(),
                                     kmap, part="mma")
    v = torch.zeros((10, 3), device=cuda)
    for args in [(x, v, v[:, :2]), (x, v.double(), v.double()), (x[:9], v, v)]:
        with pytest.raises(ValueError):
            gram_matvec.gram_matvec_self_bwd(*args, kmap)


def test_torch_cuda_logpdf_slq_runs_through_the_kernel(cuda):
    """The matrix-free value and gradient on the card, f64, N = 2000: every
    matvec on the kernel, launches = counted matvecs + pullback passes, and
    the plain path's value to 1e-8 and gradient to 1e-7."""
    from approximategps_tpu_torch import convert
    from approximategps_tpu_torch.models import iterative
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(10)
    x = _t(rng.uniform(0.0, 10.0, (2000, 2)), cuda)
    y = torch.sin(x[:, 0]) + 0.1 * _t(rng.standard_normal(2000), cuda)
    probes = _t(rng.choice([-1.0, 1.0], size=(16, 2000)), cuda)
    theta0 = np.log(np.expm1(np.array([1.5, 1.2, 0.1])))
    kw = dict(probes=probes, lanczos_iters=30, cg_tol=1e-10, precond_rank=64,
              block_size=512)

    def value_and_grad():
        theta = _t(theta0, cuda).requires_grad_()
        v = tgp.logpdf_slq(convert.build_exact_fx(theta, x), y, **kw)
        return v.detach(), torch.autograd.grad(v, theta)[0]

    iterative.reset_stats()
    before, passes = gram_matvec.gram_matvec.launches, gram_matvec.pullback_passes["passes"]
    v, g = value_and_grad()
    assert iterative.stats["matvec_plain"] == 0 and iterative.stats["matvec_fused"] > 0
    assert gram_matvec.gram_matvec.launches - before == \
        iterative.stats["matvec_fused"] + gram_matvec.pullback_passes["passes"] - passes
    with tgp.config_context(use_kernels=False):
        v0, g0 = value_and_grad()
    assert abs((v - v0).item()) <= 1e-8 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-7


@pytest.mark.parametrize("R", [1, 16, 48])
def test_torch_cuda_self_pullback_takes_column_major_inputs(R, cuda):
    """The self-Gram pullback with V and Ō in column-major strides (the
    logdet surrogate's V = w∘Zᵀ has them): V̄ comes out row by row as the
    kernel writes it, equal bitwise to the same call on contiguous copies
    and to the f64 plain version to 1e-5."""
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(14)
    X = _t(rng.uniform(0.0, 5.0, (3000, 2)), cuda, torch.float32)
    V, O = (_t(rng.standard_normal((R, 3000)), cuda, torch.float32).T for _ in range(2))
    assert not V.is_contiguous() or R == 1
    se = tgp.SqExponentialKernel().kernel_map()
    got = gram_matvec.gram_matvec_self_bwd(X, V, O, se)
    want = gram_matvec.gram_matvec_self_bwd(X, V.contiguous(), O.contiguous(), se)
    ref = gram_matvec.gram_matvec_self_bwd_plain(X.double(), V.double(), O.double(), se)
    for a, b, r in zip(got, want, ref):
        assert torch.equal(a, b)
        assert ((a.double() - r).abs().max() / r.abs().max()).item() <= 1e-5


def test_torch_cuda_lengthscale_cotangent_keeps_f32_digits(cuda):
    """Row 5's isotropic-lengthscale cotangent from the r²·g′ pass on the
    card: the θ-cotangent of Σ a∘(K b) in f32 against f64 (5e-6 of the
    lengthscale entry; read 1.5e-6 on an H100) on the self-Gram and the
    cross route, where the
    points' cotangents lost 3.3e-5 of it on the CPU
    (``test_torch_lengthscale_cotangent_keeps_f32_digits``), one pass more
    a pullback."""
    from approximategps_tpu_torch.ops import gram_matvec
    from approximategps_tpu_torch.utils.bijectors import softplus

    rng = np.random.default_rng(38)
    x = rng.uniform(0.0, 10.0, (1500, 2))
    a, b = rng.standard_normal((2, 1500, 16))
    theta = np.log(np.expm1(np.array([1.5, 1.2])))

    def cot(dtype, cross):
        th = _t(theta, cuda, dtype).requires_grad_()
        X = _t(x, cuda, dtype)
        kern = softplus(th[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(), softplus(th[1]))
        out = gram_matvec.fused_stationary_matvec(kern, X, X if cross else None)(_t(b, cuda, dtype))
        passes = gram_matvec.pullback_passes["passes"]
        g = torch.autograd.grad(torch.sum(_t(a, cuda, dtype) * out), th)[0].double()
        assert gram_matvec.pullback_passes["passes"] == passes + 1
        return g

    for cross in (False, True):
        g32, g64 = cot(torch.float32, cross), cot(torch.float64, cross)
        assert ((g32 - g64).abs() / g64.abs())[1].item() <= 5e-6


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of this one process over NCCL on the card, and its mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=timedelta(seconds=120))
    yield tgp.parallel.data_mesh(device="cuda:0")
    dist.destroy_process_group()


def _svgp_elbo_case(dev, N=61, M=8):
    from approximategps_tpu_torch.utils.bijectors import softplus

    rng = np.random.default_rng(12)
    x = _t(rng.uniform(0.0, 10.0, N), dev)
    y = torch.sin(x) + 0.1 * _t(rng.standard_normal(N), dev)
    p = {"k": _t([0.5, 0.5], dev), "z": _t(np.linspace(0.0, 10.0, M), dev),
         "m": _t(0.3 * rng.standard_normal(M), dev), "A": _t(np.eye(M), dev)}
    p = {k: v.requires_grad_() for k, v in p.items()}

    def fn(q, xb, yb):
        kern = softplus(q["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                          softplus(q["k"][1]))
        f = tgp.GP(kern)
        sva = tgp.SparseVariationalApproximation(
            f(q["z"], 1e-6), tgp.MultivariateNormal(q["m"], torch.tril(q["A"])))
        return tgp.elbo(sva, f(xb, 0.1), yb, num_data=N)

    return fn, p, x, y


def test_torch_cuda_dp_elbo_world_of_one_matches_single_process(nccl_mesh, cuda):
    """Items 1–3 of the data-parallel tests on the card: ``make_dp_elbo``'s
    value and gradients over an NCCL world of one equal ``elbo``'s, f64,
    1e-12."""
    fn, p, x, y = _svgp_elbo_case(cuda)
    v = tgp.parallel.make_dp_elbo(fn, nccl_mesh)(p, x, y)
    g = torch.autograd.grad(v, list(p.values()))
    v0 = fn(p, x, y)
    g0 = torch.autograd.grad(v0, list(p.values()))
    assert abs((v - v0).item()) <= 1e-12 * abs(v0.item())
    for a, b in zip(g, g0):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-12


def test_torch_cuda_mesh_matrix_free_world_of_one_runs_the_band(nccl_mesh, cuda):
    """Item 9 on the card, f64, N = 2000 over an NCCL world of one: the band
    matvec (row 5's cross pass), ``logpdf_slq``'s value and θ-gradient,
    ``posterior_cg`` and ``newton_inner_loop_cg`` (chunked on the cross
    pass, dense on the stored band) against the single-process path; every
    matvec on the kernel."""
    from approximategps_tpu_torch import convert
    from approximategps_tpu_torch.models import iterative
    from approximategps_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(13)
    x = _t(rng.uniform(0.0, 10.0, (2000, 2)), cuda)
    y = torch.sin(x[:, 0]) + 0.1 * _t(rng.standard_normal(2000), cuda)
    probes = _t(rng.choice([-1.0, 1.0], size=(8, 2000)), cuda)
    V = _t(rng.standard_normal((2000, 3)), cuda)
    theta0 = np.log(np.expm1(np.array([1.5, 1.2, 0.1])))
    fx = convert.build_exact_fx(_t(theta0, cuda), x)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    iterative.reset_stats()
    before = gram_matvec.gram_matvec.launches
    mv = iterative.kernel_matvec(fx.f.kernel, x, fx.noise, mesh=nccl_mesh)
    assert rel(mv(V), iterative.kernel_matvec(fx.f.kernel, x, fx.noise)(V)) <= 1e-12
    assert iterative.stats["matvec_plain"] == 0
    assert gram_matvec.gram_matvec.launches - before == iterative.stats["matvec_fused"] == 2

    def slq(mesh):
        theta = _t(theta0, cuda).requires_grad_()
        v = tgp.logpdf_slq(convert.build_exact_fx(theta, x), y, probes=probes, lanczos_iters=20,
                           cg_tol=1e-10, mesh=mesh)
        return v.detach(), torch.autograd.grad(v, theta)[0]

    (v, g), (v0, g0) = slq(nccl_mesh), slq(None)
    assert abs((v - v0).item()) <= 1e-9 * abs(v0.item()) and rel(g, g0) <= 1e-7
    with torch.no_grad():
        xs = _t(rng.uniform(0.0, 10.0, (23, 2)), cuda)
        got = tgp.posterior_cg(fx, y, tol=1e-10, mesh=nccl_mesh).mean_and_var(xs)
        want = tgp.posterior_cg(fx, y, tol=1e-10).mean_and_var(xs)
    assert rel(got[0], want[0]) <= 1e-8 and rel(got[1], want[1]) <= 1e-6
    yb = _t((rng.uniform(size=2000) > 0.5).astype(np.float64), cuda)
    kern = fx.f.kernel
    for storage in ("chunked", "dense"):
        f1 = tgp.newton_inner_loop_cg(tgp.BernoulliLikelihood(), yb, kern, x, cg_tol=1e-10,
                                      tol=1e-10, precond_rank=0, storage=storage,
                                      mesh=nccl_mesh)
        f0 = tgp.newton_inner_loop_cg(tgp.BernoulliLikelihood(), yb, kern, x, cg_tol=1e-10,
                                      tol=1e-10, precond_rank=0, storage=storage)
        assert rel(f1, f0) <= 1e-7, storage


# -- the Vecchia band kernel -------------------------------------------------


def _band_windows(N, D, k, seed):
    """Previous-k windows of points about a lengthscale apart (the bench's
    spacing), every tenth point a copy of the one before it (a deflated
    pivot); the first k rows have masked slots."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D))
    X[1::10] = X[0::10][: X[1::10].shape[0]]
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    valid = (idx >= 0).astype(np.float64)
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    return np.ascontiguousarray(xw), valid


# (D, k, N): k on both sides of each template width's edge (a window is padded to 8, 16,
# 32 or 64 rows) and at the kernels' limits, N ragged against every width's block.  At
# k = 33 the windows are at D = 3: at D = 2, N = 301 (SE, no nugget) f32 roundoff
# decides (where a window's point repeats a neighbour, F's floor multiplies the band's
# solve error by (8 eps)^(-1/2)), and f32 pullbacks lie up to 4.7e-4 from the f64 one;
# at D = 3 each is near 1e-6 (scripts/f32_spread_vecchia_torch.py prints both)
VECCHIA_CASES = ((1, 32, 1001), (2, 32, 777), (3, 7, 501), (2, 8, 301), (1, 9, 301),
                 (2, 16, 301), (3, 17, 301), (3, 33, 301), (8, 64, 301))


@pytest.mark.parametrize("layout", ["nd", "t", "bc"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_vecchia_band_matches_plain(cls, dtype, layout, cuda):
    """Both layouts and a broadcast mask (``bc``: ``predict_knn``'s, on the
    windows past the first k), with and without a nugget, slot k in and out
    of it, k on both sides of each width's edge, N ragged; relative to the
    largest entry: f64 1e-12, f32 1e-4 (each pivot rounds in another order,
    amplified by the window Grams' conditioning); masked slots exactly 0;
    two calls give the same bits."""
    from approximategps_tpu_torch.ops import batched_chol

    kmap = cls().kernel_map()
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for D, k, N in VECCHIA_CASES:
        xw, valid = _band_windows(N, D, k, seed=D)
        a, v = _t(xw, cuda, dtype), _t(valid, cuda, dtype)
        if layout == "bc":
            a, v = a[k:], v.new_ones(()).expand(N - k, k)
        for nugget, self_ in ((None, True), (0.1, False), (0.1, True)):
            nug = None if nugget is None else torch.tensor([nugget], dtype=dtype, device=cuda)
            if layout == "t" and self_:
                run = lambda: batched_chol.vecchia_band_t(  # noqa: E731
                    a.permute(1, 2, 0).contiguous(), v.T.contiguous(), kmap, nug)
            else:
                run = lambda: batched_chol.vecchia_band(a, v, kmap, nug, self_)  # noqa: E731
            before = batched_chol.vecchia_band.launches
            got = run()
            assert batched_chol.vecchia_band.launches == before + 1
            assert torch.equal(got, run())
            ref = batched_chol.vecchia_band_plain(a, v, kmap, nug, self_)
            assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol, (D, k, nugget)
            assert bool((got[:, :k][v == 0] == 0).all())


def test_torch_cuda_vecchia_band_raises_on_what_it_does_not_take(cuda):
    from approximategps_tpu_torch.ops import batched_chol

    kmap = tk.SqExponentialKernel().kernel_map()
    xw = torch.zeros((10, 2, 5), device=cuda)
    v = torch.ones((10, 4), device=cuda)
    for args in [
        (xw.bfloat16(), v.bfloat16()),
        (torch.zeros((10, 9, 5), device=cuda), v),
        (torch.zeros((10, 2, 66), device=cuda), torch.ones((10, 65), device=cuda)),
        (xw, v.cpu()),
        (xw, v.double()),
        (xw, torch.ones((10, 3), device=cuda)),
    ]:
        with pytest.raises(ValueError):
            batched_chol.vecchia_band_pass(*args, kmap)
    with pytest.raises(ValueError):
        batched_chol.vecchia_band_pass(xw, v, kmap, torch.ones(2, device=cuda))


def test_torch_cuda_vecchia_paths_launch_once(cuda):
    """The band build and ``predict_knn`` each launch the kernel once and
    agree with the plain route in f64."""
    from approximategps_tpu_torch.ops import batched_chol

    rng = np.random.default_rng(12)
    x = _t(np.cumsum(rng.uniform(0.5, 1.5, 3000)), cuda)
    kern = 1.3 * tgp.with_lengthscale(tgp.Matern32Kernel(), 1.1)
    before = batched_chol.vecchia_band.launches
    band = tgp.approx_root_prec_band(x, 16, kern)
    assert batched_chol.vecchia_band.launches == before + 1
    with tgp.config_context(use_kernels=False):
        band0 = tgp.approx_root_prec_band(x, 16, kern, block_size=1024)
    assert ((band - band0).abs().max() / band0.abs().max()).item() <= 1e-12
    X = _t(rng.uniform(0.0, 50.0, (4000, 2)), cuda)
    Xs = _t(rng.uniform(0.0, 50.0, (900, 2)), cuda)
    y = torch.sin(X[:, 0])
    fx = tgp.GP(kern)(X, 0.1)
    before = batched_chol.vecchia_band.launches
    mu, var = tgp.predict_knn(fx, y, Xs, k=16, test_block=256)
    assert batched_chol.vecchia_band.launches == before + 1
    with tgp.config_context(use_kernels=False):
        mu0, var0 = tgp.predict_knn(fx, y, Xs, k=16, test_block=256)
    assert ((mu - mu0).abs().max() / mu0.abs().max()).item() <= 1e-12
    assert ((var - var0).abs().max() / var0.abs().max()).item() <= 1e-12


# -- the Vecchia band pullback kernel (row 9) ----------------------------------


def _bwd_windows(N, D, k, seed):
    """Previous-k windows (N, D, k+1) of points about a lengthscale apart and
    their (N, k) mask; every third window repeats a neighbour in the next slot
    (a deflated pivot), and the first k rows have masked slots.  No window's
    point repeats a neighbour: that sets F at its floor, where roundoff decides
    the pullback (u₀ = F^(−1/2) amplifies it by about 1/√(8 eps))."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D))
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
    idx[rep, 1] = idx[rep, 0]
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    return np.ascontiguousarray(xw), (idx >= 0).astype(np.float64)


@pytest.mark.parametrize("layout", ["nd", "t", "bc"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_vecchia_band_bwd_matches_plain(cls, dtype, layout, cuda):
    """The pullback kernel against its plain version (the recompute pullback)
    on the card: x̄w and each window's share of the nugget's cotangent, both
    layouts (x̄w comes back in the layout of the windows) and a broadcast
    mask on the windows past the first k, no nugget and a nugget with and
    without slot k, k on both sides of each width's edge, N ragged; relative
    to the largest entry (the nugget's total relative to the sum of the
    shares' magnitudes, since with random cotangents the shares cancel):
    f64 1e-10, f32 1e-4 (both solve with the window Grams twice, in other
    orders); two calls give the same bits."""
    from approximategps_tpu_torch.ops import batched_chol

    kmap = cls().kernel_map()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for D, k, N in VECCHIA_CASES:
        xw, valid = _bwd_windows(N, D, k, seed=D)
        a, v = _t(xw, cuda, dtype), _t(valid, cuda, dtype)
        if layout == "t":
            a = a.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        g = _t(np.random.default_rng(k).standard_normal((N, k + 1)), cuda, dtype)
        if layout == "bc":
            a, v, g = a[k:], v.new_ones(()).expand(N - k, k), g[k:]
        for nugget, self_ in ((None, True), (0.1, False), (0.1, True)):
            nug = None if nugget is None else torch.tensor([nugget], dtype=dtype, device=cuda)
            before = batched_chol.vecchia_band_bwd.launches
            got_x, got_n = batched_chol.vecchia_band_bwd(a, v, kmap, g, nug, self_)
            again_x, got_p = batched_chol.vecchia_band_bwd(a, v, kmap, g, nug, self_,
                                                           per_window=True)
            assert batched_chol.vecchia_band_bwd.launches == before + 2
            assert torch.equal(got_x, again_x)
            ref_x, ref_p = batched_chol._recompute_pullback(a, v, kmap, nug, self_, g, True,
                                                            nug is not None)
            assert got_x.stride() == a.stride()
            assert ((got_x - ref_x).abs().max() / ref_x.abs().max()).item() <= tol, (D, k, nugget)
            assert bool((got_x[:, :, :k].permute(0, 2, 1)[v == 0] == 0).all())
            if nug is not None:
                assert got_n.shape == (1,) and got_n.device == a.device
                assert torch.equal(got_n, got_p.sum().reshape(1))
                assert ((got_p - ref_p).abs().max() / ref_p.abs().max()).item() <= tol, (D, k)
                assert abs((got_n - ref_p.sum()).item()) <= tol * ref_p.abs().sum().item()


def test_torch_cuda_vecchia_band_bwd_raises_on_what_it_does_not_take(cuda):
    from approximategps_tpu_torch.ops import batched_chol

    kmap = tk.SqExponentialKernel().kernel_map()
    xw = torch.zeros((10, 2, 5), device=cuda)
    v = torch.ones((10, 4), device=cuda)
    g = torch.zeros((10, 5), device=cuda)
    for args in [
        (xw.bfloat16(), v.bfloat16(), kmap, g.bfloat16()),
        (torch.zeros((10, 9, 5), device=cuda), v, kmap, g),
        (torch.zeros((10, 2, 66), device=cuda), torch.ones((10, 65), device=cuda), kmap,
         torch.zeros((10, 66), device=cuda)),
        (xw, v, kmap, g.cpu()),
        (xw, v, kmap, g.double()),
        (xw, v, kmap, torch.zeros((10, 4), device=cuda)),
    ]:
        with pytest.raises(ValueError):
            batched_chol.vecchia_band_bwd(*args)
    with pytest.raises(ValueError):
        batched_chol.vecchia_band_bwd_pass(xw, v, kmap, torch.ones(2, device=cuda), True, g)


@pytest.mark.parametrize("ordering", ["natural", "maximin"])
def test_torch_cuda_vecchia_training_step_launches_both_kernels(ordering, cuda):
    """One ``approx_lml`` value and θ-gradient of σ²·Matérn-3/2 + τ²·White
    (f64, N = 3000): the band kernel and its pullback launch once each, and
    the value and all three gradient entries agree with the plain route
    (1e-12 and 1e-10 relative)."""
    from approximategps_tpu_torch import convert
    from approximategps_tpu_torch.ops import batched_chol

    rng = np.random.default_rng(13)
    x = _t(np.sort(rng.uniform(0.0, 2400.0, 3000)) if ordering == "natural"
           else rng.uniform(0.0, 50.0, (3000, 2)), cuda)
    y = torch.sin(x if x.ndim == 1 else x[:, 0])
    nn = tgp.NearestNeighbors(16, ordering=ordering,
                              neighbors="previous" if ordering == "natural" else "scaled")

    def value_and_grad():
        theta = _t([0.55, 0.55, 0.02], cuda).requires_grad_()
        v = tgp.approx_lml(nn, convert.build_vecchia_nugget_fx(theta, x), y)
        return v.detach(), torch.autograd.grad(v, theta)[0]

    c0, c1 = batched_chol.vecchia_band.launches, batched_chol.vecchia_band_bwd.launches
    v, g = value_and_grad()
    assert batched_chol.vecchia_band.launches == c0 + 1
    assert batched_chol.vecchia_band_bwd.launches == c1 + 1
    with tgp.config_context(use_kernels=False):
        v0, g0 = value_and_grad()
    assert batched_chol.vecchia_band.launches == c0 + 1
    assert abs((v - v0).item()) <= 1e-12 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-10


# -- row 6: band rows from prebuilt Grams --------------------------------------


def _prebuilt_grams(N, D, k, dev, dtype, seed):
    """Masked (Kw, kni, kdiag) under Matérn-3/2, and the mask, of previous-k
    windows of points about a lengthscale apart (sorted in 1-D, as the
    bench's): the first k rows have masked slots,
    every third window repeats a neighbour in the next slot (a deflated
    pivot), and in f64 every tenth point repeats the one before it (its F at
    the floor, where f32 roundoff would decide the answer)."""
    from approximategps_tpu_torch.ops import batched_chol

    rng = np.random.default_rng(seed)
    X = (np.cumsum(rng.uniform(0.5, 1.5, (N, 1)), axis=0) if D == 1
         else rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D)))
    if dtype == torch.float64:
        X[1::10] = X[0::10][: X[1::10].shape[0]]
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    if k >= 2:
        rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
        idx[rep, 1] = idx[rep, 0]
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    valid = _t((idx >= 0).astype(np.float64), dev, dtype)
    return (*batched_chol.window_gram_inputs(_t(np.ascontiguousarray(xw), dev, dtype), valid,
                                             tk.Matern32Kernel().kernel_map()), valid)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_cuda_band_rows_match_plain(dtype, cuda):
    """Row 6 against the plain masked math on the same Grams, k from 1 to
    the limit of 64 (33: the first of the two-rows-a-lane width), B ragged
    against the kernel's blocks, a strided Kw (a
    transposed view: the kernel reads Kw's lower triangle through its
    strides); relative to the largest entry: f64 1e-12, f32 1e-4 (each pivot
    rounds in another order, amplified by the windows' conditioning);
    masked slots exactly 0."""
    from approximategps_tpu_torch.ops import batched_chol

    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for D, k, N in ((1, 1, 99), (1, 7, 1001), (2, 32, 777), (2, 33, 555), (8, 64, 301)):
        Kw, kni, kdiag, valid = _prebuilt_grams(N, D, k, cuda, dtype, seed=k)
        ref = batched_chol.masked_chol_solve_band_math(Kw, kni, kdiag)
        for A in (Kw, Kw.transpose(1, 2).contiguous().transpose(1, 2)):
            before = batched_chol.batched_chol_solve_band.launches
            got = batched_chol.batched_chol_solve_band(A, kni, kdiag)
            assert batched_chol.batched_chol_solve_band.launches == before + 1
            assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol, (D, k)
            assert bool((got[:, :k][valid == 0] == 0).all())


@pytest.mark.parametrize("dtype,k", [(torch.float32, 32), (torch.float64, 64), (torch.float32, 8)])
def test_torch_cuda_band_rows_vector_and_entrywise_loads_agree(dtype, k, cuda):
    """A contiguous, aligned Kw takes the 16-byte vector loads, the same
    values one element off alignment the entry-by-entry loads: the rows
    agree bitwise, and the deflated pivots in f64 stay dead (masked slots
    exactly 0)."""
    from approximategps_tpu_torch.ops import batched_chol

    Kw, kni, kdiag, valid = _prebuilt_grams(203, 2, k, cuda, dtype, seed=40 + k)
    store = torch.empty(Kw.numel() + 1, dtype=dtype, device=cuda)
    off = store[1:].view(Kw.shape)
    off.copy_(Kw)
    assert off.data_ptr() % 16 != 0 and Kw.data_ptr() % 16 == 0
    before = batched_chol.batched_chol_solve_band.launches
    a = batched_chol.batched_chol_solve_band_pass(Kw, kni, kdiag)
    b = batched_chol.batched_chol_solve_band_pass(off, kni, kdiag)
    assert batched_chol.batched_chol_solve_band.launches == before + 2
    assert torch.equal(a, b)
    assert bool((a[:, :k][valid == 0] == 0).all())


def test_torch_cuda_band_rows_raise_on_what_they_do_not_take(cuda):
    from approximategps_tpu_torch.ops import batched_chol

    Kw = torch.eye(4, device=cuda).expand(10, 4, 4)
    c, d = torch.zeros((10, 4), device=cuda), torch.ones(10, device=cuda)
    for args in [
        (Kw.double(), c, d),
        (Kw, c.cpu(), d),
        (torch.eye(65, device=cuda).expand(10, 65, 65), torch.zeros((10, 65), device=cuda), d),
        (Kw, torch.zeros((10, 3), device=cuda), d),
        (Kw, c, torch.ones(9, device=cuda)),
        (Kw.bfloat16(), c.bfloat16(), d.bfloat16()),
    ]:
        with pytest.raises(ValueError):
            batched_chol.batched_chol_solve_band_pass(*args)


def test_torch_cuda_rq_training_step_reaches_row_6(cuda):
    """An RQ + white ``approx_lml`` value and θ-gradient on a CUDA tensor (f64,
    N = 3000, blocks of 1024): row 6 launches once a block, the fused band
    kernel never, and the value and gradient agree with the plain masked
    math (1e-12 and 1e-10 relative)."""
    from approximategps_tpu_torch import convert
    from approximategps_tpu_torch.ops import batched_chol

    x = _t(np.sort(np.random.default_rng(14).uniform(0.0, 2400.0, 3000)), cuda)
    y = torch.sin(x / 3.0)
    nn = tgp.NearestNeighbors(16, block_size=1024)

    def value_and_grad():
        theta = _t([0.55, 0.55, 0.5, 0.02], cuda).requires_grad_()
        v = tgp.approx_lml(nn, convert.build_vecchia_rq_fx(theta, x), y)
        return v.detach(), torch.autograd.grad(v, theta)[0]

    c0, c1 = batched_chol.batched_chol_solve_band.launches, batched_chol.vecchia_band.launches
    v, g = value_and_grad()
    assert batched_chol.batched_chol_solve_band.launches == c0 + 3
    assert batched_chol.vecchia_band.launches == c1
    with tgp.config_context(use_kernels=False):
        v0, g0 = value_and_grad()
    assert batched_chol.batched_chol_solve_band.launches == c0 + 3
    assert abs((v - v0).item()) <= 1e-12 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-10


# -- row 11: the fused stationary Gram ------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cls", MAPS, ids=MAP_IDS)
def test_torch_cuda_stationary_gram_matches_plain(cls, dtype, cuda):
    """Row 11 against its plain version: N and M ragged against the 64 × 64
    tiles, D = 1, 3 and 11 (two coordinate chunks, the last ragged), pairs at
    r = 0, a strided X (a transposed view), a batch under ``vmap``;
    relative to the largest entry: f64 1e-12, f32 1e-5 (r² summed in
    another order, by FMAs)."""
    from approximategps_tpu_torch.ops import gram

    kmap = cls().kernel_map()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(15)
    for N, M, D in ((1000, 777, 1), (129, 4099, 3), (65, 63, 11)):
        X = _t(rng.standard_normal((N, D)), cuda, dtype)
        Z = _t(rng.standard_normal((M, D)), cuda, dtype)
        Z[:10] = X[:10]
        ref = gram.stationary_gram_plain(X, Z, kmap)
        for A in (X, X.T.contiguous().T):
            before = gram.stationary_gram.launches
            got = gram.stationary_gram(A, Z, kmap)
            assert gram.stationary_gram.launches == before + 1
            assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol, (N, M, D)
    Xb = _t(rng.standard_normal((300, 5, 2)), cuda, dtype)
    xi = _t(rng.standard_normal((300, 2)), cuda, dtype)
    before = gram.stationary_gram.launches
    got = torch.func.vmap(lambda w, x: gram.stationary_gram(w, x[None], kmap)[:, 0])(Xb, xi)
    assert gram.stationary_gram.launches == before + 1
    ref = gram.stationary_gram_plain(Xb, xi[:, None, :], kmap)[..., 0]
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol


def test_torch_cuda_minibatch_step_under_fused_gram_reaches_row_11(cuda):
    """The minibatch ``elbo`` gradient (f64, M = 256, B = 1024) under
    ``gram_mode="fused"`` launches row 11 once for Kuf and agrees with the
    default mode (1e-10 relative)."""
    from approximategps_tpu_torch.ops import gram

    rng = np.random.default_rng(16)
    z, xb = _t(rng.standard_normal((256, 4)), cuda), _t(rng.standard_normal((1024, 4)), cuda)
    yb = torch.sin(xb[:, 0])

    def value_and_grad():
        theta = _t([0.4, -0.2], cuda).requires_grad_()
        zz = z.clone().requires_grad_()
        kern = tgp.utils.bijectors.softplus(theta[0]) * tgp.with_lengthscale(
            tgp.SqExponentialKernel(), tgp.utils.bijectors.softplus(theta[1]))
        f = tgp.GP(kern)
        q = tgp.MultivariateNormal(torch.zeros(256, dtype=torch.float64, device=cuda),
                                   0.5 * torch.eye(256, dtype=torch.float64, device=cuda))
        sva = tgp.SparseVariationalApproximation(f(zz, 1e-6), q)
        v = -tgp.elbo(sva, f(xb, 0.1), yb, num_data=10000)
        return v.detach(), torch.cat([g.reshape(-1) for g in torch.autograd.grad(v, (theta, zz))])

    before = gram.stationary_gram.launches
    with tgp.config_context(gram_mode="fused"):
        v, g = value_and_grad()
    assert gram.stationary_gram.launches == before + 1
    v0, g0 = value_and_grad()
    assert gram.stationary_gram.launches == before + 1
    assert abs((v - v0).item()) <= 1e-10 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-10


@pytest.mark.parametrize("dtype,M", [(torch.float32, 8189), (torch.float32, 8190),
                                     (torch.float32, 8191), (torch.float32, 8192),
                                     (torch.float64, 4097), (torch.float64, 4096)],
                         ids=["f32-8189", "f32-8190", "f32-8191", "f32-8192", "f64-4097",
                              "f64-4096"])
def test_torch_cuda_stationary_gram_ragged_rows(dtype, M, cuda):
    """Row 11's 16-byte stores: M not a multiple of the vector (4 floats or
    2 doubles) leaves rows that start off a 16-byte boundary and a run
    that crosses column M, both written by scalar stores; N ragged against
    the 64-row tiles, D = 8; a strided X (a transposed view), and a batch
    of two with Z expanded (stride 0) and X's batch strided, against the
    plain version (f64 1e-12, f32 1e-5 relative to the largest entry)."""
    from approximategps_tpu_torch.ops import gram

    kmap = tk.Matern52Kernel().kernel_map()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(M)
    X = _t(rng.standard_normal((130, 8)), cuda, dtype)
    Z = _t(rng.standard_normal((M, 8)), cuda, dtype)
    Z[:5] = X[:5]
    for A in (X, X.T.contiguous().T):
        before = gram.stationary_gram.launches
        got = gram.stationary_gram(A, Z, kmap)
        assert gram.stationary_gram.launches == before + 1
        ref = gram.stationary_gram_plain(X, Z, kmap)
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol
    Xb = _t(rng.standard_normal((2, 8, 130)), cuda, dtype).mT  # (2, 130, 8), strided
    Zb = Z[None].expand(2, M, 8)
    got = gram.stationary_gram(Xb, Zb, kmap)
    ref = gram.stationary_gram_plain(Xb, Zb, kmap)
    assert got.shape == (2, 130, M)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_cuda_stationary_gram_small_grams_batch(dtype, cuda):
    """A batch of 8192 Grams of 33 × 33 at D = 2 (the Vecchia windows'
    shape: rows of 33 values, so most start off a 16-byte boundary), under
    ``vmap`` (one launch) and called batched, against the plain version."""
    from approximategps_tpu_torch.ops import gram

    kmap = tk.SqExponentialKernel().kernel_map()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    W = _t(np.random.default_rng(17).standard_normal((8192, 33, 2)), cuda, dtype)
    ref = gram.stationary_gram_plain(W, W, kmap)
    before = gram.stationary_gram.launches
    got = torch.func.vmap(lambda w: gram.stationary_gram(w, w, kmap))(W)
    assert gram.stationary_gram.launches == before + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol
    got = gram.stationary_gram(W, W, kmap)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1), torch.ones_like(got[..., 0]))


# -- the natural-gradient step, the Poisson step, block-Vecchia (f64 on the card) ------------


def _nat_elbo(num_data=None):
    from approximategps_tpu_torch import convert

    return lambda h, m, L, xb, yb: convert.natgrad_elbo(h, m, L, xb, yb, num_data=num_data)


def test_torch_cuda_natgrad_step_conjugate_exact_reaches_rows_1_and_4(cuda):
    """One hybrid step with nat_lr = 1 from an arbitrary q (N = 512, M = 64,
    D = 8, ``solve_mode="inv_matmul"`` so that the posterior build takes
    row 1): row 1 once, row 4 twice, and the elbo at the new q equals
    ``vfe_elbo`` of the old hyperparameters to 1e-8."""
    from approximategps_tpu_torch.utils.bijectors import softplus

    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((512, 8)), cuda)
    y = torch.sin(x[:, 0]) + 0.1 * _t(rng.standard_normal(512), cuda)
    hyper = {"k": _t([0.5, 0.5], cuda), "z": x[:64].clone()}
    h0 = {k: v.clone() for k, v in hyper.items()}
    m0, L0 = torch.full((64,), 0.3, dtype=torch.float64, device=cuda), 1.4 * torch.eye(
        64, dtype=torch.float64, device=cuda)
    with tgp.config_context(solve_mode="inv_matmul"):
        step, init = tgp.make_natgrad_adam_step(_nat_elbo(), nat_lr=1.0)
        b1, b4 = panel_chol.gram_chol_inv.launches, panel_chol.chol_inv.launches
        (_, _, m1, L1, Li1), _ = step(init(hyper, m0, L0), x, y)
        assert panel_chol.gram_chol_inv.launches == b1 + 1
        assert panel_chol.chol_inv.launches == b4 + 2
        with torch.no_grad():
            e1 = _nat_elbo()(h0, m1, L1, x, y)
    f0 = tgp.GP(softplus(h0["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                             softplus(h0["k"][1])))
    bound = tgp.vfe_elbo(tgp.VFE(f0(h0["z"], 1e-6)), f0(x, 0.1), y)
    assert abs(e1.item() - bound.item()) <= 1e-8 * abs(bound.item())
    torch.testing.assert_close(Li1 @ L1, torch.eye(64, dtype=torch.float64, device=cuda),
                               atol=1e-8, rtol=0)


def test_torch_cuda_poisson_step_matches_plain(cuda):
    """The Poisson SVGP loss (``bench.py::poisson_svgp`` at M = 64, B = 512)
    and its gradients in f64: row 1 once, against the plain path to 1e-9
    relative to each gradient's largest entry."""
    from approximategps_tpu_torch import convert

    rng = np.random.default_rng(6)
    xh = np.sort(rng.uniform(size=512)) * 100.0
    x, y = _t(xh[:, None], cuda), torch.tensor(rng.poisson(np.exp(np.sin(xh))), device=cuda)
    base = {"k": [0.5, 0.5], "z": np.linspace(0, 100, 64)[:, None],
            "m": 0.3 * rng.standard_normal(64), "A": 0.6 * np.eye(64)}

    def run():
        p = {k: _t(v, cuda).requires_grad_() for k, v in base.items()}
        loss = convert.poisson_svgp_loss(p, x, y, num_data=100_000)
        return loss, torch.autograd.grad(loss, list(p.values()))

    with tgp.config_context(solve_mode="inv_matmul"):
        before = panel_chol.gram_chol_inv.launches
        v, g = run()
        assert panel_chol.gram_chol_inv.launches == before + 1
        with tgp.config_context(use_kernels=False):
            vp, gp = run()
    assert abs(v.item() - vp.item()) <= 1e-9 * abs(vp.item())
    for a, b in zip(g, gp):
        assert (a - b).abs().max().item() <= 1e-9 * max(b.abs().max().item(), 1e-30)


def test_torch_cuda_likelihoods_match_cpu(cuda):
    """Every likelihood's log_prob_d1_d2 and Gauss–Hermite expectation on
    the card against the same code on the CPU, f64, 1e-12."""
    rng = np.random.default_rng(8)
    f, v = rng.standard_normal(1000), rng.uniform(0.05, 0.5, 1000)
    counts, pos = rng.poisson(2.0, 1000), rng.gamma(2.0, 1.0, 1000)
    for lik, y in ((tgp.BernoulliLikelihood(), rng.integers(0, 2, 1000)),
                   (tgp.BernoulliLikelihood(link="probit"), rng.integers(0, 2, 1000)),
                   (tgp.PoissonLikelihood(), counts), (tgp.PoissonLikelihood(link="softplus"), counts),
                   (tgp.ExponentialLikelihood(), pos), (tgp.GammaLikelihood(2.5), pos),
                   (tgp.NegativeBinomialLikelihood(2.5), counts),
                   (tgp.StudentTLikelihood(5.0, 0.7), f),
                   (tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(5.0, 0.7)), f)):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            ft, vt, yt = _t(f, dev), _t(v, dev), _t(y, dev)
            outs.append([*lik.log_prob_d1_d2(ft, yt),
                         tgp.GaussHermite(20).expected_loglik(lik, ft, vt, yt)])
        for a, b in zip(*outs):
            torch.testing.assert_close(a.cpu(), b, atol=1e-12, rtol=1e-12)


def test_torch_cuda_block_vecchia_checks(cuda):
    """Block-Vecchia in f64 on the card: b = 1 equals scalar Vecchia
    (N = 512, k = 6, 1e-9), full conditioning equals the exact GP (N = 128,
    lml 1e-7, posterior 1e-6), and maximin with nearest neighbours equals
    the CPU run of the same code (N = 1024 in 2-D, 1e-10)."""
    f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.Matern32Kernel(), 1.1))
    x = torch.linspace(0.0, 512.0, 512, dtype=torch.float64, device=cuda)[:, None]
    y = torch.sin(x[:, 0] / 3.0)
    scalar = tgp.approx_lml(tgp.NearestNeighbors(k=6), f(x, 0.0), y)
    block = tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=1, k=6), f(x, 0.0), y)
    assert abs(block.item() - scalar.item()) <= 1e-9 * abs(scalar.item())

    xe, ye = x[:128], y[:128]
    nn = tgp.BlockNearestNeighbors(block_size=16, k=128)
    lml = tgp.approx_lml(nn, f(xe, 0.0), ye)
    exact = f(xe, 0.0).logpdf(ye)
    assert abs(lml.item() - exact.item()) <= 1e-7 * abs(exact.item())
    post, gpr = tgp.posterior(nn, f(xe, 0.0), ye), tgp.posterior(f(xe, 1e-12), ye)
    xt = torch.linspace(-2.0, 130.0, 17, dtype=torch.float64, device=cuda)[:, None]
    torch.testing.assert_close(post.mean(xt), gpr.mean(xt), atol=1e-6, rtol=0)
    torch.testing.assert_close(post.var(xt), gpr.var(xt), atol=1e-6, rtol=0)

    rng = np.random.default_rng(9)
    xn = 32.0 * rng.uniform(size=(1024, 2))
    yn = np.sin(xn[:, 0] / 3.0) + np.cos(xn[:, 1] / 5.0)
    near = tgp.BlockNearestNeighbors(block_size=16, k=32, ordering="maximin", neighbors="nearest")
    got = tgp.approx_lml(near, f(_t(xn, cuda), 0.0), _t(yn, cuda))
    ref = tgp.approx_lml(near, f(_t(xn, "cpu"), 0.0), _t(yn, "cpu"))
    assert abs(got.item() - ref.item()) <= 1e-10 * abs(ref.item())


# -- the Laplace approximation ----------------------------------------------


def _laplace_value_and_grad(dev, N, D, storage=None, **kw):
    """−lml and its raw-θ gradient on ``dev`` in f64: dense Laplace
    (``storage`` None) or ``laplace_lml_cg`` on the given storage route."""
    from approximategps_tpu_torch import convert
    from approximategps_tpu_torch.models import laplace_cg

    x, y = convert.laplace_data(N, D, seed=4, device=dev, dtype=torch.float64)
    theta = _t([0.9, 0.4], dev).requires_grad_()
    if storage is None:
        v = convert.laplace_neg_lml(theta, x, y, maxiter=50)
    else:
        kern = convert.laplace_kernel(theta)
        v = -laplace_cg.laplace_lml_cg(tgp.BernoulliLikelihood(), y, kern, x, storage=storage,
                                       **kw)
    return v.detach().cpu(), torch.autograd.grad(v, theta)[0].cpu()


def test_torch_cuda_laplace_dense_matches_cpu(cuda):
    """Dense Laplace's −lml and θ-gradient (``laplace_n5k``'s model, N =
    1000) on the card against the CPU, f64, 1e-9."""
    v, g = _laplace_value_and_grad(cuda, 1000, 1)
    v0, g0 = _laplace_value_and_grad(torch.device("cpu"), 1000, 1)
    assert abs(v.item() - v0.item()) <= 1e-9 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-9


def test_torch_cuda_laplace_cg_runs_through_the_kernel(cuda):
    """``laplace_lml_cg`` on the chunked route (N = 2000, D = 2, f64): every
    product on row 5 (launches = counted matvecs + pullback passes; the Newton
    IFT's pullback is the lengthscale's r²·g′ pass at R = 1 alone, since
    neither the points nor ∇ll at the held f̂ carry a gradient, and the
    probes' at R = 16 a general pullback with that pass), value 1e-8 and
    gradient 1e-7 from the CPU's plain route with the same probes; the
    resident route (``storage="dense"``) launches nothing, and ``"auto"``
    takes row 5 on the card, the launches by pass summing to the count."""
    from approximategps_tpu_torch.models import iterative
    from approximategps_tpu_torch.ops import gram_matvec

    probes = np.sign(np.random.default_rng(3).standard_normal((16, 2000)))
    kw = dict(lanczos_iters=30, cg_tol=1e-10, maxiter=60, tol=1e-10, precond_rank=64,
              block_size=512)
    iterative.reset_stats()
    before, passes = gram_matvec.gram_matvec.launches, gram_matvec.pullback_passes["passes"]
    calls = gram_matvec.pullback_passes["calls"]
    v, g = _laplace_value_and_grad(cuda, 2000, 2, "chunked", probes=_t(probes, cuda), **kw)
    assert iterative.stats["matvec_plain"] == 0 and iterative.stats["matvec_fused"] > 0
    # one general pullback (f64 takes it for the self-Gram too), the probes' at R = 16
    assert gram_matvec.pullback_passes["calls"] - calls == 1
    assert gram_matvec.gram_matvec.launches - before == \
        iterative.stats["matvec_fused"] + gram_matvec.pullback_passes["passes"] - passes
    v0, g0 = _laplace_value_and_grad(torch.device("cpu"), 2000, 2, "chunked",
                                     probes=_t(probes, "cpu"), **kw)
    assert abs(v.item() - v0.item()) <= 1e-8 * abs(v0.item())
    assert ((g - g0).abs().max() / g0.abs().max()).item() <= 1e-7
    before = gram_matvec.gram_matvec.launches
    _laplace_value_and_grad(cuda, 2000, 2, "dense", probes=_t(probes, cuda), **kw)
    assert gram_matvec.gram_matvec.launches == before
    by_pass = dict(gram_matvec.launches_by_pass)
    va, ga = _laplace_value_and_grad(cuda, 2000, 2, "auto", probes=_t(probes, cuda), **kw)
    added = {k: n - by_pass.get(k, 0) for k, n in gram_matvec.launches_by_pass.items()}
    assert gram_matvec.gram_matvec.launches - before == sum(added.values()) > 0
    # f64 passes are all the narrow (SIMT) kernel, the probes' at R = 16 too
    assert added.get(("narrow", 1), 0) > 0 and added.get(("narrow", 16), 0) > 0
    assert abs(va.item() - v.item()) <= 1e-12 * abs(v.item())
    assert ((ga - g).abs().max() / g.abs().max()).item() <= 1e-12


def test_torch_cuda_probes_and_samples_are_made_on_the_card(cuda):
    """An int seed makes the Rademacher probes and the samplers' normals
    with a generator on the card (no host copy): the draws equal a CUDA
    generator's; the msqrt prior samples run as one (N, S) block on row 5."""
    from approximategps_tpu_torch.models import iterative
    from approximategps_tpu_torch.ops import gram_matvec

    p = iterative.rademacher_probes(7, 16, 1000, torch.float32, cuda)
    bits = torch.randint(0, 2, (16, 1000), generator=torch.Generator(device=cuda).manual_seed(7),
                         device=cuda)
    assert p.is_cuda and torch.equal(p, (2 * bits - 1).float())
    x = torch.linspace(0.0, 10.0, 3000, device=cuda)[:, None]
    kern = 1.5 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.2)
    before = gram_matvec.gram_matvec.launches
    s = tgp.sample_prior_msqrt(3, kern, x, 1e-3, 16, lanczos_iters=20)
    assert s.is_cuda and s.shape == (16, 3000) and bool(torch.isfinite(s).all())
    assert gram_matvec.gram_matvec.launches == before + 20


# -- pathwise sampling, the multi-latent and online SVGPs, LOO: rows 1, 5 and 11 on their
# new paths, the kernel route against the plain route at a small size ---------------------


def _rel_dev(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def _hetero_params(dev, dtype, M=512, D=2, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for tag, k in (("mean", [0.5, 0.5]), ("logvar", [0.3, 1.2])):
        out[tag] = {"k": _t(k, dev, dtype), "z": _t(rng.standard_normal((M, D)), dev, dtype),
                    "m": _t(0.3 * rng.standard_normal(M), dev, dtype),
                    "A": _t(0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M))), dev,
                            dtype)}
    return out


def _hetero_value_and_grad(params, x, y):
    leaves = [v.detach().clone().requires_grad_() for d in params.values() for v in d.values()]
    it = iter(leaves)
    p = {tag: {k: next(it) for k in d} for tag, d in params.items()}
    loss = tgp.convert.heteroscedastic_loss(p, x, y, num_data=10_000, n_gh=10)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_torch_cuda_multi_latent_step_reaches_row_1_twice(cuda):
    """The heteroscedastic two-latent ELBO (M = 512 a latent, f64): row 1
    once a latent, the value against the plain route to 1e-8 and the
    gradients to 1e-7 (each latent's Kuu, 512 points of N(0, 1) in 2-D at
    jitter 1e-6, has cond(Kuu) about 2e8, so two f64 factorizations differ
    by eps·cond ≈ 2.5e-8)."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((1024, 2)), cuda)
    y = torch.sin(x[:, 0]) + 0.2 * _t(rng.standard_normal(1024), cuda)
    params = _hetero_params(cuda, torch.float64)
    before = panel_chol.gram_chol_inv.launches
    v, g = _hetero_value_and_grad(params, x, y)
    assert panel_chol.gram_chol_inv.launches == before + 2
    with tgp.config_context(use_kernels=False):
        vp, gp = _hetero_value_and_grad(params, x, y)
    assert abs(v.item() - vp.item()) <= 1e-8 * abs(vp.item())
    for a, b in zip(g, gp):
        assert _rel_dev(a, b) <= 1e-7


def test_torch_cuda_online_elbo_reaches_row_1_once(cuda):
    """``online_elbo`` of a NonCentered approximation (M = 512, f64) after a
    first round: row 1 once, value and gradients against the plain route to
    1e-8."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2048, 2)), cuda)
    y = torch.sin(x[:, 0]) + 0.1 * _t(rng.standard_normal(2048), cuda)
    f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9))
    fz_old = f(x[:256], 1e-6)
    state = tgp.OnlineSVGPState(fz_old, tgp.online_optimal_q(
        tgp.OnlineSVGPState(fz_old, fz_old.to_mvn()), fz_old, f(x[:1024], 0.1), y[:1024]))
    z = _t(rng.standard_normal((512, 2)), cuda)
    m0 = _t(0.2 * rng.standard_normal(512), cuda)
    L0 = _t(0.7 * np.eye(512) + 0.01 * np.tril(rng.standard_normal((512, 512))), cuda)

    def run():
        m, L, zz = (t.clone().requires_grad_() for t in (m0, L0, z))
        sva = tgp.SparseVariationalApproximation(f(zz, 1e-6), tgp.MultivariateNormal(m, L))
        v = tgp.online_elbo(sva, state, f(x[1024:], 0.1), y[1024:])
        return v.detach(), torch.autograd.grad(v, (m, L, zz))

    before = panel_chol.gram_chol_inv.launches
    v, g = run()
    assert panel_chol.gram_chol_inv.launches == before + 1
    with tgp.config_context(use_kernels=False):
        vp, gp = run()
    assert abs(v.item() - vp.item()) <= 1e-8 * abs(vp.item())
    for a, b in zip(g, gp):
        assert _rel_dev(a, b) <= 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_cuda_cg_sampler_reaches_row_5(dtype, cuda):
    """Matheron CG samples at N = 3000, 16 samples: the solve and the update
    on row 5 (f32: the wide pass at R = 16), against the plain route with
    the same draws, relative to the samples' scale (f64 1e-8 at CG tol
    1e-10; f32 1e-3 at tol 1e-6)."""
    from approximategps_tpu_torch.models import sampling
    from approximategps_tpu_torch.ops import gram_matvec

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = 10.0 * torch.rand((3000, 2), generator=gen, device=cuda, dtype=dtype)
    y = torch.sin(x[:, 0])
    fx = tgp.GP(1.5 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 1.2))(x, 0.01)
    draws = sampling.draw_cg(gen, fx, 16, 512)
    xq = 10.0 * torch.rand((256, 2), generator=gen, device=cuda, dtype=dtype)
    tol, lim = (1e-10, 1e-8) if dtype == torch.float64 else (1e-6, 1e-3)
    before = dict(gram_matvec.launches_by_pass)
    s = sampling.cg_pathwise(fx, y, *draws, tol=tol, precond_rank=64)(xq)
    grew = {k: n - before.get(k, 0) for k, n in gram_matvec.launches_by_pass.items()
            if n > before.get(k, 0)}
    kind = "wide" if dtype == torch.float32 else "narrow"
    assert grew.get((kind, 16), 0) >= 2, grew
    with tgp.config_context(use_kernels=False):
        sp = sampling.cg_pathwise(fx, y, *draws, tol=tol, precond_rank=64)(xq)
    assert s.shape == (16, 256) and _rel_dev(s, sp) <= lim


def test_torch_cuda_fused_svgp_sampler_reaches_row_11(cuda):
    """``sample_svgp_functions`` under ``gram_mode="fused"`` (M = 300,
    D = 3, f64): row 11 once an evaluation, the samples equal the default
    route's to 1e-10."""
    from approximategps_tpu_torch.ops import gram

    rng = np.random.default_rng(6)
    f = tgp.GP(0.8 * tgp.with_lengthscale(tgp.Matern32Kernel(), 1.1))
    q = tgp.MultivariateNormal(_t(0.2 * rng.standard_normal(300), cuda),
                               _t(0.7 * np.eye(300), cuda))
    post = tgp.posterior(tgp.SparseVariationalApproximation(
        f(_t(rng.standard_normal((300, 3)), cuda), 1e-6), q))
    xs = _t(rng.standard_normal((4000, 3)), cuda)
    fs = tgp.sample_svgp_functions(torch.Generator(device=cuda).manual_seed(0), post, 8, 256)
    ref = fs(xs)
    with tgp.config_context(gram_mode="fused"):
        before = gram.stationary_gram.launches
        got = fs(xs)
        assert gram.stationary_gram.launches == before + 1
    assert _rel_dev(got, ref) <= 1e-10


def test_torch_cuda_loo_and_site_stream_match_cpu(cuda):
    """No kernel: ``loo_logpdf`` (value and θ-gradient) and the fixed-site
    stream on the card against the same calls on the CPU, f64, 1e-10."""
    rng = np.random.default_rng(8)
    xn, yn = rng.uniform(0, 10, 300), rng.standard_normal(300)

    def loo(dev):
        ls = torch.tensor(0.7, dtype=torch.float64, device=dev, requires_grad=True)
        f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), ls))
        v = tgp.loo_logpdf(f(_t(xn, dev), 0.1), _t(yn, dev))
        return v.item(), torch.autograd.grad(v, ls)[0].item()

    def stream(dev):
        f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.7))
        st = tgp.site_state(f(_t(np.linspace(0, 10, 40), dev), 1e-8))
        for i in range(3):
            st = tgp.site_update(st, f(_t(xn[i * 100:(i + 1) * 100], dev), 0.1),
                                 _t(yn[i * 100:(i + 1) * 100], dev))
        return tgp.site_posterior_q(st).mean.cpu()

    (v, g), (vc, gc) = loo(cuda), loo("cpu")
    assert abs(v - vc) <= 1e-10 * abs(vc) and abs(g - gc) <= 1e-10 * abs(gc)
    assert _rel_dev(stream(cuda), stream("cpu")) <= 1e-10
