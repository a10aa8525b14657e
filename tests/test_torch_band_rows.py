"""Row 6, the band rows from prebuilt Grams (``ops/batched_chol.py``'s
``batched_chol_solve_band``), and the Vecchia paths that reach it, on the CPU
in f64 against the JAX package.

On CPU tensors :func:`batched_chol_solve_band` runs its autograd Function
with the plain inner pass (the masked math), so what is held here is the
kernel's contract, the Function's closed-form pullback and the routing:

- the Function against JAX ``batched_chol_solve_band`` (Pallas, interpret
  mode) and ``batched_chol_solve_band_unrolled``, values and the VJP
  against JAX ``_band_bwd``, on windows with masked slots and with
  deflated columns (repeated points);
- ``approx_root_prec_band``, ``approx_root_prec_sparse`` and ``approx_lml``
  (value and θ-gradient) with kernels that do not unwrap — rational
  quadratic + white, Matérn-3/2 × periodic + white — on the kernel route
  (``use_kernels=True``: row 6's Function, one call a block) and the plain
  route, against the JAX package with ``use_pallas=True`` (its windowed
  Pallas tier);
- ``predict_knn`` with noise that is not a scalar at k = 6 and at k = 49,
  the JAX package's row-6 branch (k > 48).

Tolerances, relative to each array's largest entry: values 1e-12 and
gradients 1e-10 (the two packages sum in other orders), but 1e-11 for row
6's values on 1-D windows, whose Grams reach condition numbers of 5e5 (the
JAX kernel multiplies by the rsqrt of each pivot where the port divides by
its sqrt, and the condition scales that rounding: 5.3e-12 measured).  Interpret-mode
calls stay at N ≤ 256 and k ≤ 8, but for the k = 49 case at 20 test
points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.models import vecchia as jv
from approximategps_tpu.ops import batched_chol as jb
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.models import vecchia as tv
from approximategps_tpu_torch.ops import batched_chol as tb

torch.set_num_threads(1)


def _rel(t, j) -> float:
    t, j = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (t, j))
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


@pytest.fixture
def spy(monkeypatch):
    """Counts row 6's inner passes (the kernel route's calls)."""
    calls = []
    real = tb.batched_chol_solve_band_pass
    monkeypatch.setattr(tb, "batched_chol_solve_band_pass",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def _grams(N, D, k, seed, duplicates):
    """Masked (Kw, kni, kdiag) of previous-k windows (numpy): the first k
    rows have masked slots (identity rows, zero coupling); with
    ``duplicates`` every fourth neighbour repeats the one before it, so
    pivots deflate (the conditioned point never repeats a neighbour)."""
    rng = np.random.default_rng(seed)
    X = 1.5 * rng.standard_normal((N, D))
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    valid = (idx >= 0).astype(np.float64)
    nb = X[np.clip(idx, 0, N - 1)]
    if duplicates:
        nb[:, 1::4] = nb[:, 0::4][:, : nb[:, 1::4].shape[1]]
    xw = np.concatenate([nb, X[:, None, :]], axis=1).swapaxes(1, 2)
    kmap = tk.Matern52Kernel().kernel_map()
    Kw, kni, kdiag = tb.window_gram_inputs(torch.tensor(np.ascontiguousarray(xw)),
                                           torch.tensor(valid), kmap)
    live = tb._masked_chol_factor(Kw)[1]
    assert bool((live == 0).any()) == duplicates  # deflated columns where points repeat
    return Kw.numpy(), kni.numpy(), kdiag.numpy()


@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "deflated"])
@pytest.mark.parametrize("D, k, N, tol", [(1, 8, 37, 1e-11), (3, 5, 64, 1e-12)])
def test_torch_band_rows_match_jax(D, k, N, tol, duplicates):
    Kw, kni, kdiag = _grams(N, D, k, seed=D + k, duplicates=duplicates)
    jargs = tuple(map(jnp.asarray, (Kw, kni, kdiag)))
    targs = tuple(map(torch.tensor, (Kw, kni, kdiag)))
    got = tb.batched_chol_solve_band(*targs)
    assert got.shape == (N, k + 1)
    assert _rel(got, jb.batched_chol_solve_band(*jargs)) <= tol
    assert _rel(got, jb.batched_chol_solve_band_unrolled(*jargs)) <= tol
    # on a CPU tensor the inner pass is the plain masked math itself
    assert torch.equal(tb.batched_chol_solve_band_pass(*targs),
                       tb.masked_chol_solve_band_math(*targs))
    masked = np.arange(k)[None, :] < k - np.arange(N)[:, None]  # slots before the first point
    assert bool((got[:, :k][torch.tensor(masked)] == 0).all())


@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "deflated"])
def test_torch_band_rows_vjp_matches_jax(duplicates):
    """The Function's pullback (``band_bwd``) against JAX ``_band_bwd`` and
    against ``jax.vjp`` of the Pallas kernel."""
    N, D, k = 40, 2, 6
    Kw, kni, kdiag = _grams(N, D, k, seed=3, duplicates=duplicates)
    G = np.random.default_rng(4).standard_normal((N, k + 1))
    targs = [torch.tensor(a, requires_grad=True) for a in (Kw, kni, kdiag)]
    got = torch.autograd.grad(tb.batched_chol_solve_band(*targs), targs, torch.tensor(G))
    jargs = tuple(map(jnp.asarray, (Kw, kni, kdiag)))
    want = jb._band_bwd(None, None, jargs, jnp.asarray(G))
    _, pullback = jax.vjp(jb.batched_chol_solve_band, *jargs)
    for g, w, v in zip(got, want, pullback(jnp.asarray(G))):
        assert _rel(g, w) <= 1e-10 and _rel(g, v) <= 1e-10


# -- the Vecchia paths with kernels that do not unwrap --------------------------

THETA = np.array([0.4, 0.3, np.log(np.expm1(2.0)), -2.5])  # raw σ², ℓ, α (or period), τ²


def _jax_rq(theta):
    s = jsoftplus
    return (s(theta[0]) * agp.with_lengthscale(agp.RationalQuadraticKernel(alpha=s(theta[2])),
                                               s(theta[1]))
            + s(theta[3]) * agp.WhiteKernel())


def _jax_qp(theta):
    s = jsoftplus
    return (s(theta[0]) * agp.with_lengthscale(agp.Matern32Kernel(), s(theta[1]))
            * agp.PeriodicKernel(period=s(theta[2])) + s(theta[3]) * agp.WhiteKernel())


def _torch_qp(theta):
    s = tgp.utils.bijectors.softplus
    return (s(theta[0]) * tgp.with_lengthscale(tk.Matern32Kernel(), s(theta[1]))
            * tk.PeriodicKernel(period=s(theta[2])) + s(theta[3]) * tk.WhiteKernel())


MODELS = {
    "rq_white": (_jax_rq, lambda th: convert.build_vecchia_rq_fx(th, torch.zeros(1)).f.kernel),
    "m32_x_periodic": (_jax_qp, _torch_qp),
}


def _series(N, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 0.8 * N, N))
    return x, np.sin(x / 2.0) + 0.1 * rng.standard_normal(N)


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("model", list(MODELS))
def test_torch_roots_of_kernels_that_do_not_unwrap_match_jax(model, use, spy):
    """The banded root (blocks of 16 points: one row-6 call a block on the
    kernel route) and the sparse root over random predecessor sets."""
    jkern, tkern = (f(t) for f, t in zip(MODELS[model], (jnp.asarray(THETA),
                                                          torch.tensor(THETA))))
    x, _ = _series(50, 1)
    k = 5
    ref = jv.approx_root_prec_band(jnp.asarray(x), k, jkern, use_pallas=True)
    got = tv.approx_root_prec_band(torch.tensor(x), k, tkern, block_size=16, use_kernels=use)
    assert _rel(got, ref) <= 1e-12
    assert len(spy) == (4 if use else 0)
    rng = np.random.default_rng(2)
    N = x.shape[0]
    offs = np.sort(rng.integers(1, 1 << 30, size=(N, k)) % np.maximum(np.arange(N)[:, None], 1),
                   axis=1)
    nbr = np.where(np.arange(N)[:, None] > np.arange(k)[None, :],
                   np.maximum(np.arange(N)[:, None] - 1 - offs, 0), -1)
    ref = jv.approx_root_prec_sparse(jnp.asarray(x), jnp.asarray(nbr), jkern, use_pallas=True)
    got = tv.approx_root_prec_sparse(torch.tensor(x), nbr, tkern, use_kernels=use)
    assert _rel(got.coeff, ref.coeff) <= 1e-12 and _rel(got.diag, ref.diag) <= 1e-12
    assert len(spy) == (5 if use else 0)


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("model", list(MODELS))
def test_torch_approx_lml_gradient_of_kernels_that_do_not_unwrap_matches_jax(model, use, spy):
    """``approx_lml`` and its gradient in all four raw hyperparameters (α or
    the period included) against ``jax.grad`` of the JAX package's windowed
    Pallas tier."""
    jmake, tmake = MODELS[model]
    x, y = _series(60, 3)
    nn_j = agp.NearestNeighbors(6, use_pallas=True)
    nn_t = tgp.NearestNeighbors(6, block_size=32, use_kernels=use)
    jval, jgrad = jax.value_and_grad(
        lambda th: agp.approx_lml(nn_j, agp.GP(jmake(th))(jnp.asarray(x), 0.0),
                                  jnp.asarray(y)))(jnp.asarray(THETA))
    th = torch.tensor(THETA, requires_grad=True)
    tval = tgp.approx_lml(nn_t, tgp.GP(tmake(th))(torch.tensor(x), 0.0), torch.tensor(y))
    (tgrad,) = torch.autograd.grad(tval, th)
    assert len(spy) == (2 if use else 0)
    assert abs(tval.item() - float(jval)) <= 1e-12 * abs(float(jval))
    assert _rel(tgrad, jgrad) <= 1e-10


def test_torch_build_vecchia_rq_fx_matches_jax():
    x, _ = _series(20, 4)
    th = torch.tensor(THETA)
    fx = convert.build_vecchia_rq_fx(th, torch.tensor(x))
    assert float(fx.noise) == 0.0
    assert _rel(fx.cov(), _jax_rq(jnp.asarray(THETA)).gram(jnp.asarray(x))) <= 1e-13
    assert tk.unwrap_stationary_nugget(fx.f.kernel) is None  # the windowed tier
    assert torch.equal(convert.from_jax_params(THETA, device="cpu", dtype=torch.float64), th)


def _hetero_case(N, Ns, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 6.0, (N, 2))
    Xs = rng.uniform(0.0, 6.0, (Ns, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(N)
    noise = 0.1 * (1.0 + rng.uniform(size=N))
    return X, Xs, y, noise


@pytest.mark.parametrize("use", [None, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("k, N, Ns, block", [(6, 120, 45, 16), (49, 80, 20, 8)])
def test_torch_predict_knn_with_noise_vector_matches_jax(k, N, Ns, block, use, spy):
    """Per-point noise (the JAX package's non-fused branch: the unrolled
    math at k = 6, its row-6 Pallas kernel at k = 49) with
    ``build_knn_hetero_fx``'s Matérn-3/2; on the kernel route one row-6
    call a block of test points."""
    X, Xs, y, noise = _hetero_case(N, Ns, seed=k)
    theta = np.array([0.2, 0.5])
    fx_t = convert.build_knn_hetero_fx(torch.tensor(theta), torch.tensor(X), torch.tensor(noise))
    kern_j = jsoftplus(theta[0]) * agp.with_lengthscale(agp.Matern32Kernel(),
                                                        jsoftplus(theta[1]))
    fx_j = agp.GP(kern_j)(jnp.asarray(X), jnp.asarray(noise))
    assert _rel(fx_t.cov(), fx_j.cov()) <= 1e-13
    jmu, jvar = agp.predict_knn(fx_j, jnp.asarray(y), jnp.asarray(Xs), k=k, test_block=block)
    tmu, tvar = tgp.predict_knn(fx_t, torch.tensor(y), torch.tensor(Xs), k=k, test_block=block,
                                use_kernels=use)
    assert len(spy) == (-(-Ns // block) if use else 0)
    assert _rel(tmu, jmu) <= 1e-12 and _rel(tvar, jvar) <= 1e-12
