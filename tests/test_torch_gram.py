"""The fused stationary Gram (``ops/gram.py``, row 11) and ``gram_mode="fused"``
on the CPU in f64 against the JAX package.

On CPU tensors :func:`stationary_gram` runs its autograd Function with the
plain forward (the map of exact broadcast distances); what is held here is
the kernel's contract, the Function's closed-form pullback and the
dispatch of ``StationaryKernel.gram``:

- ``stationary_gram`` against ``pallas_stationary_gram`` (interpret mode) at
  the shapes of the JAX package's own test, every map, values and VJP;
- its batched form and vmap rule, with which Grams built under
  ``torch.func.vmap`` launch one kernel;
- ``gram_mode="fused"`` sends non-symmetric Grams of a kernel with a CUDA
  map to the Function, keeps symmetric Grams on broadcast distances and
  sends the rational quadratic kernel to the matmul distances, as the JAX
  package's ``"pallas"`` mode does;
- the minibatch ``elbo`` and its gradients under ``gram_mode="fused"``
  against the JAX package under ``gram_mode="pallas"``, M = 16, B = 64.

Tolerances, relative to each array's largest entry: Grams 1e-12 (the JAX
kernel takes r² by the centred |x|² identity, the port by exact
differences); the VJP 1e-10 (inputs with no coincident pairs: at r = 0 the
JAX pullback's identity r² is not exactly 0); the ELBO and its gradients
1e-8, as the training tests hold the default mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.config import config_context as jax_config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.ops.gram import pallas_stationary_gram
from approximategps_tpu.utils.bijectors import softplus as jsoftplus
import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import gram as tg
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

MAPS = {
    "se": (jk.SqExponentialKernel, tk.SqExponentialKernel),
    "m12": (jk.Matern12Kernel, tk.Matern12Kernel),
    "m32": (jk.Matern32Kernel, tk.Matern32Kernel),
    "m52": (jk.Matern52Kernel, tk.Matern52Kernel),
}
SHAPES = [(16, 16, 2), (100, 60, 3), (7, 200, 1)]  # JAX tests/test_utils_and_ops.py


def _rel(t, j) -> float:
    t, j = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (t, j))
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-300))


def _inputs(N, M, D, seed, coincident=True):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D))
    Z = rng.standard_normal((M, D))
    if coincident:
        n = min(N, M) // 3
        Z[:n] = X[:n]  # pairs at r = 0
    return X, Z


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_stationary_gram_matches_pallas_interpret(name, shape):
    jcls, tcls = MAPS[name]
    X, Z = _inputs(*shape, seed=1)
    want = pallas_stationary_gram(jnp.asarray(X), jnp.asarray(Z), jcls.k_of_r2)
    got = tg.stationary_gram(torch.tensor(X), torch.tensor(Z), tcls().kernel_map())
    assert got.shape == shape[:2] and got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_stationary_gram_vjp_matches_jax(name):
    """X̄ and Z̄ of ⟨W, K⟩ against the JAX custom VJP (``_bwd``)."""
    jcls, tcls = MAPS[name]
    X, Z = _inputs(12, 9, 2, seed=2, coincident=False)
    W = np.random.default_rng(3).standard_normal((12, 9))
    _, pullback = jax.vjp(lambda a, b: pallas_stationary_gram(a, b, jcls.k_of_r2),
                          jnp.asarray(X), jnp.asarray(Z))
    want = pullback(jnp.asarray(W))
    Xt = torch.tensor(X, requires_grad=True)
    Zt = torch.tensor(Z, requires_grad=True)
    got = torch.autograd.grad(tg.stationary_gram(Xt, Zt, tcls().kernel_map()), (Xt, Zt),
                              torch.tensor(W))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


def test_torch_stationary_gram_se_pullback_reads_g_prime_off_k():
    """For the SE map the pullback takes g′ = −½·K from the forward's output
    (no r² recompute); it agrees with the recomputing pullback, and the
    Matérn maps, which have no such shortcut, ignore a given K."""
    X, Z = (torch.tensor(a) for a in _inputs(30, 17, 3, seed=6))
    W = torch.tensor(np.random.default_rng(7).standard_normal((30, 17)))
    for cls in (tk.SqExponentialKernel, tk.Matern32Kernel):
        kmap = cls().kernel_map()
        K = tg.stationary_gram_plain(X, Z, kmap)
        with_k = tg.stationary_gram_bwd(X, Z, kmap, W, K=K)
        without = tg.stationary_gram_bwd(X, Z, kmap, W)
        for a, b in zip(with_k, without):
            assert _rel(a, b) <= 1e-14
    assert tk.dk_from_k_for(tk.SqExponentialKernel().kernel_map()) is not None
    assert tk.dk_from_k_for(tk.Matern32Kernel().kernel_map()) is None


def test_torch_stationary_gram_batched_and_under_vmap():
    """Leading batch dimensions, an unbatched Z broadcast against them, and
    the vmap rule (the window Grams of the Vecchia tier), each against the
    Grams one by one, with their gradients."""
    kmap = tk.Matern32Kernel().kernel_map()
    rng = np.random.default_rng(4)
    Xb = torch.tensor(rng.standard_normal((5, 7, 2)), requires_grad=True)
    Zb = torch.tensor(rng.standard_normal((5, 3, 2)))
    Z1 = torch.tensor(rng.standard_normal((4, 2)))
    one = [tg.stationary_gram_plain(Xb[b], Zb[b], kmap) for b in range(5)]
    assert _rel(tg.stationary_gram(Xb, Zb, kmap), torch.stack(one)) == 0.0
    assert _rel(tg.stationary_gram(Xb, Z1.expand(5, 4, 2), kmap),
                torch.stack([tg.stationary_gram_plain(Xb[b], Z1, kmap) for b in range(5)])) == 0.0
    mapped = torch.func.vmap(lambda x, z: tg.stationary_gram(x, z[:1], kmap)[:, 0])(Xb, Zb)
    ref = torch.stack([o[:, 0] for o in one])
    assert _rel(mapped, ref) == 0.0
    W = torch.tensor(rng.standard_normal((5, 7)))
    (g,) = torch.autograd.grad(mapped, Xb, W)
    (g0,) = torch.autograd.grad(ref, Xb, W)
    assert _rel(g, g0) <= 1e-14


def test_torch_gram_mode_fused_dispatch(monkeypatch):
    """Under "fused" a non-symmetric Gram of a kernel with a CUDA map goes
    through the Function; a symmetric Gram keeps broadcast distances; the
    rational quadratic kernel (no CUDA map) takes the matmul distances; and
    "auto" never picks the Function."""
    calls = []
    real = tg._StationaryGram.apply
    monkeypatch.setattr(tg._StationaryGram, "apply", lambda *a: calls.append(1) or real(*a))
    X, Z = (torch.tensor(a) for a in _inputs(20, 13, 3, seed=5))
    m32, rq = tk.Matern32Kernel(), tk.RationalQuadraticKernel(alpha=1.3)
    with tgp.config_context(gram_mode="broadcast"):
        K_b, Ks_b, R_b = m32.gram(X, Z), m32.gram(X), rq.gram(X, Z)
    with tgp.config_context(gram_mode="fused"):
        K_f = m32.gram(X, Z)
        assert calls == [1]
        Ks_f = m32.gram(X)
        R_f = rq.gram(X, Z)
        assert calls == [1]
    R_m = rq.k_of_r2(tk.pairwise_sq_dist(X, Z, mode="matmul"))
    assert _rel(K_f, K_b) <= 1e-14 and torch.equal(Ks_f, Ks_b)
    assert torch.equal(R_f, R_m) and _rel(R_f, R_b) <= 1e-12
    with tgp.config_context(gram_mode="auto", gram_auto_threshold=0):
        m32.gram(X, Z)
    assert calls == [1]
    # the JAX package's own dispatch, for the record: symmetric Grams stay
    # exact, the rational quadratic kernel leaves the Pallas route
    jX, jZ = jnp.asarray(X.numpy()), jnp.asarray(Z.numpy())
    with jax_config_context(gram_mode="pallas"):
        assert _rel(Ks_f, jk.Matern32Kernel().gram(jX)) <= 1e-14
        assert _rel(R_f, jk.RationalQuadraticKernel(alpha=1.3).gram(jX, jZ)) <= 1e-12
    # pairwise_sq_dist takes "fused" as the matmul distances (knn's tiles)
    with tgp.config_context(gram_mode="fused"):
        assert torch.equal(tk.pairwise_sq_dist(X, Z), tk.pairwise_sq_dist(X, Z, mode="matmul"))


M, B, D, NUM_DATA = 16, 64, 3, 1000


def _elbo_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "k": np.array([0.4, -0.2]),
        "z": 1.2 * rng.standard_normal((M, D)),
        "m": 0.3 * rng.standard_normal(M),
        "A": 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M))),
    }
    x = rng.standard_normal((B, D))
    return params, x, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(B)


@pytest.mark.parametrize("name", ["se", "m52"])
def test_torch_minibatch_elbo_under_fused_gram_matches_jax_pallas(name, monkeypatch):
    """−elbo and its gradients in k, z, m and A with Kuf through the fused
    Gram (the port, "fused") and through the Pallas Gram (JAX, "pallas",
    interpret mode)."""
    jcls, tcls = MAPS[name]
    params, xb, yb = _elbo_case()

    def jloss(p):
        kernel = jsoftplus(p["k"][0]) * agp.with_lengthscale(jcls(), jsoftplus(p["k"][1]))
        f = agp.GP(kernel)
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        sva = agp.SparseVariationalApproximation(f(p["z"], 1e-6), q)
        return -agp.elbo(sva, f(jnp.asarray(xb), 0.1), jnp.asarray(yb), num_data=NUM_DATA)

    with jax_config_context(gram_mode="pallas"):
        vj, gj = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})

    calls = []
    real = tg._StationaryGram.apply
    monkeypatch.setattr(tg._StationaryGram, "apply", lambda *a: calls.append(1) or real(*a))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    kernel = tsoftplus(tp["k"][0]) * tgp.with_lengthscale(tcls(), tsoftplus(tp["k"][1]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(tp["m"], torch.tril(tp["A"]))
    sva = tgp.SparseVariationalApproximation(f(tp["z"], 1e-6), q)
    with tgp.config_context(gram_mode="fused"):
        vt = -tgp.elbo(sva, f(torch.tensor(xb), 0.1), torch.tensor(yb), num_data=NUM_DATA)
        vt.backward()
    assert len(calls) >= 1  # Kuf, the step's cross-Gram
    assert abs(vt.item() - float(vj)) <= 1e-8 * abs(float(vj))
    for k in params:
        assert _rel(tp[k].grad, gj[k]) <= 1e-8, k
