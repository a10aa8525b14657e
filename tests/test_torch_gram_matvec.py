"""Kernel 5, the fused Gram matvec (``ops/gram_matvec.py``), on the CPU in
f64 against the JAX package's ``pallas_gram_matvec``.

On CPU tensors the port's autograd Function runs its plain inner pass, so
what is held here is the Function's algebra: the forward and the pullback
(V̄ as the transposed pass, X̄q and Z̄k as derivative-map passes over
(1 + D)·R columns, chunked to 128), against the JAX package's custom VJP.

- ``test_torch_gram_matvec_matches_pallas_interpret``: against the Pallas
  kernel itself in interpret mode (as ``tests/test_gram_matvec.py`` runs it),
  every map, N ≠ M and the coincident case Xq = Zk.
- ``test_torch_gram_matvec_matches_jax_vjp_grid``: the whole grid of maps,
  R ∈ {1, 7, 32} and D ∈ {1, 2, 8} against the same custom VJP with the
  Pallas pass swapped for a dense one in the test (interpret mode unrolls R
  lane reductions a pass and takes tens of seconds to compile at D = 8).
- ``test_torch_gram_matvec_self_*``: the self-Gram Function, whose pullback
  is one pass (V̄ = K·Ō and X̄ from c_ij = [Ō_i | V_i]·[V_j | Ō_j]), against
  the JAX VJP of ``pallas_gram_matvec(X, X, V)``: its X̄q + Z̄k and V̄, on
  point sets with repeated points (r² = 0 off the diagonal).

Tolerances: forward 1e-12 and cotangents 1e-10, relative to each array's
largest entry (f64 sums over at most 32 terms in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import approximategps_tpu as agp
from approximategps_tpu.config import config_context
from approximategps_tpu.core import kernels as jk
from approximategps_tpu.models.iterative import kernel_matvec as jax_kernel_matvec
from approximategps_tpu.ops import gram_matvec as jgm
from approximategps_tpu_torch import config_context as tconfig_context
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.models import iterative as tit
from approximategps_tpu_torch.ops import gram_matvec as tgm
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

FUSED = dict(matvec_mode="fused", use_pallas=True, pallas_interpret=True)
MAPS = {
    "se": (jk.SqExponentialKernel, tk.SqExponentialKernel),
    "m12": (jk.Matern12Kernel, tk.Matern12Kernel),
    "m32": (jk.Matern32Kernel, tk.Matern32Kernel),
    "m52": (jk.Matern52Kernel, tk.Matern52Kernel),
}


def _inputs(N, M, D, R, seed, coincident=False):
    """Xq (N, D), Zk (M, D), V (M,) for R = 1 else (M, R), and a cotangent
    of the output's shape; Zk is a copy of Xq when ``coincident``."""
    rng = np.random.default_rng(seed)
    Xq = rng.uniform(0.0, 3.0, (N, D))
    Zk = Xq.copy() if coincident else rng.uniform(0.0, 3.0, (M, D))
    shape = (Zk.shape[0],) if R == 1 else (Zk.shape[0], R)
    V = rng.standard_normal(shape)
    W = rng.standard_normal((N,) + shape[1:])
    return Xq, Zk, V, W


def _jax_vjp(Xq, Zk, V, W, fn):
    @jax.jit
    def run(a, b, c, w):
        out, vjp = jax.vjp(lambda a, b, c: jgm.pallas_gram_matvec(a, b, c, fn), a, b, c)
        return out, vjp(w)

    with config_context(**FUSED):
        return run(Xq, Zk, V, W)


def _torch_vjp(Xq, Zk, V, W, kmap):
    ts = [torch.tensor(a, requires_grad=True) for a in (Xq, Zk, V)]
    out = tgm.gram_matvec(*ts, kmap)
    return out.detach(), torch.autograd.grad(out, ts, torch.tensor(W))


def _rel(t, j) -> float:
    j = np.asarray(j)
    return float(np.abs(t.detach().numpy() - j).max() / max(np.abs(j).max(), 1e-300))


def _check(Xq, Zk, V, W, name):
    jcls, tcls = MAPS[name]
    jout, jgrads = _jax_vjp(Xq, Zk, V, W, jcls.k_of_r2)
    tout, tgrads = _torch_vjp(Xq, Zk, V, W, tcls().kernel_map())
    assert tout.shape == jout.shape
    assert _rel(tout, jout) <= 1e-12
    for what, t, j in zip(("Xq", "Zk", "V"), tgrads, jgrads):
        assert bool(torch.isfinite(t).all()), what
        assert _rel(t, j) <= 1e-10, (what, _rel(t, j))


@pytest.mark.parametrize("coincident", [False, True], ids=["n_ne_m", "coincident"])
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_gram_matvec_matches_pallas_interpret(name, coincident):
    """The self-Gram case puts r² = 0 on the diagonal: g′(0) takes the JAX
    package's value there (0, or 5/3 for Matérn-5/2), not a huge one."""
    R = 1 if coincident else 7
    _check(*_inputs(21, 13, 2, R, seed=list(MAPS).index(name), coincident=coincident), name)


def _dense_forward_multi(Xq, Zk, V, k_map, tile_m, tile_n):
    r2 = jnp.sum((Xq[:, None, :] - Zk[None, :, :]) ** 2, axis=-1)
    return k_map(r2) @ V


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("R", [1, 7, 32])
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_gram_matvec_matches_jax_vjp_grid(name, R, D, monkeypatch):
    """At D = 8 and R = 32 both pullbacks run three chunks of 14 columns
    (rc = 128 // 9) for each coordinate cotangent."""
    monkeypatch.setattr(jgm, "_forward_multi", _dense_forward_multi)
    _check(*_inputs(23, 17, D, R, seed=100 * D + R), name)


def test_torch_gram_matvec_pullback_chunks_wide_blocks():
    """R = 50 at D = 2 needs two coordinate passes of at most 42 · 3 = 126
    columns each (``pullback_passes`` counts them), and still agrees with
    autograd through the plain pass."""
    Xq, Zk, V, W = _inputs(19, 13, 2, 50, seed=5)
    kmap = tk.Matern32Kernel().kernel_map()
    before = dict(tgm.pullback_passes)
    _, grads = _torch_vjp(Xq, Zk, V, W, kmap)
    assert tgm.pullback_passes["calls"] == before["calls"] + 1
    assert tgm.pullback_passes["passes"] == before["passes"] + 1 + 2 + 2
    ts = [torch.tensor(a, requires_grad=True) for a in (Xq, Zk, V)]
    ref = torch.autograd.grad(tgm.gram_matvec_plain(*ts, kmap), ts, torch.tensor(W))
    for what, g, r in zip(("Xq", "Zk", "V"), grads, ref):
        assert _rel(g, r.numpy()) <= 1e-10, what


def _kern_t(theta):
    return torch.exp(theta[1]) * tk.with_lengthscale(tk.SqExponentialKernel(), torch.exp(theta[0]))


def _kern_j(theta):
    return jnp.exp(theta[1]) * agp.with_lengthscale(jk.SqExponentialKernel(), jnp.exp(theta[0]))


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_torch_kernel_matvec_fused_hyperparameter_grads(noise):
    """Lengthscale and variance cotangents through the dispatch's input
    fold (Xs = X·s) and output scale, against the JAX package's XLA path;
    the value against it to 1e-12, the gradients to 1e-10."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0.0, 3.0, (41, 2))
    v = rng.standard_normal(41)
    nz = 0.1 + rng.uniform(size=41) if noise == "vector" else 0.2
    theta = np.array([-0.3, 0.5])

    def jloss(th):
        with config_context(matvec_mode="xla"):
            return jnp.sum(jnp.tanh(jax_kernel_matvec(_kern_j(th), x, nz)(v)))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    before = tit.stats["matvec_fused"]
    with tconfig_context(matvec_mode="fused"):
        tval = torch.sum(torch.tanh(
            tit.kernel_matvec(_kern_t(th), torch.from_numpy(x),
                              torch.as_tensor(nz, dtype=torch.float64))(
                torch.from_numpy(v))))
    assert tit.stats["matvec_fused"] == before + 1
    (tgrad,) = torch.autograd.grad(tval, th)
    assert abs(tval.item() - float(jval)) <= 1e-12 * abs(float(jval))
    assert _rel(tgrad, jgrad) <= 1e-10


def test_torch_fused_dispatch_negative_cases():
    """Where the fused route does not serve, the dispatch declines (None)
    and ``kernel_matvec`` takes the plain block path."""

    class NotStationary(tk.Kernel):
        def gram(self, X, Z=None):
            X = tk.as_points(X)
            return X @ (X if Z is None else tk.as_points(Z)).T

    se = 1.3 * tk.with_lengthscale(tk.SqExponentialKernel(), 0.7)
    x2 = torch.rand((6, 2), dtype=torch.float64)
    with tconfig_context(matvec_mode="fused"):
        assert tgm.fused_stationary_matvec(NotStationary(), x2) is None
        assert tgm.fused_stationary_matvec(se, torch.rand((6, 9), dtype=torch.float64)) is None
        fused = tgm.fused_stationary_matvec(se, x2)
        assert fused is not None
        assert fused(torch.ones((6, 33), dtype=torch.float64)) is None  # R > 32
        assert fused(torch.ones((6, 32), dtype=torch.float64)) is not None
        with tconfig_context(matvec_fused_max_rhs=4):
            assert tgm.fused_stationary_matvec(se, x2)(torch.ones((6, 5),
                                                                  dtype=torch.float64)) is None
    with tconfig_context(matvec_mode="plain"):
        assert tgm.fused_stationary_matvec(se, x2) is None
    with tconfig_context(matvec_mode="fused", use_kernels=False):
        assert tgm.fused_stationary_matvec(se, x2) is None
    with tconfig_context(matvec_mode="auto"):
        assert tgm.fused_stationary_matvec(se, x2) is None  # a CPU tensor
    with tconfig_context(matvec_mode="pallas"):
        with pytest.raises(ValueError, match="matvec_mode"):
            tgm.fused_stationary_matvec(se, x2)


def test_torch_fused_dispatch_declines_forward_mode_ad():
    """The Function has no forward-mode rule: with a tangent on the inputs
    or on v the dispatch declines, and the plain route carries the tangent
    (checked against a finite difference of the matvec)."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.uniform(0.0, 3.0, (15, 2)))
    v = torch.tensor(rng.standard_normal(15))
    dv = torch.tensor(rng.standard_normal(15))
    kern = 1.3 * tk.with_lengthscale(tk.Matern52Kernel(), 0.7)
    with tconfig_context(matvec_mode="fused"):
        with fwAD.dual_level():
            vd = fwAD.make_dual(v, dv)
            assert tgm.fused_stationary_matvec(kern, x)(vd) is None
            xd = fwAD.make_dual(x, torch.zeros_like(x))
            assert tgm.fused_stationary_matvec(kern, xd) is None
            before = dict(tit.stats)
            out = tit.kernel_matvec(kern, x, 0.1)(vd)
            tangent = fwAD.unpack_dual(out).tangent
        assert tit.stats["matvec_plain"] == before["matvec_plain"] + 1
        assert tit.stats["matvec_fused"] == before["matvec_fused"]
        mv = tit.kernel_matvec(kern, x, 0.1)
        # the matvec is linear in v: its tangent is the matvec of dv
        torch.testing.assert_close(tangent, mv(dv), rtol=1e-12, atol=1e-12)


def _self_inputs(N, D, R, seed):
    """X (N, D) whose last quarter repeats its first points, V and a
    cotangent W of shape (N,) for R = 1 else (N, R)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 3.0, (N, D))
    X[-(N // 4):] = X[:N // 4]
    shape = (N,) if R == 1 else (N, R)
    return X, rng.standard_normal(shape), rng.standard_normal(shape)


def _check_self(X, V, W, name):
    jcls, tcls = MAPS[name]
    jout, (jxq, jzk, jv) = _jax_vjp(X, X, V, W, jcls.k_of_r2)
    ts = [torch.tensor(a, requires_grad=True) for a in (X, V)]
    before = dict(tgm.pullback_passes)
    out = tgm.gram_matvec_self(*ts, tcls().kernel_map())
    gx, gv = torch.autograd.grad(out, ts, torch.tensor(W))
    assert tgm.pullback_passes["calls"] == before["calls"] + 1
    assert tgm.pullback_passes["passes"] == before["passes"] + 1
    assert out.shape == jout.shape and gv.shape == V.shape
    assert _rel(out, jout) <= 1e-12
    assert _rel(gx, np.asarray(jxq) + np.asarray(jzk)) <= 1e-10
    assert _rel(gv, jv) <= 1e-10


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("R", [1, 16, 32])
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_gram_matvec_self_matches_jax_vjp(name, R, D, monkeypatch):
    """The one-pass pullback on the CPU (its plain version) against the JAX
    custom VJP with a dense inner pass, as the grid test runs it; the value
    to 1e-12, X̄ = X̄q + Z̄k and V̄ to 1e-10."""
    monkeypatch.setattr(jgm, "_forward_multi", _dense_forward_multi)
    _check_self(*_self_inputs(24, D, R, seed=200 + 10 * D + R), name)


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_gram_matvec_self_matches_pallas_interpret(name):
    """The same against the Pallas kernel itself in interpret mode, R = 16,
    D = 2 (the exact-GP path's probe width)."""
    _check_self(*_self_inputs(20, 2, 16, seed=300 + list(MAPS).index(name)), name)


def test_torch_gram_matvec_pass_part_picks_by_width(monkeypatch):
    """f32 passes take the SIMT kernel below ``MMA_FROM_R`` columns and the
    tensor-core kernel from it; f64 always the SIMT one."""
    for R in range(1, 129):
        want = "simt" if R < tgm.MMA_FROM_R else "mma"
        assert tgm.pass_part(R) == tgm.pass_part(R, torch.float32) == want
        assert tgm.pass_part(R, torch.float64) == "simt"
    monkeypatch.setattr(tgm, "MMA_FROM_R", 3)
    assert [tgm.pass_part(R) for R in (1, 2, 3, 4)] == ["simt", "simt", "mma", "mma"]


def test_torch_fused_dispatch_reaches_the_self_gram_function(monkeypatch):
    """``kernel_matvec``'s fused route computes K(X, X)·v as a self-Gram
    (the scaled Function with no key points: an isotropic lengthscale takes
    its cotangent from r² itself), so with the points held fixed its
    pullback is one pass (r²·g′); the value and the lengthscale and
    variance gradients equal the general Function's, K(X, X) as a cross
    product."""
    calls = []
    real = tgm._GramMatvec.apply

    def spy(Xq, Zk, V, s, kmap):
        calls.append((Zk is None, tuple(V.shape)))
        return real(Xq, Zk, V, s, kmap)

    rng = np.random.default_rng(21)
    x = torch.tensor(rng.uniform(0.0, 3.0, (33, 2)))
    v = torch.tensor(rng.standard_normal((33, 4)))

    def value_and_grad(cross: bool):
        th = torch.tensor([-0.3, 0.5], dtype=torch.float64, requires_grad=True)
        with tconfig_context(matvec_mode="fused"):
            if cross:
                out = tgm.fused_stationary_matvec(_kern_t(th), x, x)(v) + 0.2 * v
            else:
                out = tit.kernel_matvec(_kern_t(th), x, 0.2)(v)
            val = torch.sum(torch.tanh(out))
        return val.detach(), torch.autograd.grad(val, th)[0]

    monkeypatch.setattr(tgm._GramMatvec, "apply", spy)
    before = dict(tgm.pullback_passes)
    val, grad = value_and_grad(False)
    assert calls == [(True, (33, 4))]
    assert tgm.pullback_passes["passes"] == before["passes"] + 1
    val0, grad0 = value_and_grad(True)
    assert calls[1] == (False, (33, 4))
    assert abs(val.item() - val0.item()) <= 1e-12 * abs(val0.item())
    assert _rel(grad, grad0.numpy()) <= 1e-10


# -- the lengthscale's cotangent from r² itself ------------------------------

@pytest.mark.parametrize("name", list(MAPS))
def test_torch_lengthscale_pass_matches_dense(name):
    """The third map of a pass, h = r²·g′(r²), against the dense product on
    points with repeats (r² = 0 off the diagonal, where h is 0)."""
    kmap = MAPS[name][1]().kernel_map()
    Xq, Zk, V, _ = _inputs(40, 50, 2, 3, seed=31)
    Zk[:5] = Xq[:5]
    Xq, Zk, V = (torch.tensor(a) for a in (Xq, Zk, V))
    r2 = torch.sum((Xq[:, None, :] - Zk[None, :, :]) ** 2, dim=-1)
    want = (kmap.dk_of_r2(r2) * r2) @ V
    assert _rel(tgm.gram_matvec_pass(Xq, Zk, V, kmap, deriv=2), want.numpy()) <= 1e-12


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("name", list(MAPS))
def test_torch_scaled_function_gradients_match_autograd(name, cross):
    """The scaled Function (an isotropic lengthscale folded in) against
    autograd of the dense Gram in f64: the output and the cotangents of the
    query and key points, V, and the scale, whose cotangent is the r²·g′
    pass."""
    kmap = MAPS[name][1]().kernel_map()
    Xq, Zk, V, W = _inputs(30, 45, 2, 5, seed=32)
    if not cross:
        Zk = Xq
        V, W = V[:30], W
    Xq, Zk, V = (torch.tensor(a, requires_grad=True) for a in (Xq, Zk, V))
    s = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    args = (Xq, Zk if cross else None, V, s, kmap)
    out = tgm._GramMatvec.apply(*args)
    ins = [t for t in (Xq, Zk, V, s) if cross or t is not Zk]
    got = torch.autograd.grad(out, ins, torch.tensor(W))
    d = (Xq * s)[:, None, :] - ((Zk if cross else Xq) * s)[None, :, :]
    ref_out = kmap.k_of_r2(torch.sum(d * d, dim=-1)) @ V
    ref = torch.autograd.grad(ref_out, ins, torch.tensor(W))
    assert _rel(out.detach(), ref_out.detach().numpy()) <= 1e-12
    for g, r in zip(got, ref):
        assert _rel(g, r.numpy()) <= 1e-10


@pytest.mark.parametrize("name", list(MAPS))
def test_torch_scaled_self_function_with_fixed_points(name):
    """The self-Gram with the points fixed and V and the scale carrying
    gradients (the logdet surrogate's product): V̄ = K·Ō by the transposed
    pass and s̄ by the r²·g′ pass, two passes and no self pullback, against
    autograd of the dense Gram in f64."""
    kmap = MAPS[name][1]().kernel_map()
    Xq, _, V, W = _inputs(30, 30, 2, 5, seed=33)
    X = torch.tensor(Xq)
    V = torch.tensor(V, requires_grad=True)
    s = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    before = dict(tgm.pullback_passes)
    got = torch.autograd.grad(tgm._GramMatvec.apply(X, None, V, s, kmap), (V, s), torch.tensor(W))
    assert tgm.pullback_passes["calls"] == before["calls"] + 1
    assert tgm.pullback_passes["passes"] == before["passes"] + 2
    d = (X * s)[:, None, :] - (X * s)[None, :, :]
    ref = torch.autograd.grad(kmap.k_of_r2(torch.sum(d * d, dim=-1)) @ V, (V, s), torch.tensor(W))
    for g, r in zip(got, ref):
        assert _rel(g, r.numpy()) <= 1e-10


def test_torch_lengthscale_cotangent_keeps_f32_digits():
    """The fault this repairs: through the points' cotangents, the
    lengthscale's cotangent is Σᵢ x̄ᵢ·xᵢ, a sum that cancels (Σᵢ x̄ᵢ = 0),
    so in f32 it loses digits in proportion to the cancellation C =
    Σᵢ|x̄ᵢ·xᵢ| / |Σᵢ x̄ᵢ·xᵢ| (here, phase 15's data model at N = 1500,
    1.5·SE(ℓ = 1.2) on [0, 10]², C ≈ 420 and 3.3e-5 of the entry lost);
    from r² itself it keeps the f32 rounding of the products (2.5e-8).
    Held: the fused route's θ-cotangent of Σ a∘(K b) in f32 against f64, on
    the self-Gram and the cross route, and the entry as the points'
    cotangents give it, which misses the same bound."""
    rng = np.random.default_rng(38)
    x = rng.uniform(0.0, 10.0, (1500, 2))
    a, b = rng.standard_normal((2, 1500, 16))
    theta = np.log(np.expm1(np.array([1.5, 1.2])))

    def cot(dtype, cross):
        th = torch.tensor(theta, dtype=dtype, requires_grad=True)
        X = torch.tensor(x, dtype=dtype)
        kern = tsoftplus(th[0]) * tk.with_lengthscale(tk.SqExponentialKernel(),
                                                      tsoftplus(th[1]))
        with tconfig_context(matvec_mode="fused"):
            out = tgm.fused_stationary_matvec(kern, X, X if cross else None)(
                torch.tensor(b, dtype=dtype))
        return torch.autograd.grad(torch.sum(torch.tensor(a, dtype=dtype) * out), th)[0].double()

    for cross in (False, True):
        g32, g64 = cot(torch.float32, cross), cot(torch.float64, cross)
        err = ((g32 - g64).abs() / g64.abs()).numpy()
        assert err[1] <= 1e-6, err
    # the same entry through the points' cotangents, as it was formed before
    kmap = tk.SqExponentialKernel().kernel_map()
    sc = 1.0 / np.log1p(np.exp(theta[1]))

    def through_points(dtype):
        X = torch.tensor(x, dtype=dtype)
        xs = (X * sc).requires_grad_()
        out = tgm.gram_matvec_self(xs, torch.tensor(b, dtype=dtype), kmap)
        xbar = torch.autograd.grad(torch.sum(torch.tensor(a, dtype=dtype) * out), xs)[0]
        return torch.sum(xbar * X).item()

    old32, old64 = through_points(torch.float32), through_points(torch.float64)
    assert abs(old32 - old64) / abs(old64) > 1e-5
