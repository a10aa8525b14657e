"""bf16 projection storage (``config.compute_dtype``) on the CPU, against
the JAX package: the storage gate case for case as
``tests/test_config_defaults.py::test_auto_compute_dtype_gates_on_m`` has it
(``kernel_device`` patched where that test patches
``jax.default_backend``), the bf16 minibatch ELBO of
``tests/test_svgp.py::test_bf16_compute_dtype_accuracy``'s setup against the
JAX package's under the same config and against f32, finite gradients,
every leaf's bf16 gradient against the JAX package's on the S-correction's
route and above it (the ELBO setup, and phase 21's cut to M = 256), f64
untouched by the flag, the projections' bf16 branch at M above the
S-correction, and the streaming ELBO's bf16 plain block with its gradients.
Run as a script (``PYTHONPATH=. python tests/test_torch_compute_dtype.py M
B ...``) it prints both packages' gradient gaps at phase 21's setup cut to
(M, B).

Under ``compute_dtype="bfloat16"`` both packages store Kuf, S·Kuf and the
projections in bf16 and sum in f32; the two differ in how the CPU's bf16
products round (XLA against oneDNN), so they are held to each other at
5e-3 relative, as f32 is held to bf16 at 2e-2 (the JAX test's gate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximategps_tpu as agp
import approximategps_tpu_torch as tgp
from approximategps_tpu.config import config_context as jax_config
from approximategps_tpu_torch.models import svgp as tsvgp
from approximategps_tpu_torch.utils.bijectors import softplus as tsoftplus

torch.set_num_threads(1)

PAIR_RTOL = 5e-3  # the port's bf16 ELBO against the JAX package's
BF16_RTOL = 2e-2  # bf16 against f32 (tests/test_svgp.py's gate)
F32_RTOL = 1e-3  # the two packages' f32 mean and variance through Lk⁻¹ at jitter 1e-4
M_SETUP = 5


def _elbo_setup():
    """tests/test_svgp.py's ``elbo_setup``: 20 points from jax.random."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(654321))
    x = jax.random.uniform(k1, (20,)) * 10
    y = jnp.sin(x) + 0.9 * jnp.cos(x * 1.6) + 0.4 * jax.random.uniform(k2, (20,))
    return np.asarray(x, np.float64), np.asarray(y, np.float64)


def _f32(a):
    return torch.tensor(np.asarray(a, np.float32))


# -- the storage gate ---------------------------------------------------------


def test_torch_storage_dtype_gates_on_m_on_the_kernel_device(monkeypatch):
    """"auto" stores f32 in bf16 on the kernel device only at
    M >= bf16_storage_min_m, its own gate apart from tri_matmul_min_m;
    "bfloat16" at any M, "float32" never; f64 never; the CPU under "auto"
    never."""
    from approximategps_tpu_torch.config import config, config_context

    f32 = torch.zeros((), dtype=torch.float32)
    f64 = torch.zeros((), dtype=torch.float64)
    assert config.compute_dtype == "auto"
    assert config.bf16_storage_min_m == 4096
    assert config.tri_matmul_min_m == 4096
    monkeypatch.setattr(tsvgp, "kernel_device", lambda t: True)
    assert tsvgp._storage_dtype(f32, 8192) == torch.bfloat16
    assert tsvgp._storage_dtype(f32, 4096) == torch.bfloat16
    assert tsvgp._storage_dtype(f32, 2048) is None
    assert tsvgp._storage_dtype(f32, None) is None
    assert tsvgp._storage_dtype(f64, 8192) is None
    with config_context(tri_matmul_min_m=16):
        assert tsvgp._storage_dtype(f32, 2048) is None
    with config_context(bf16_storage_min_m=1024):
        assert tsvgp._storage_dtype(f32, 2048) == torch.bfloat16
    with config_context(compute_dtype="bfloat16"):
        assert tsvgp._storage_dtype(f32, 32) == torch.bfloat16
    with config_context(compute_dtype="float32"):
        assert tsvgp._storage_dtype(f32, 8192) is None
    # off the kernel device "auto" never downcasts
    monkeypatch.setattr(tsvgp, "kernel_device", lambda t: False)
    assert tsvgp._storage_dtype(f32, 8192) is None


def test_torch_storage_dtype_cpu_tensor_under_auto_stays_f32():
    """Unpatched: a CPU tensor is not on the kernel device, so "auto"
    keeps f32 at any M, and the gate agrees with the JAX package off the
    TPU."""
    from approximategps_tpu.models.svgp import _storage_dtype as jax_storage

    f32 = torch.zeros((), dtype=torch.float32)
    for M in (32, 4096, 8192):
        assert tsvgp._storage_dtype(f32, M) is None
        assert jax_storage(jnp.float32, M) is None
    with tgp.config_context(compute_dtype="bfloat16"):
        assert tsvgp._storage_dtype(f32, 32) == torch.bfloat16


def test_torch_config_reads_the_environment():
    """The three knobs come from AGP_COMPUTE_DTYPE, AGP_BF16_STORAGE_MIN_M
    and AGP_TRI_MATMUL_MIN_M, as the JAX package's do."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, AGP_COMPUTE_DTYPE="bfloat16", AGP_BF16_STORAGE_MIN_M="128",
               AGP_TRI_MATMUL_MIN_M="256")
    code = ("from approximategps_tpu_torch import config as c; "
            "print(c.compute_dtype, c.bf16_storage_min_m, c.tri_matmul_min_m)")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["bfloat16", "128", "256"]


# -- the bf16 minibatch ELBO --------------------------------------------------


# the JAX test's q = N(m, I) makes S = Jᵀ(LqLqᵀ − I)J zero, so the bf16
# product it stores is 0 either way; a q with L ≠ I reaches it
Q_TRILS = {"the JAX test's q": np.eye(M_SETUP),
           "non-trivial q": 0.5 * np.eye(M_SETUP) + 0.1 * np.tril(np.ones((M_SETUP, M_SETUP)), -1)}


def _port_elbo(x, y, m, L, dtype=torch.float32, jitter=1e-5):
    f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9))
    xt = torch.tensor(x, dtype=dtype)
    fz = f(xt[:M_SETUP], jitter)
    q = tgp.MultivariateNormal(m, torch.tensor(L, dtype=dtype))
    sva = tgp.SparseVariationalApproximation(fz, q)
    return tgp.elbo(sva, f(xt, 0.1), torch.tensor(y, dtype=dtype))


def _jax_elbo(x, y, m, L, dtype=jnp.float32, jitter=1e-5):
    f = agp.GP(1.3 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.9))
    xj = jnp.asarray(x, dtype)
    fz = f(xj[:M_SETUP], jitter)
    q = agp.MultivariateNormal(jnp.asarray(m, dtype), jnp.asarray(L, dtype))
    return agp.elbo(agp.SparseVariationalApproximation(fz, q), f(xj, 0.1),
                    jnp.asarray(y, dtype))


@pytest.mark.parametrize("which", list(Q_TRILS))
def test_torch_bf16_elbo_matches_jax_and_f32(which):
    """The port's bf16 ELBO within 5e-3 of the JAX package's under the same
    config, and both within 2e-2 of their f32 values; with a q that makes
    S ≠ 0 the bf16 run really took the bf16 branch (it differs from f32)."""
    x, y = _elbo_setup()
    m, L = np.linspace(-0.5, 0.5, M_SETUP), Q_TRILS[which]
    vals = {}
    for mode in ("float32", "bfloat16"):
        with tgp.config_context(solve_mode="inv_matmul", compute_dtype=mode):
            vals[("torch", mode)] = float(_port_elbo(x, y, _f32(m), L))
        with jax_config(solve_mode="inv_matmul", compute_dtype=mode):
            vals[("jax", mode)] = float(_jax_elbo(x, y, m, L))
    t32, tbf = vals[("torch", "float32")], vals[("torch", "bfloat16")]
    j32, jbf = vals[("jax", "float32")], vals[("jax", "bfloat16")]
    assert abs(t32 - j32) / abs(j32) < 1e-5, (t32, j32)
    assert abs(tbf - jbf) / abs(jbf) < PAIR_RTOL, (tbf, jbf)
    assert abs(tbf - t32) / abs(t32) < BF16_RTOL, (tbf, t32)
    assert abs(jbf - j32) / abs(j32) < BF16_RTOL, (jbf, j32)
    assert (tbf != t32) == (which == "non-trivial q"), (tbf, t32)


def test_torch_bf16_elbo_gradients_finite():
    """Every leaf's gradient (the kernel's raw parameters, z, m and the
    scale_tril) finite under bf16 storage, in f32 (the master parameters
    stay f32), and near the f32 gradient."""
    x, y = _elbo_setup()
    p = _setup_params(x)
    grads = {}
    for mode in ("float32", "bfloat16"):
        with tgp.config_context(solve_mode="inv_matmul", compute_dtype=mode):
            grads[mode] = _port_grads(p, x, y, jitter=1e-5, num_data=None)[1]
    for k in p:
        g32, gbf = grads["float32"][k], grads["bfloat16"][k]
        assert gbf.dtype == np.float32
        assert np.isfinite(gbf).all()
        assert _rel(gbf, g32) <= 5e-2, (k, gbf, g32)


# -- the bf16 gradients against the JAX package's -----------------------------

# Both packages store S̄ = (K∘w)Kᵀ, the cotangent diag_quad_sym gives S, in
# bf16 where the S-correction serves the variance, and the whitened cache's
# pullback brings it back through J = Lk⁻¹ on both sides.  At phase 21's
# setup (chip_smoke.py) the bf16 gradients sit 1e-1 from f32 in both
# packages at M = 2048 (run this file as a script for the readings), so a
# port fault and bf16 rounding are told apart by the pair, not by f32.
# Largest pair gap read here at these setups: 1.4e-4 (dz, at M = 256 without
# the S-correction), against bf16-from-f32 gaps of 1e-3 to 1e-2.
GRAD_PAIR_RTOL = 1e-3
ROUTES = {"S-correction": {},
          # above s_corr_max_m: A = Lk⁻¹Kuf and BᵀA in bf16, by the
          # triangular products
          "no S-correction, triangular": {"s_corr_max_m": 2, "tri_matmul_min_m": 4}}


def _setup_params(x) -> dict:
    """The ELBO setup's parameters: raw (variance, lengthscale), z = x[:5],
    the non-trivial q."""
    return {"k": np.array([0.3, -0.2]), "z": x[:M_SETUP].copy(),
            "m": np.linspace(-0.5, 0.5, M_SETUP), "A": Q_TRILS["non-trivial q"]}


def _phase21_setup(M: int, B: int):
    """chip_smoke.py's phase 21 (bench.py's SVGP: SE with raw (0.5, 0.5), z
    ~ N(0, 1) in D = 8, jitter 1e-6, noise 0.1, num_data 10^6) cut to M
    inducing points and a batch of B, with phase 4's kind of non-trivial q
    (m ≠ 0, A ≠ I, so that every term of the pullbacks is reached)."""
    rng = np.random.default_rng(M)
    p = {"k": np.array([0.5, 0.5]), "z": rng.standard_normal((M, 8)),
         "m": 0.3 * rng.standard_normal(M),
         "A": 0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M)))}
    x = rng.standard_normal((B, 8))
    return p, x, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(B)


def _rel(a, b) -> float:
    """max|a − b| / max|b| (max|a − b| where b vanishes)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / (scale if scale > 0 else 1.0))


def _port_grads(p: dict, x, y, jitter: float, num_data):
    """(−elbo, its gradient in every leaf) of bench.py's SVGP loss in the
    port, in f32 under the config in force."""
    tp = {k: _f32(v).requires_grad_() for k, v in p.items()}
    f = tgp.GP(tsoftplus(tp["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                             tsoftplus(tp["k"][1])))
    sva = tgp.SparseVariationalApproximation(
        f(tp["z"], jitter), tgp.MultivariateNormal(tp["m"], torch.tril(tp["A"])))
    loss = -tgp.elbo(sva, f(_f32(x), 0.1), _f32(y), num_data=num_data)
    grads = torch.autograd.grad(loss, list(tp.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(tp, grads)}


def _jax_grads(p: dict, x, y, jitter: float, num_data):
    """The same in the JAX package."""
    from approximategps_tpu.utils.bijectors import softplus as jsoftplus

    def loss(jp):
        f = agp.GP(jsoftplus(jp["k"][0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                                jsoftplus(jp["k"][1])))
        sva = agp.SparseVariationalApproximation(
            f(jp["z"], jitter), agp.MultivariateNormal(jp["m"], jnp.tril(jp["A"])))
        return -agp.elbo(sva, f(jnp.asarray(x, jnp.float32), 0.1),
                         jnp.asarray(y, jnp.float32), num_data=num_data)

    v, g = jax.value_and_grad(loss)({k: jnp.asarray(a, jnp.float32) for k, a in p.items()})
    return float(v), {k: np.asarray(a) for k, a in g.items()}


def grad_readings(p: dict, x, y, jitter: float, num_data, route: dict) -> dict:
    """Each leaf's gradient gaps on one setup and route: the port's and the
    JAX package's bf16 gradients from their f32 ones, and the two packages'
    from each other in bf16 and in f32."""
    out = {}
    for mode in ("float32", "bfloat16"):
        with tgp.config_context(solve_mode="inv_matmul", compute_dtype=mode, **route):
            out[("port", mode)] = _port_grads(p, x, y, jitter, num_data)[1]
        with jax_config(solve_mode="inv_matmul", compute_dtype=mode, **route):
            out[("jax", mode)] = _jax_grads(p, x, y, jitter, num_data)[1]
    pairs = {"port bf16 - f32": (("port", "bfloat16"), ("port", "float32")),
             "jax bf16 - f32": (("jax", "bfloat16"), ("jax", "float32")),
             "bf16 port - jax": (("port", "bfloat16"), ("jax", "bfloat16")),
             "f32 port - jax": (("port", "float32"), ("jax", "float32"))}
    return {name: {k: _rel(out[a][k], out[b][k]) for k in p} for name, (a, b) in pairs.items()}


SETUPS = {"elbo setup, M = 5": lambda: (lambda x, y: (_setup_params(x), x, y, 1e-5, None))(
              *_elbo_setup()),
          "phase 21, M = 256, B = 1024": lambda: (*_phase21_setup(256, 1024), 1e-6, 1_000_000)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("setup", list(SETUPS))
def test_torch_bf16_gradients_match_jax(setup, route):
    """Every leaf's bf16 gradient (the kernel's raw parameters, z, m, the
    scale_tril) against the JAX package's under the same config, on the
    S-correction route and on the projections' route above s_corr_max_m
    with the triangular products: the pair within GRAD_PAIR_RTOL of each
    gradient's largest entry (within 1e-4 in f32), and ten times nearer to
    each other than bf16 storage moves the port off f32."""
    r = grad_readings(*SETUPS[setup](), ROUTES[route])
    for k in r["bf16 port - jax"]:
        assert r["f32 port - jax"][k] <= 1e-4, (k, r)
        assert r["bf16 port - jax"][k] <= GRAD_PAIR_RTOL, (k, r)
    assert max(r["port bf16 - f32"].values()) > 10 * max(r["bf16 port - jax"].values()), r


def test_torch_bf16_flag_leaves_f64_bitwise():
    """f64 inputs are never downcast: the ELBO and its gradient carry the
    same bits with the flag on and off."""
    x, y = _elbo_setup()
    out = {}
    for mode in ("float32", "bfloat16"):
        with tgp.config_context(solve_mode="inv_matmul", compute_dtype=mode):
            m = torch.tensor(np.linspace(-0.5, 0.5, M_SETUP), requires_grad=True)
            e = _port_elbo(x, y, m, Q_TRILS["non-trivial q"], dtype=torch.float64, jitter=1e-8)
            out[mode] = (e.detach(), torch.autograd.grad(e, m)[0])
    assert torch.equal(out["float32"][0], out["bfloat16"][0])
    assert torch.equal(out["float32"][1], out["bfloat16"][1])


# -- the projections' bf16 branch (no S-correction) ---------------------------


@pytest.mark.parametrize("tri", [False, True])
def test_torch_bf16_projections_without_s_correction_match_jax(tri):
    """Above ``s_corr_max_m`` the variance takes A = Lk⁻¹Kuf and BᵀA; under
    bf16 both are stored in bf16 (dense, or through ``tri_project`` with the
    triangular gate lowered) and their squares summed in f32.  The port's
    mean and variance against the JAX package's under the same config, and
    both against f32."""
    rng = np.random.default_rng(5)
    M, N = 8, 64  # inducing points 1.4 apart at lengthscale 0.9
    x = rng.uniform(0, 10, N)
    z = np.linspace(0, 10, M)
    m = 0.3 * rng.standard_normal(M)
    A = 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M)))
    xs = rng.uniform(0, 10, 40)
    cfg = dict(solve_mode="inv_matmul", s_corr_max_m=4,
               tri_matmul_min_m=8 if tri else 4096)

    def port(mode):
        with tgp.config_context(compute_dtype=mode, **cfg):
            f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9))
            sva = tgp.SparseVariationalApproximation(
                f(_f32(z), 1e-4), tgp.MultivariateNormal(_f32(m), _f32(A)))
            post = tgp.posterior(sva)
            assert post.cache.S_corr is None
            if mode == "bfloat16":
                Ax, Kuf = post._A_and_Kuf(_f32(xs))
                assert Ax.dtype == Kuf.dtype == post._BtA(Ax).dtype == torch.bfloat16
            mu, var = post.mean_and_var(_f32(xs))
            assert mu.dtype == var.dtype == torch.float32
            return mu.numpy(), var.numpy()

    def jaxp(mode):
        with jax_config(compute_dtype=mode, **cfg):
            f = agp.GP(1.3 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.9))
            sva = agp.SparseVariationalApproximation(
                f(jnp.asarray(z, jnp.float32), 1e-4),
                agp.MultivariateNormal(jnp.asarray(m, jnp.float32),
                                       jnp.asarray(A, jnp.float32)))
            mu, var = agp.posterior(sva).mean_and_var(jnp.asarray(xs, jnp.float32))
            return np.asarray(mu), np.asarray(var)

    (tmu, tvar), (jmu, jvar) = port("bfloat16"), jaxp("bfloat16")
    (tmu32, tvar32), (jmu32, jvar32) = port("float32"), jaxp("float32")
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    assert rel(tmu32, jmu32) < F32_RTOL and rel(tvar32, jvar32) < F32_RTOL
    assert rel(tmu, jmu) < PAIR_RTOL and rel(tvar, jvar) < PAIR_RTOL, \
        (rel(tmu, jmu), rel(tvar, jvar))
    assert rel(tmu, tmu32) < BF16_RTOL and rel(tvar, tvar32) < BF16_RTOL
    assert not np.array_equal(tvar, tvar32)


# -- the streaming ELBO's plain block -----------------------------------------


def test_torch_bf16_streaming_elbo_matches_jax():
    """The streaming ELBO's plain block (the port's ``data_term_mode="plain"``,
    the JAX package's route off the TPU) under bf16 storage against the
    JAX package's, and against f32; its gradients in m and the scale_tril
    finite and within GRAD_PAIR_RTOL of the JAX package's."""
    rng = np.random.default_rng(11)
    M, N, block = 8, 300, 64
    x = rng.uniform(0, 10, N)
    y = np.sin(x) + 0.1 * rng.standard_normal(N)
    z = np.linspace(0, 10, M)
    m = 0.3 * rng.standard_normal(M)
    A = 0.6 * np.eye(M) + 0.05 * np.tril(rng.standard_normal((M, M)))

    def port(mode):
        with tgp.config_context(compute_dtype=mode, data_term_mode="plain"):
            f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9))
            mt, At = _f32(m).requires_grad_(), _f32(A).requires_grad_()
            sva = tgp.SparseVariationalApproximation(
                f(_f32(z), 1e-4), tgp.MultivariateNormal(mt, torch.tril(At)))
            e = tgp.streaming_elbo(sva, tgp.GaussianLikelihood(0.1), _f32(x), _f32(y),
                                   block_size=block, num_data=10 * N)
            return e.item(), [g.numpy() for g in torch.autograd.grad(e, (mt, At))]

    def jaxp(mode):
        def e(mj, Aj):
            f = agp.GP(1.3 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.9))
            sva = agp.SparseVariationalApproximation(
                f(jnp.asarray(z, jnp.float32), 1e-4), agp.MultivariateNormal(mj, jnp.tril(Aj)))
            return agp.streaming_elbo(
                sva, agp.GaussianLikelihood(0.1), jnp.asarray(x, jnp.float32),
                jnp.asarray(y, jnp.float32), block_size=block, num_data=10 * N)

        with jax_config(compute_dtype=mode):
            v, g = jax.value_and_grad(e, argnums=(0, 1))(jnp.asarray(m, jnp.float32),
                                                         jnp.asarray(A, jnp.float32))
        return float(v), [np.asarray(a) for a in g]

    (tbf, gbf), (t32, g32) = port("bfloat16"), port("float32")
    (jbf, jgbf), (j32, jg32) = jaxp("bfloat16"), jaxp("float32")
    assert abs(t32 - j32) / abs(j32) < 1e-5, (t32, j32)
    assert abs(tbf - jbf) / abs(jbf) < PAIR_RTOL, (tbf, jbf)
    assert abs(tbf - t32) / abs(t32) < BF16_RTOL, (tbf, t32)
    assert tbf != t32
    for which, t, j, t_32, j_32 in zip(("dm", "dA"), gbf, jgbf, g32, jg32):
        assert np.isfinite(t).all(), which
        assert _rel(t_32, j_32) <= 1e-4, (which, _rel(t_32, j_32))
        assert _rel(t, j) <= GRAD_PAIR_RTOL, (which, _rel(t, j), _rel(t, t_32))
        assert _rel(t, t_32) <= 5e-2, (which, _rel(t, t_32))

if __name__ == "__main__":
    # the gradient readings at phase 21's setup cut to (M, B) (arguments: M B
    # pairs, default 256 1024), both routes
    import sys

    jax.config.update("jax_platforms", "cpu")
    sizes = [int(a) for a in sys.argv[1:]] or [256, 1024]
    for M, B in zip(sizes[::2], sizes[1::2]):
        for route, cfg in ROUTES.items():
            print(f"M = {M}, B = {B}, {route}:")
            for name, gaps in grad_readings(*_phase21_setup(M, B), 1e-6, 1_000_000,
                                            cfg).items():
                print(f"  {name:16s} " + "  ".join(f"d{k} {e:.2e}" for k, e in gaps.items()))
