"""The data-parallel layer of the PyTorch port (``parallel/``,
``dp_streaming_elbo`` and the ``mesh=`` paths of the matrix-free tier) on
the CPU in f64, in a gloo world of three processes.

One world of three ranks and one world of one rank are started once for the
module (``_child``, each process with one thread and a 60 s gloo timeout on
a free port of 127.0.0.1).  Each rank runs every case of :func:`_cases` on
its data mesh and saves what it got; this process runs the same cases
without a mesh (the port's single-process path) and the JAX package's mesh
functions on ``conftest.py``'s 8 virtual devices, while the worlds run.  A
world that does not finish in time is killed and fails the tests.  Every
test is one check on those results, at ``tests/test_parallel.py``'s
tolerances.

This module imports neither JAX nor the JAX package at its top: the ranks
import it by name.  The inputs are numpy arrays, handed to both packages;
the SLQ probes are numpy signs.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.models import iterative as titer
from approximategps_tpu_torch.utils.bijectors import softplus

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 3
DEADLINE_S = 150  # the worlds' whole run, after which they are killed

M_SVGP, NOISE, JITTER = 8, 0.1, 1e-6
N_MF, P_MF, LANCZOS_MF = 200, 8, 12  # the matrix-free cases
MF_BLOCK, MF_TEST = 16, 23


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _np(t):
    return t.detach().numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- inputs, from numpy ------------------------------------------------------

def _data(N):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 10.0, N)
    return x, np.sin(x) + 0.1 * rng.standard_normal(N)


def _params():
    return {"k": np.array([0.5, 0.5]), "z": np.linspace(0.0, 10.0, M_SVGP),
            "m": np.zeros(M_SVGP), "A": np.eye(M_SVGP)}


def _mf_data():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0.0, 8.0, N_MF))
    return {"x": x, "y": np.sin(x) + 0.3 * rng.standard_normal(N_MF),
            "V": rng.standard_normal((N_MF, 3)),
            "yb": (rng.uniform(size=N_MF) > 0.5).astype(np.float64),
            "probes": rng.choice([-1.0, 1.0], size=(P_MF, N_MF)),
            "c": rng.standard_normal(N_MF),
            "xs": np.linspace(0.5, 7.5, MF_TEST)}


THETA_MF = np.array([1.0, 0.8])  # raw (variance, lengthscale) of the Matérn-5/2 kernel


# -- the port's side: the same cases with and without a mesh ------------------

def _model(p):
    kernel = softplus(p["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                        softplus(p["k"][1]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
    return tgp.SparseVariationalApproximation(f(p["z"], JITTER), q), f


def _elbo_fn(num_data):
    def fn(p, xb, yb):
        sva, f = _model(p)
        return tgp.elbo(sva, f(xb, NOISE), yb, num_data=num_data)
    return fn


def _leaves():
    return {k: _t(v, grad=True) for k, v in _params().items()}


def _value_grad(v, p):
    return [_np(v)] + [_np(g) for g in torch.autograd.grad(v, list(p.values()))]


def _mf_kernel(theta=None):
    if theta is None:
        return 1.3 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.9)
    return softplus(theta[0]) * tgp.with_lengthscale(tgp.Matern52Kernel(), softplus(theta[1]))


def _cases(mesh) -> dict:
    """Every case, on ``mesh`` (a DataMesh) or on the single-process path
    (None): a dict of lists of numpy arrays."""
    from approximategps_tpu_torch.models.laplace_cg import laplace_lml_cg, newton_inner_loop_cg
    from approximategps_tpu_torch.models.vecchia import _previous_k, _window_rows
    from approximategps_tpu_torch.ops.batched_chol import masked_chol_solve_band_math
    from approximategps_tpu_torch.parallel import (dp_predict_blocks, make_dp_elbo,
                                                   make_dp_train_step, replicated, shard_batch)

    out, counts = {}, []

    # 1–3: the minibatch ELBO, value and gradients, on an even and an uneven batch
    for N in (64, 61):
        x, y = (_t(a) for a in _data(N))
        p = _leaves()
        fn = _elbo_fn(N)
        v = make_dp_elbo(fn, mesh)(p, x, y) if mesh else fn(p, x, y)
        out[f"elbo_{N}"] = _value_grad(v, p)
        # 11: num_data=None, a plain sum over the points
        fn = _elbo_fn(None)
        v = make_dp_elbo(fn, mesh)(p, x, y) if mesh else fn(p, x, y)
        out[f"elbo_sum_{N}"] = [_np(v)]

    # 4: 20 Adam steps
    x, y = (_t(a) for a in _data(64))
    p = {k: _t(v) for k, v in _params().items()}
    loss = lambda q, xb, yb: -_elbo_fn(64)(q, xb, yb)  # noqa: E731
    if mesh:
        step = make_dp_train_step(loss, lambda ls: torch.optim.Adam(ls, lr=1e-2), mesh)
        losses = [step(p, x, y)[1] for _ in range(20)]
    else:
        p, losses = tgp.adam_fit(loss, p, [(x, y)] * 20, learning_rate=1e-2)
    out["train"] = [_np(torch.stack(losses))] + [_np(t) for t in p.values()]

    # 5, 6: the streaming ELBO, value and gradients
    lik = tgp.GaussianLikelihood(NOISE)
    for N, block in ((64, 4), (61, 3)):
        x, y = (_t(a) for a in _data(N))
        p = _leaves()
        sva, _ = _model(p)
        if mesh:
            v = tgp.dp_streaming_elbo(sva, lik, x, y, mesh, block_size=block, num_data=N)
        else:
            v = tgp.streaming_elbo(sva, lik, x, y, block_size=block, num_data=N)
        out[f"stream_{N}"] = _value_grad(v, p)

    # 7: the stretch recipe: one natural-gradient step with lr = 1 lands on the bound
    x, y = (_t(a) for a in _data(61))
    f = tgp.GP(1.3 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.9))
    fz = f(_t(np.linspace(0.0, 10.0, M_SVGP)), 1e-8)

    def elbo_mS(m, S):
        sva = tgp.SparseVariationalApproximation(fz, tgp.MultivariateNormal(
            m, torch.linalg.cholesky(S)))
        if mesh:
            return tgp.dp_streaming_elbo(sva, lik, x, y, mesh, block_size=16, num_data=61)
        return tgp.streaming_elbo(sva, lik, x, y, block_size=16, num_data=61)

    m0, S0 = _t(0.3 * np.ones(M_SVGP), grad=True), _t(2.0 * np.eye(M_SVGP), grad=True)
    e0 = elbo_mS(m0, S0)
    gm, gS = torch.autograd.grad(e0, (m0, S0))
    m1, L1 = tgp.natgrad_update(m0.detach(), torch.linalg.cholesky(S0.detach()), gm, gS, lr=1.0)
    with torch.no_grad():
        e1 = elbo_mS(m1, L1 @ L1.T)
    bound = tgp.vfe_elbo(tgp.VFE(fz), f(x, NOISE), y)
    out["stretch"] = [_np(e0), _np(e1), _np(bound)]

    # 8: serving, 203 points at blocks of 32
    sva, _ = _model({k: _t(v) for k, v in _params().items()})
    post = tgp.posterior(sva)
    xs = _t(np.linspace(-1.0, 11.0, 203))
    mu, var = (dp_predict_blocks(post, xs, mesh, block_size=32) if mesh
               else post.predict_blocks(tgp.core.kernels.as_points(xs), block_size=32))
    out["predict"] = [_np(mu), _np(var)]

    # 9: the matrix-free tier
    d = _mf_data()
    x, y, V = _t(d["x"]), _t(d["y"]), _t(d["V"])
    kern = _mf_kernel()
    for mode in ("plain", "fused"):
        with tgp.config_context(matvec_mode=mode):
            mv = titer.kernel_matvec(kern, x, NOISE, block_size=MF_BLOCK, mesh=mesh)
            out[f"matvec_{mode}"] = [_np(mv(V)), _np(mv(V[:, 0]))]
    theta = _t(THETA_MF, grad=True)
    before = titer.stats["cg_iterations"]
    with tgp.config_context(matvec_mode="fused"):
        v = tgp.logpdf_slq(tgp.GP(_mf_kernel(theta))(x, NOISE), y, probes=_t(d["probes"]),
                           lanczos_iters=LANCZOS_MF, cg_tol=1e-10, mesh=mesh)
        out["slq"] = [_np(v), _np(torch.autograd.grad(v, theta)[0])]
    counts.append(titer.stats["cg_iterations"] - before)
    fx = tgp.GP(kern)(x, NOISE)
    with torch.no_grad():
        out["posterior_cg"] = [_np(a) for a in tgp.posterior_cg(fx, y, tol=1e-10, mesh=mesh)
                               .mean_and_var(_t(d["xs"]))]
    yb, lik_b = _t(d["yb"]), tgp.BernoulliLikelihood()
    for storage in ("chunked", "dense"):
        with tgp.config_context(matvec_mode="fused"):
            f_opt, it = newton_inner_loop_cg(lik_b, yb, kern, x, cg_tol=1e-10, tol=1e-10,
                                             precond_rank=0, block_size=32, storage=storage,
                                             mesh=mesh, return_niter=True)
        out[f"newton_{storage}"] = [_np(f_opt)]
        counts.append(it)
    # the IFT pullback and the SLQ logdet(B) pullback through the bands
    theta = _t(THETA_MF, grad=True)
    with tgp.config_context(matvec_mode="fused"):
        f_opt = newton_inner_loop_cg(lik_b, yb, _mf_kernel(theta), x, cg_tol=1e-10, tol=1e-10,
                                     precond_rank=0, storage="chunked", mesh=mesh)
        out["newton_grad"] = [_np(torch.autograd.grad(f_opt @ _t(d["c"]), theta)[0])]
        v = laplace_lml_cg(lik_b, yb, _mf_kernel(theta), x, probes=_t(d["probes"]),
                           lanczos_iters=LANCZOS_MF, cg_tol=1e-10, tol=1e-10, precond_rank=0,
                           storage="chunked", mesh=mesh)
        out["laplace_lml"] = [_np(v), _np(torch.autograd.grad(v, theta)[0])]

    # 10: Vecchia band rows over the points: this rank's index range
    xv = _t(np.linspace(0.0, 20.0, 64))[:, None]
    kv = tgp.Matern32Kernel()
    nbr, idx = _previous_k(64, 4, xv.device), torch.arange(64)
    sl = shard_batch(mesh, 64, pad=False) if mesh else slice(0, 64)
    out["vecchia_rows"] = [_np(_window_rows(xv, nbr[sl], idx[sl], kv, kv.diag(xv),
                                            masked_chol_solve_band_math)),
                           np.array([sl.start, sl.stop])]
    out["counts"] = [np.array(counts)]
    # rank 0's tensors on every rank
    mine = {"a": torch.full((3,), 1.0 + (mesh.rank if mesh else 0), dtype=torch.float64)}
    out["replicated"] = [_np((replicated(mesh, mine) if mesh else mine)["a"])]
    return out


def _child(rank: int, world: int, port: int, path: str) -> None:
    """One rank: join the gloo world, run every case on its mesh, save.  A
    world of one starts from torchrun's environment variables, as
    ``data_mesh`` reads them."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if world == 1:
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
    try:
        res = _cases(tgp.parallel.data_mesh(device="cpu"))
        torch.save(res, path)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the JAX package's side, on conftest.py's 8 virtual devices ---------------

def _jax_cases() -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    import approximategps_tpu as agp
    from approximategps_tpu.models import iterative as jiter
    from approximategps_tpu.models.laplace_cg import newton_inner_loop_cg
    from approximategps_tpu.models.svgp_streaming import dp_streaming_elbo
    from approximategps_tpu.models.vecchia import approx_root_prec_band
    from approximategps_tpu.parallel import (data_mesh, dp_predict_blocks, make_dp_elbo,
                                             make_dp_train_step, replicated, shard_batch)
    from approximategps_tpu.utils.bijectors import softplus as jsoftplus

    mesh = data_mesh()

    def model(p):
        kernel = jsoftplus(p["k"][0]) * agp.with_lengthscale(agp.SqExponentialKernel(),
                                                             jsoftplus(p["k"][1]))
        f = agp.GP(kernel)
        q = agp.MultivariateNormal(p["m"], jnp.tril(p["A"]))
        return agp.SparseVariationalApproximation(f(p["z"], JITTER), q), f

    def elbo_fn(num_data):
        def fn(p, xb, yb):
            sva, f = model(p)
            return agp.elbo(sva, f(xb, NOISE), yb, num_data=num_data)
        return fn

    params = {k: jnp.asarray(v) for k, v in _params().items()}
    keys = list(params)
    out = {}
    rep = replicated(mesh)
    for N in (64, 61):
        x, y = (jnp.asarray(a) for a in _data(N))
        if N % 8 == 0:  # the mesh splits only a multiple of its size
            bsh = shard_batch(mesh)
            v = make_dp_elbo(elbo_fn(N), mesh)(params, x, y)
            g = jax.jit(jax.grad(elbo_fn(N)), in_shardings=(rep, bsh, bsh), out_shardings=rep)(
                params, jax.device_put(x, bsh), jax.device_put(y, bsh))
        else:
            v, g = jax.value_and_grad(elbo_fn(N))(params, x, y)
        out[f"elbo_{N}"] = [np.asarray(v)] + [np.asarray(g[k]) for k in keys]
        out[f"elbo_sum_{N}"] = [np.asarray(elbo_fn(None)(params, x, y))]

    x, y = (jnp.asarray(a) for a in _data(64))
    opt = optax.adam(1e-2)
    step = make_dp_train_step(lambda p, xb, yb: -elbo_fn(64)(p, xb, yb), opt, mesh,
                              donate=False)
    p, st, losses = params, opt.init(params), []
    for _ in range(20):
        p, st, loss = step(p, st, x, y)
        losses.append(float(loss))
    out["train"] = [np.array(losses)] + [np.asarray(p[k]) for k in keys]

    lik = agp.GaussianLikelihood(NOISE)
    for N, block in ((64, 4), (61, 3)):
        x, y = (jnp.asarray(a) for a in _data(N))

        def dp(p):
            sva, _ = model(p)
            return dp_streaming_elbo(sva, lik, x, y, mesh, block_size=block, num_data=N)

        v, g = jax.jit(jax.value_and_grad(dp))(params)
        out[f"stream_{N}"] = [np.asarray(v)] + [np.asarray(g[k]) for k in keys]

    sva, _ = model(params)
    mu, var = dp_predict_blocks(agp.posterior(sva), jnp.linspace(-1.0, 11.0, 203), mesh,
                                block_size=32)
    out["predict"] = [np.asarray(mu), np.asarray(var)]

    d = _mf_data()
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    kern = 1.3 * agp.with_lengthscale(agp.Matern52Kernel(), 0.9)
    mv = jiter.kernel_matvec(kern, x, NOISE, block_size=MF_BLOCK, mesh=mesh)
    V = jnp.asarray(d["V"])
    out["matvec"] = [np.asarray(mv(V)), np.asarray(mv(V[:, 0]))]

    def lml(theta):
        k_ = jsoftplus(theta[0]) * agp.with_lengthscale(agp.Matern52Kernel(),
                                                        jsoftplus(theta[1]))
        return jiter._logpdf_slq_core(LANCZOS_MF, 1e-10, 1000, None, False, True, True, mesh,
                                      "data", agp.GP(k_)(x, NOISE), y,
                                      jnp.asarray(d["probes"]), None)

    v, g = jax.jit(jax.value_and_grad(lml))(jnp.asarray(THETA_MF))
    out["slq"] = [np.asarray(v), np.asarray(g)]
    post = jiter.posterior_cg(agp.GP(kern)(x, NOISE), y, tol=1e-10, mesh=mesh)
    out["posterior_cg"] = [np.asarray(a) for a in post.mean_and_var(jnp.asarray(d["xs"]))]
    yb = jnp.asarray(d["yb"]).astype(jnp.int32)
    for storage in ("chunked", "dense"):
        f_opt = newton_inner_loop_cg(agp.BernoulliLikelihood(), yb, kern, x, cg_tol=1e-10,
                                     tol=1e-10, precond_rank=0, block_size=32,
                                     storage=storage, mesh=mesh)
        out[f"newton_{storage}"] = [np.asarray(f_opt)]

    U = jax.jit(lambda xs: approx_root_prec_band(xs, 4, agp.Matern32Kernel()),
                out_shardings=shard_batch(mesh))(jnp.linspace(0.0, 20.0, 64))
    out["vecchia_band"] = [np.asarray(U)]
    return out


# -- the worlds --------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"w3": [rank 0's, 1's, 2's], "w1": [rank 0's], "single": ..., "jax":
    ...}: the worlds run while this process computes the rest."""
    d = tmp_path_factory.mktemp("worlds")
    procs = []
    for tag, world in (("w3", WORLD), ("w1", 1)):
        port = _free_port()
        for r in range(world):
            code = (f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]\n"
                    f"import test_torch_parallel as m\n"
                    f"m._child({r}, {world}, {port}, {str(d / f'{tag}_{r}.pt')!r})\n")
            log = open(d / f"{tag}_{r}.log", "w")
            procs.append((f"{tag} rank {r}", d / f"{tag}_{r}.log", log,
                          subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=log,
                                           stderr=subprocess.STDOUT)))
    t0 = time.monotonic()
    try:
        single = _cases(None)
        jax_ref = _jax_cases()
        for name, path, log, proc in procs:
            try:
                proc.wait(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} did not finish in {DEADLINE_S} s:\n"
                            + path.read_text()[-3000:])
            if proc.returncode != 0:
                pytest.fail(f"{name} exited {proc.returncode}:\n" + path.read_text()[-3000:])
    finally:
        for _, _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    load = lambda tag, r: torch.load(d / f"{tag}_{r}.pt", weights_only=False)  # noqa: E731
    return {"w3": [load("w3", r) for r in range(WORLD)], "w1": [load("w1", 0)],
            "single": single, "jax": jax_ref}


def _hold(got, single, jax_ref, rtol_v, rtol_g, atol=0.0):
    """Entry 0 (a value) at ``rtol_v``, the rest at ``rtol_g`` relative to
    their largest entry, against the single-process path and the JAX
    package."""
    for ref in (single, jax_ref):
        for i, (a, b) in enumerate(zip(got, ref)):
            tol = rtol_v if i == 0 else rtol_g
            assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300) + atol, (i, _rel(a, b))


@pytest.mark.parametrize("N", [64, 61])
def test_torch_dp_elbo_value_matches_jax_and_single_process(runs, N):
    """Items 1 and 2: 64 points split 22/21/21, 61 split 21/20/20, unpadded."""
    for res in runs["w3"]:
        _hold(res[f"elbo_{N}"][:1], runs["single"][f"elbo_{N}"][:1], runs["jax"][f"elbo_{N}"][:1],
              1e-10, 1e-10)


@pytest.mark.parametrize("N", [64, 61])
def test_torch_dp_elbo_gradients_match_jax_and_single_process(runs, N):
    """Item 3: no world-size factor in any parameter's gradient."""
    for res in runs["w3"]:
        _hold(res[f"elbo_{N}"], runs["single"][f"elbo_{N}"], runs["jax"][f"elbo_{N}"],
              1e-10, 1e-8, atol=1e-12)


def test_torch_dp_train_step_improves_and_stays_replicated(runs):
    """Item 4: 20 Adam steps improve the loss, match ``adam_fit`` and the JAX
    step with optax, and leave the parameters bitwise equal on every rank."""
    res = runs["w3"]
    losses = res[0]["train"][0]
    assert losses[-1] < losses[0]
    for r in res[1:]:
        for a, b in zip(r["train"], res[0]["train"]):
            assert np.array_equal(a, b)
    _hold(res[0]["train"], runs["single"]["train"], runs["jax"]["train"], 1e-9, 1e-7,
          atol=1e-12)


@pytest.mark.parametrize("N", [64, 61])
def test_torch_dp_streaming_elbo_matches_jax_and_single_process(runs, N):
    """Items 5 and 6: blocks of 4 at 64 points, of 3 at 61 (padded to 63 and
    masked), value and gradients."""
    for res in runs["w3"]:
        _hold(res[f"stream_{N}"], runs["single"][f"stream_{N}"], runs["jax"][f"stream_{N}"],
              1e-9, 1e-7, atol=1e-10)


def test_torch_stretch_recipe_natgrad_step_lands_on_the_bound(runs):
    """Item 7: one natural-gradient step with lr = 1 on the data-parallel
    streaming ELBO lands on the collapsed bound (vfe_elbo) to 1e-8."""
    for res in runs["w3"]:
        e0, e1, bound = (float(a) for a in res["stretch"])
        assert e1 > e0
        assert abs(e1 - bound) <= 1e-8 * abs(bound)
        assert _rel(res["stretch"][0], runs["single"]["stretch"][0]) <= 1e-10


def test_torch_dp_predict_blocks_matches_jax_and_single_process(runs):
    """Item 8: 203 test points, which divide neither the world nor the block."""
    for res in runs["w3"]:
        assert res["predict"][0].shape == (203,) and res["predict"][1].shape == (203,)
        for a, b, j in zip(res["predict"], runs["single"]["predict"], runs["jax"]["predict"]):
            assert _rel(a, b) <= 1e-10 and _rel(a, j) <= 1e-10


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_torch_mesh_kernel_matvec_matches_jax_and_single_process(runs, mode):
    """Item 9, the raw matvec: (200, 3) and 1-D, rows in bands of 67 on Gram
    blocks of 16 ("plain") or the cross pass ("fused")."""
    for res in runs["w3"]:
        for a, b, j in zip(res[f"matvec_{mode}"], runs["single"][f"matvec_{mode}"],
                           runs["jax"]["matvec"]):
            assert _rel(a, b) <= 1e-12 and _rel(a, j) <= 1e-12


def test_torch_mesh_logpdf_slq_value_and_gradient_match_jax(runs):
    """Item 9: logpdf_slq's value (1e-9) and θ-gradient (1e-7) on the mesh,
    row 5's cross pass and general pullback, the same probes."""
    for res in runs["w3"]:
        _hold(res["slq"], runs["single"]["slq"], runs["jax"]["slq"], 1e-9, 1e-7)


def test_torch_mesh_posterior_cg_matches_jax(runs):
    """Item 9: posterior_cg's mean (1e-8) and variance (1e-6) at 23 points."""
    for res in runs["w3"]:
        for ref in (runs["single"], runs["jax"]):
            mu, var = ref["posterior_cg"]
            assert _rel(res["posterior_cg"][0], mu) <= 1e-8
            assert np.abs(res["posterior_cg"][1] - var).max() <= 1e-6 * np.abs(var).max() + 1e-10


@pytest.mark.parametrize("storage", ["chunked", "dense"])
def test_torch_mesh_newton_inner_loop_cg_matches_jax(runs, storage):
    """Item 9: the CG-Newton mode at N = 200, the chunked storage on the
    cross pass and the dense one with each rank's row band of K stored."""
    for res in runs["w3"]:
        for ref in (runs["single"], runs["jax"]):
            a, b = res[f"newton_{storage}"][0], ref[f"newton_{storage}"][0]
            assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max() + 1e-9


def test_torch_mesh_laplace_pullbacks_match_single_process(runs):
    """The IFT pullback of the mode and the lml's θ-gradient (the SLQ
    logdet(B) pullback) through the bands equal the single-process path's."""
    for res in runs["w3"]:
        assert _rel(res["newton_grad"][0], runs["single"]["newton_grad"][0]) <= 1e-8
        _hold(res["laplace_lml"], runs["single"]["laplace_lml"], runs["single"]["laplace_lml"],
              1e-10, 1e-8)


def test_torch_vecchia_band_rows_shard_over_points(runs):
    """Item 10: the band rows each rank computes for its index range equal
    that range of the whole band, the port's and the JAX package's."""
    whole, jax_band = runs["single"]["vecchia_rows"][0], runs["jax"]["vecchia_band"][0]
    assert _rel(whole, jax_band) <= 1e-12
    covered = 0
    for res in runs["w3"]:
        rows, (lo, hi) = res["vecchia_rows"]
        assert np.abs(rows - whole[lo:hi]).max() <= 1e-12 * np.abs(whole).max()
        covered += hi - lo
    assert covered == 64


@pytest.mark.parametrize("N", [64, 61])
def test_torch_dp_elbo_without_num_data_differs_by_design(runs, N):
    """Item 11: with ``num_data=None`` the elbo sums its points, and the
    count-weighted combination Σ_r (n_r / n)·f_r is not the whole batch's
    value (JAX's); it is exactly that combination of the ranks' values."""
    from approximategps_tpu_torch.parallel.data_parallel import DataMesh

    x, y = (_t(a) for a in _data(N))
    p = {k: _t(v) for k, v in _params().items()}
    combo = 0.0
    for r in range(WORLD):
        sl = tgp.parallel.shard_batch(DataMesh(None, r, WORLD, torch.device("cpu")), N, pad=False)
        combo += (sl.stop - sl.start) / N * _elbo_fn(None)(p, x[sl], y[sl]).item()
    got = float(runs["w3"][0][f"elbo_sum_{N}"][0])
    whole = float(runs["jax"][f"elbo_sum_{N}"][0])
    assert abs(got - combo) <= 1e-10 * abs(combo)
    assert _rel(runs["single"][f"elbo_sum_{N}"][0], whole) <= 1e-10
    assert abs(got - whole) > 1e-2 * abs(whole)


def test_torch_replicated_hands_every_rank_rank_zeros_tensors(runs):
    """``replicated``: each rank passes its own tensor and gets rank 0's."""
    for res in runs["w3"] + runs["w1"]:
        assert np.array_equal(res["replicated"][0], np.ones(3))


def test_torch_ranks_agree_bitwise_and_take_the_same_branches(runs):
    """Every replicated result is the same bits on every rank, and so are
    the CG iteration and Newton step counts."""
    res = runs["w3"]
    for key in res[0]:
        if key in ("vecchia_rows", "replicated"):
            continue
        for r in res[1:]:
            for a, b in zip(r[key], res[0][key]):
                assert np.array_equal(a, b), key


def test_torch_world_of_one_equals_the_single_process_path(runs):
    """Item 12: a world of one rank gives every entry of the single-process
    path (the bands are all of K, the cross pass in place of the self one)."""
    one, single = runs["w1"][0], runs["single"]
    for key in single:
        for a, b in zip(one[key], single[key]):
            assert a.shape == b.shape and _rel(a, b) <= 1e-11, (key, _rel(a, b))
