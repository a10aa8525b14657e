"""Twin ``a`` (``examples/torch/a_regression.py``) against the JAX example's
model and trainer (``examples/a_regression.py``: the Centered SVGP, optax's
Adam at 0.01, one jitted scan an epoch) on the same data and the same
minibatch order, on the CPU.

On a numpy draw at ``scripts/run_examples.py``'s size the two f64 runs are
one run: the per-step losses, the trained parameters and the posterior
mean's RMSE against the true function agree; in f32, as the example runs,
both final RMSEs sit by the same amount from the f64 run's.  On the twin's
own draw at its own size, where the twin's f32 RMSE on the CPU is 0.2023
(over the example's 0.2), the f64 runs agree step for step until rounding
parts them, and a change of x by 1e-13 of itself moves the JAX example's
own final RMSE by more than RMSE_SPREAD: on that draw the example's gate is
passed or missed by rounding, not by how the twin trains.  Run as a script
(``PYTHONPATH=. python tests/test_torch_examples_parity.py``) for both
packages' final RMSEs on that draw under six such changes."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import approximategps_tpu as agp
from approximategps_tpu.utils.bijectors import invsoftplus

ROOT = Path(__file__).resolve().parent.parent
TWINS = ROOT / "examples" / "torch"
if str(TWINS) not in sys.path:
    sys.path.insert(0, str(TWINS))

import run_twins  # noqa: E402

torch.set_num_threads(1)

# Gaps read on the CPU.  Numpy draw (N = 2000, 150 epochs, seed 7): in f64
# the losses of the first two epochs 5.9e-11, the parameters 3.2e-4 of each
# one's largest entry, the RMSE 1.1e-5 relative; in f32 the RMSE 1.2e-2 (the
# port) and 1.0e-2 (the JAX package) from the f64 run's, the parameters
# 8.5e-2 and 2.3e-2.  The twin's draw (N = 10^4, 30 epochs, seed 1234): in
# f64 the first two epochs' losses 1.7e-11; the JAX example's final RMSE
# 0.1331, 0.1734 and 0.1956 with x·(1 + ε), ε = 0, 2e-13, −1e-12
M, BATCH = 20, 100
DRAWS = {"numpy draw, N = 2000": (2000, 150, 7), "the twin's draw, N = 10^4": (10_000, 30, 1234)}
SHORT_STEPS, LOSS_RTOL64, PARAM_RTOL64, RMSE_RTOL64 = 40, 1e-9, 2e-3, 1e-4
RMSE_RTOL32, PARAM_RTOL32 = 3e-2, 2e-1
EPS, RMSE_SPREAD = (0.0, 2e-13, -1e-12), 3e-2


def _jax_example():
    """``examples/a_regression.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location("jax_example_a",
                                                  ROOT / "examples" / "a_regression.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_train(ex, x, y, perms, lik_noise=0.3):
    """The JAX example's model and training loop on given data and
    minibatch order; returns (params, RMSE, the per-step losses)."""
    dt = x.dtype  # the inputs' dtype throughout (the tests enable x64)
    params = {"k": jnp.array([invsoftplus(1.3), invsoftplus(0.3)], dt), "z": x[:M],
              "m": jnp.zeros(M, dt), "A": jnp.eye(M, dtype=dt)}

    def make_approx(params, xb):
        f = agp.GP(ex.make_kernel(params["k"]))
        q = agp.MultivariateNormal(params["m"], jnp.tril(params["A"]))
        return agp.SparseVariationalApproximation(f(params["z"], 1e-5), q, agp.Centered()), \
            f(xb, lik_noise)

    def loss(params, xb, yb):
        sva, fx = make_approx(params, xb)
        return -agp.elbo(sva, fx, yb, num_data=x.shape[0])

    opt = optax.adam(0.01)

    @jax.jit
    def epoch(carry, perm):
        def step(carry, idx):
            params, opt_state = carry
            val, grads = jax.value_and_grad(loss)(params, x[idx], y[idx])
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), val

        return jax.lax.scan(step, carry, perm.reshape(-1, BATCH))

    carry, losses = (params, opt.init(params)), []
    for perm in perms:
        carry, vals = epoch(carry, jnp.asarray(perm))
        losses.append(np.asarray(vals))
    params = carry[0]
    xt = jnp.linspace(-1, 1, 200, dtype=dt)
    mu, _ = agp.posterior(make_approx(params, x)[0]).mean_and_var(xt)
    return {k: np.asarray(v) for k, v in params.items()}, \
        float(jnp.sqrt(jnp.mean((mu - ex.g(xt)) ** 2))), np.concatenate(losses)


def _gaps(a: dict, b: dict) -> dict:
    """Each parameter's max|a − b| over max|b|."""
    return {k: float(np.abs(np.asarray(a[k]) - v).max() / np.abs(v).max()) for k, v in b.items()}


def _draw(which: str, ex, twin):
    """(x, y, perms) in f64 numpy of one of DRAWS."""
    N, epochs, seed = DRAWS[which]
    if which.startswith("numpy"):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1.0, 1.0, N)
        y = np.asarray(ex.g(x)) + 0.3 * rng.standard_normal(N)
        return x, y, [rng.permutation(N) for _ in range(epochs)]
    x, y, perms = twin.data(N, epochs, seed)
    return x.double().numpy(), y.double().numpy(), [p.numpy() for p in perms]


def _runs(ex, twin, x, y, perms, dt) -> dict:
    """Both packages' (params, RMSE, per-step losses) on one draw in ``dt``."""
    jparams, jrmse, jlosses = _jax_train(ex, jnp.asarray(x, dt), jnp.asarray(y, dt), perms)
    tparams, tlosses, post = twin.train(torch.tensor(x.astype(dt)), torch.tensor(y.astype(dt)),
                                        M, BATCH, [torch.tensor(p) for p in perms])
    trmse = twin.rmse_vs_truth(post, dict(dtype=post.cache.Kuu_L.dtype, device="cpu"))
    return {"jax": (jparams, jrmse, jlosses),
            "port": ({k: v.detach().numpy() for k, v in tparams.items()}, trmse,
                     torch.stack(tlosses).numpy())}


def _first_losses_gap(run: dict) -> float:
    (_, _, tl), (_, _, jl) = run["port"], run["jax"]
    return float((np.abs(tl - jl) / np.abs(jl))[:SHORT_STEPS].max())


def test_torch_example_twin_a_trains_as_the_jax_example():
    """The numpy draw: one run in f64, the same distance from it in f32."""
    ex, twin = _jax_example(), run_twins.load("a")
    x, y, perms = _draw("numpy draw, N = 2000", ex, twin)
    r64, r32 = (_runs(ex, twin, x, y, perms, dt) for dt in (np.float64, np.float32))
    (tp, trmse, _), (jp, jrmse, _) = r64["port"], r64["jax"]
    assert _first_losses_gap(r64) <= LOSS_RTOL64, _first_losses_gap(r64)
    assert max(_gaps(tp, jp).values()) <= PARAM_RTOL64, _gaps(tp, jp)
    assert abs(trmse - jrmse) <= RMSE_RTOL64 * jrmse, (trmse, jrmse)
    for who in ("port", "jax"):
        params, rmse, _ = r32[who]
        assert abs(rmse - jrmse) <= RMSE_RTOL32 * jrmse, (who, rmse, jrmse)
        assert max(_gaps(params, jp).values()) <= PARAM_RTOL32, (who, _gaps(params, jp))


def test_torch_example_twin_a_gate_on_its_own_draw_is_set_by_rounding():
    """The twin's own draw: the two f64 runs agree over the first two
    epochs, and x·(1 + ε) at |ε| ≤ 1e-12 moves the JAX example's own final
    RMSE by more than RMSE_SPREAD."""
    ex, twin = _jax_example(), run_twins.load("a")
    x, y, perms = _draw("the twin's draw, N = 10^4", ex, twin)
    r64 = _runs(ex, twin, x, y, perms, np.float64)
    assert _first_losses_gap(r64) <= LOSS_RTOL64, _first_losses_gap(r64)
    rmses = [_jax_train(ex, jnp.asarray(x * (1 + e)), jnp.asarray(y), perms)[1] for e in EPS]
    assert max(rmses) - min(rmses) > RMSE_SPREAD, rmses


if __name__ == "__main__":
    # both packages' final RMSEs on the twin's draw: in f32, and in f64 with
    # x·(1 + ε) for ε = i·1e-13, i = −n/2 … n/2 − 1 (n the first argument,
    # default 6), with how many of the runs miss the example's 0.2
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    ex, twin = _jax_example(), run_twins.load("a")
    x, y, perms = _draw("the twin's draw, N = 10^4", ex, twin)
    r = _runs(ex, twin, x, y, perms, np.float32)
    print(f"f32: RMSE JAX example {r['jax'][1]:.4f}, twin {r['port'][1]:.4f}", flush=True)
    out = {"jax": [], "port": []}
    for i in range(-(n // 2), n - n // 2):
        r = _runs(ex, twin, x * (1 + i * 1e-13), y, perms, np.float64)
        for who in out:
            out[who].append(r[who][1])
        print(f"f64, x·(1 + {i}e-13): RMSE JAX example {r['jax'][1]:.4f}, "
              f"twin {r['port'][1]:.4f}", flush=True)
    for who, v in out.items():
        print(f"{who}: {sum(e >= 0.2 for e in v)} of {n} at or over 0.2, median "
              f"{float(np.median(v)):.4f}, range {min(v):.4f}-{max(v):.4f}")
