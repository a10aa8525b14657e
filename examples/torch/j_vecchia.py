#!/usr/bin/env python
"""Vecchia (nearest-neighbour) GPs at scale on the PyTorch port (the twin
of ``examples/j_vecchia.py``):

1. Orderings buy accuracy (small N, exact anchor): on shuffled 2-D inputs,
   a maximin ordering with nearest-predecessor neighbours recovers most of
   the exact log evidence that previous-k in the given order loses.
2. Training at scale: the data maximin-preordered once on the host
   (``resolve_ordering``, the C++ of ``native/`` built by g++ at first
   use), after which previous-k is the banded path; Adam on −lml/N, the
   nugget in the kernel (the precision root ignores the FiniteGP's noise,
   as the reference does).
3. Serving: ``predict_knn`` local kriging over the grid k-NN search.

f32 on the card, f64 on the CPU.  Runs on the card unless
``main(device="cpu")`` asks for the CPU."""

import time

import _common
import numpy as np
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.models.vecchia import predict_knn, resolve_ordering


def _f_true(X):
    """A smooth 2-D test function with O(1) lengthscale structure."""
    return torch.sin(X[:, 0]) * torch.cos(X[:, 1]) + 0.5 * torch.sin(0.7 * X[:, 0])


def ordering_accuracy_demo(N_small, k_small, like, gen):
    """|lml − exact| for previous-k in the given order against
    maximin-nearest conditioning on randomly ordered 2-D points."""
    x = (2.5 * torch.randn((N_small, 2), generator=gen, dtype=torch.float64)).to(**like)
    # the nugget in the kernel (the Vecchia root ignores FiniteGP noise), so
    # the f32 window Cholesky stays well conditioned
    kern = 1.5 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.7)
    fx = tgp.GP(kern + 1e-2 * tgp.WhiteKernel())(x, 0.0)
    y = _f_true(x) + 0.05 * torch.randn(N_small, generator=gen, dtype=torch.float64).to(**like)
    exact = float(fx.logpdf(y))

    err = {}
    for name, nn in {
        "natural+previous (reference behavior)": tgp.NearestNeighbors(k_small),
        "maximin+nearest": tgp.NearestNeighbors(k_small, ordering="maximin",
                                                neighbors="nearest"),
        "maximin+scaled (Schäfer KL pattern)": tgp.NearestNeighbors(k_small, ordering="maximin",
                                                                    neighbors="scaled"),
    }.items():
        err[name] = abs(float(tgp.approx_lml(nn, fx, y)) - exact)
        print(f"[vecchia] k={k_small} |lml-exact| {name}: {err[name]:.2f}")
    e_nat = err["natural+previous (reference behavior)"]
    e_max = err["maximin+nearest"]
    assert e_max < 0.5 * e_nat, (e_max, e_nat)
    print(f"[vecchia] maximin+nearest is {e_nat / max(e_max, 1e-12):.1f}x closer to the exact "
          "evidence at the same k")


def main(N=200_000, Ntest=100_000, k=32, steps=150, N_small=256, k_small=6, side=10.0,
         seed=0, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=_common.working_dtype(dev), device=dev)
    print(f"device: {dev}")
    gen = _common.cpu_generator(seed)

    # 1. orderings buy accuracy (exact anchor at small N)
    with torch.no_grad():
        ordering_accuracy_demo(N_small, k_small, like, gen)

    # 2. train the hyperparameters at scale (banded path)
    X = (side * torch.rand((N, 2), generator=gen, dtype=torch.float64)).to(**like)
    noise_true = 0.1
    y = _f_true(X) + noise_true * torch.randn(N, generator=gen, dtype=torch.float64).to(**like)
    t0 = time.time()
    perm = torch.as_tensor(resolve_ordering(X, "maximin"), device=dev)
    X, y = X[perm], y[perm]
    print(f"[vecchia] maximin preorder of N={N}: {time.time() - t0:.2f}s "
          "(one-time host preprocessing)")

    # block_size bounds the windows' memory at large N
    nn = tgp.NearestNeighbors(k, block_size=None if N <= 20_000 else 16_384)

    def loss(logp):
        var, ls, noise = torch.exp(logp)
        kern = var * tgp.with_lengthscale(tgp.SqExponentialKernel(), ls) \
            + noise * tgp.WhiteKernel()
        return -tgp.approx_lml(nn, tgp.GP(kern)(X, 0.0), y) / N

    logp = torch.log(torch.tensor([0.5, 3.0, 0.3], **like))  # var, ls, noise
    nchunks = 5
    chunk = max(steps // nchunks, 1)
    t0 = time.time()
    logp, vals = tgp.adam_fit(loss, logp, [()] * (nchunks * chunk), learning_rate=5e-2)
    for c in range(nchunks):
        print(f"[vecchia] step {c * chunk:4d}  -lml/N = {float(vals[c * chunk]):.4f}")
    var_h, ls_h, noise_h = (float(v) for v in torch.exp(logp.detach()))
    print(f"[vecchia] {nchunks * chunk} Adam steps on the Vecchia evidence in "
          f"{time.time() - t0:.1f}s: variance {var_h:.3f}, lengthscale {ls_h:.3f}, "
          f"noise sd {np.sqrt(noise_h):.3f} (true {noise_true})")
    # the evidence must separate the noise sd from its 3x-off init
    assert 0.5 * noise_true < np.sqrt(noise_h) < 2.0 * noise_true, noise_h

    # 3. serving: local-kriging prediction through the grid k-NN search
    with torch.no_grad():
        Xs = (side * torch.rand((Ntest, 2), generator=gen, dtype=torch.float64)).to(**like)
        fx = tgp.GP(var_h * tgp.with_lengthscale(tgp.SqExponentialKernel(), ls_h))(X, noise_h)
        t0 = time.time()
        mu, var = predict_knn(fx, y, Xs, k=k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.time() - t0
        rmse = float(torch.sqrt(torch.mean((mu - _f_true(Xs)) ** 2)))
        z2 = float(torch.mean((mu - _f_true(Xs)) ** 2 / (var + noise_h)))
    print(f"[vecchia] predict_knn over {Ntest} test points: {t1:.2f}s "
          f"({1e6 * t1 / Ntest:.1f} us/point), rmse {rmse:.4f} (noise sd {noise_true})")
    assert rmse < noise_true, rmse  # the posterior mean beats the noise floor
    assert bool(torch.all(var > 0)), "non-positive predictive variance"
    print(f"[vecchia] mean standardized residual^2 vs (var + noise): {z2:.2f}")
    assert z2 < 3.0, z2
    print("[vecchia] ok")


if __name__ == "__main__":
    main()
