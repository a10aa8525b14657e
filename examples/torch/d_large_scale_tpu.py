#!/usr/bin/env python
"""Large-scale training: a Poisson SVGP on N=100,000 points, on the PyTorch
port (the twin of ``examples/d_large_scale_tpu.py``).

Minibatch Adam (``adam_fit``) over epoch permutations, then blocked
prediction over 50,000 points.  The JAX example sets
``gram_mode="mxu", matmul_precision="default"``; here the matmul-identity
distances are ``gram_mode="matmul"`` and the TPU's matmul-pass knob has no
counterpart (the port's products run in f32 with TF32 off), so it is
dropped.  ``solve_mode="inv_matmul"`` forces the (L, L⁻¹) build, which on
the card runs the gram-fused factorization kernel (row 1).  The settings
hold inside ``main`` only.  Runs on the card unless ``main(device="cpu")``
asks for the CPU."""

import time

import _common
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.utils.bijectors import invsoftplus, softplus
from approximategps_tpu_torch.utils.data import epoch_batches


def rate_fn(x):
    return torch.exp(torch.sin(0.4 * x) + 0.5 * torch.cos(1.3 * x))


def main(N=100_000, M=256, batch=8192, epochs=24, seed=0, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=torch.float32, device=dev)
    # the inputs, the counts and the shuffles from three streams, as the JAX
    # example splits its key
    gx, gy, gshuf = _common.split_generators(seed, 3)
    x = (torch.sort(torch.rand(N, generator=gx)).values * 60.0).to(**like)
    y = torch.poisson(rate_fn(x.cpu()), generator=gy).to(**like)
    print(f"N={N} Poisson counts, mean rate {float(y.mean()):.2f}")

    params = {
        "k": invsoftplus(torch.tensor([1.0, 2.0], **like)),
        "z": torch.linspace(0.0, 60.0, M, **like),
        "m": torch.zeros(M, **like),
        "A": torch.eye(M, **like),
    }

    def build(params):
        kern = softplus(params["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                               softplus(params["k"][1]))
        f = tgp.GP(kern)
        fz = f(params["z"], 1e-3)  # f32-appropriate jitter at M inducing points
        q = tgp.MultivariateNormal(params["m"], torch.tril(params["A"]))
        return tgp.SparseVariationalApproximation(fz, q), f

    def loss(params, xb, yb):
        sva, f = build(params)
        lf = tgp.LatentGP(f, tgp.PoissonLikelihood(), 1e-3)
        return -tgp.elbo(sva, lf(xb), yb, num_data=N)

    def batches():
        for _ in range(epochs):
            for idx in epoch_batches(gshuf, N, batch, device=dev):
                yield x[idx], y[idx]

    with tgp.config_context(gram_mode="matmul", solve_mode="inv_matmul"):
        t0 = time.time()
        params, losses = tgp.adam_fit(loss, params, batches(), learning_rate=1e-2)
        per_epoch = torch.stack(losses).reshape(epochs, -1).mean(dim=1).tolist()
        for e, v in enumerate(per_epoch):
            if e % 6 == 0 or e == epochs - 1:
                print(f"epoch {e}: -elbo/batch {v:.1f}")
        print(f"{len(losses)} steps in {time.time() - t0:.1f}s")

        with torch.no_grad():
            sva, f = build(params)
            post = tgp.posterior(sva)
            xt = torch.linspace(0.0, 60.0, 50_000, **like)
            mu, var = tgp.predict_in_blocks(post, xt, block_size=8192)
    pred_rate = torch.exp(mu + var / 2.0)
    rel_err = float(torch.mean(torch.abs(pred_rate - rate_fn(xt)) / rate_fn(xt)))
    print(f"mean relative rate error on 50k test points: {rel_err:.3f}")
    assert rel_err < 0.3
    return params


if __name__ == "__main__":
    main()
