#!/usr/bin/env python
"""Regression: stochastic variational GP (SVGP) on N=10,000 points, on the
PyTorch port (the twin of ``examples/a_regression.py``).

Minibatch Adam (``torch.optim.Adam`` through ``adam_fit``, optax's
defaults) on the kernel hyperparameters, the inducing inputs and the
Centered variational distribution, over a fresh permutation each epoch.
Runs on the card unless ``main(device="cpu")`` asks for the CPU."""

import math

import _common
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.utils.bijectors import invsoftplus, softplus


def g(x):
    return (torch.sin(3 * math.pi * x) + 0.3 * torch.cos(9 * math.pi * x)
            + 0.5 * torch.sin(7 * math.pi * x))


def make_kernel(k_params):
    return softplus(k_params[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                        softplus(k_params[1]))


def train(x, y, M, batch_size, perms, lik_noise=0.3):
    """The Centered SVGP with inducing inputs ``x[:M]``, trained by Adam
    (lr 0.01) on the minibatches of each permutation in ``perms`` (one an
    epoch; a tail short of ``batch_size`` is dropped); returns (params, the
    losses, the posterior)."""
    like = dict(dtype=x.dtype, device=x.device)
    N = x.shape[0]
    params = {
        "k": invsoftplus(torch.tensor([1.3, 0.3], **like)),
        "z": x[:M].clone(),
        "m": torch.zeros(M, **like),
        "A": torch.eye(M, **like),
    }
    jitter = 1e-5

    def make_approx(params, xb):
        f = tgp.GP(make_kernel(params["k"]))
        fz = f(params["z"], jitter)
        q = tgp.MultivariateNormal(params["m"], torch.tril(params["A"]))
        return tgp.SparseVariationalApproximation(fz, q, tgp.Centered()), f(xb, lik_noise)

    def loss(params, xb, yb):
        sva, fx = make_approx(params, xb)
        return -tgp.elbo(sva, fx, yb, num_data=N)

    def batches():
        for perm in perms:
            steps = perm.shape[0] // batch_size
            for idx in perm[:steps * batch_size].to(x.device).reshape(steps, batch_size):
                yield x[idx], y[idx]

    params, losses = tgp.adam_fit(loss, params, batches(), learning_rate=0.01)
    with torch.no_grad():
        post = tgp.posterior(make_approx(params, x)[0])
    return params, losses, post


def rmse_vs_truth(post, like) -> float:
    """The posterior mean's RMSE against ``g`` on 200 points of [-1, 1]."""
    with torch.no_grad():
        xt = torch.linspace(-1, 1, 200, **like)
        mu, _ = post.mean_and_var(xt)
        return float(torch.sqrt(torch.mean((mu - g(xt)) ** 2)))


def data(N: int, epochs: int, seed: int):
    """(x, y, one permutation an epoch) on the CPU in f32: the inputs, the
    noise and the shuffles from three streams, as the JAX example splits
    its key."""
    gx, gn, gshuf = _common.split_generators(seed, 3)
    x = 2.0 * torch.rand(N, generator=gx) - 1.0
    y = g(x) + 0.3 * torch.randn(N, generator=gn)
    return x, y, [torch.randperm(N, generator=gshuf) for _ in range(epochs)]


def main(N=10_000, M=20, batch_size=100, epochs=30, lik_noise=0.3, seed=1234, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=torch.float32, device=dev)
    x, y, perms = data(N, epochs, seed)
    params, losses, post = train(x.to(**like), y.to(**like), M, batch_size, perms, lik_noise)
    per_epoch = torch.stack(losses).reshape(epochs, -1).mean(dim=1).tolist()
    for e, v in enumerate(per_epoch):
        if e % 5 == 0 or e == epochs - 1:
            print(f"epoch {e:3d}  -elbo per batch: {v:.2f}")

    rmse = rmse_vs_truth(post, like)
    print(f"posterior-mean RMSE vs true function: {rmse:.4f}")
    assert rmse < 0.2
    return params, post


if __name__ == "__main__":
    main()
