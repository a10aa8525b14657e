#!/usr/bin/env python
"""Binary classification with the Laplace approximation on the PyTorch
port (the twin of ``examples/c_comparisons.py``).

A Bernoulli-logit latent GP: the Laplace posterior at fixed
hyperparameters, then scipy's L-BFGS-B on the Laplace evidence through the
warm-started objective (``build_laplace_objective``), and the posterior
rebuilt at the optimum with Newton warm-started from the objective's
cached mode (``f_init=objective.cache.f``).  Runs on the card unless
``main(device="cpu")`` asks for the CPU."""

import _common
import scipy.optimize
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.utils.bijectors import invsoftplus, softplus


def build_latent_gp(theta):
    kernel = softplus(theta[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                       softplus(theta[1]))
    return tgp.LatentGP(tgp.GP(kernel), tgp.BernoulliLikelihood(), 1e-8)


def main(N=100, seed=1, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=torch.float32, device=dev)
    # data on the host in f64 (an f32 Cholesky of a dense SE Gram with tiny
    # jitter is not safe), then f32 on the device, as the JAX example
    gen = _common.cpu_generator(seed)
    x64 = torch.sort(6.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values
    y64 = _common.latent_gp_labels(gen, x64, 3.0, 0.5)
    x, y = x64.to(**like), y64.to(device=dev, dtype=torch.int64)
    print(f"data: N={N}, positives={int(y.sum())}")
    assert 10 < int(y.sum()) < N - 10, "labels should be reasonably balanced"

    theta0 = invsoftplus(torch.tensor([1.0, 1.0], **like))
    lf0 = build_latent_gp(theta0)
    post0 = tgp.posterior(tgp.LaplaceApproximation(), lf0(x), y)
    lml0 = tgp.approx_lml(tgp.LaplaceApproximation(), lf0(x), y)
    print(f"initial approx_lml: {float(lml0):.3f}")

    objective = tgp.build_laplace_objective(build_latent_gp, x, y)

    def fun(theta):
        v, g = objective.value_and_grad(torch.tensor(theta, **like))
        return float(v), g.double().cpu().numpy()

    res = scipy.optimize.minimize(fun, theta0.double().cpu().numpy(), jac=True,
                                  method="L-BFGS-B", options={"maxiter": 500})
    print(f"optimised theta: {res.x}, -lml: {res.fun:.3f}, "
          f"total Newton steps: {objective.newton_steps}")
    assert -res.fun > float(lml0), "optimisation should improve the evidence"

    # the posterior at the optimum, Newton warm-started from the cached mode
    lf_opt = build_latent_gp(torch.tensor(res.x, **like))
    post = tgp.posterior(tgp.LaplaceApproximation(f_init=objective.cache.f), lf_opt(x), y)

    with torch.no_grad():
        xt = torch.linspace(0, 6, 120, **like)
        # latent draws; the JAX example's jitter 1e-9 is below what an f32
        # Cholesky of this 120-point posterior covariance takes (its f32
        # draws come out NaN, where the port raises), so f32 takes 1e-4
        jitter = 1e-4 if x.dtype == torch.float32 else 1e-9
        samples = post(xt, jitter).sample(torch.Generator(device=dev).manual_seed(7), (8,))
        p_mean = torch.sigmoid(samples).mean(dim=0)
        acc = float(((torch.sigmoid(post.mean(x)) > 0.5).to(y.dtype) == y).float().mean())
    print(f"train accuracy at optimum: {acc:.3f}")
    assert post0 is not None and acc > 0.7
    return post, p_mean


if __name__ == "__main__":
    main()
