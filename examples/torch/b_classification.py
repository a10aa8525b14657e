#!/usr/bin/env python
"""Classification: the sparse variational approximation for a
non-conjugate (Bernoulli) likelihood, optimised with L-BFGS, on the
PyTorch port (the twin of ``examples/b_classification.py``).

All parameters (kernel hyperparameters, inducing inputs, variational mean
and Cholesky factor) are optimised jointly with scipy's L-BFGS-B over the
negative ELBO's value and gradient, as the JAX example does.  Runs on the
card unless ``main(device="cpu")`` asks for the CPU."""

import _common
import scipy.optimize
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.utils.bijectors import (
    cholesky_parameter,
    flat_from_tril,
    invsoftplus,
    softplus,
)


def make_kernel(k_params):
    return softplus(k_params[0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                        softplus(k_params[1]))


def main(N=100, M=15, seed=1234, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=torch.float32, device=dev)
    gen = _common.cpu_generator(seed)
    x64 = torch.sort(10.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values
    y64 = _common.latent_gp_labels(gen, x64, 2.0, 1.0)
    x, y = x64.to(**like), y64.to(**like)
    assert 10 < int(y.sum()) < N - 10, "labels should be reasonably balanced"

    init = {
        "k": invsoftplus(torch.tensor([1.0, 1.0], **like)),
        "z": torch.linspace(float(x.min()), float(x.max()), M, **like),
        "m": torch.zeros(M, **like),
        "A_flat": flat_from_tril(torch.eye(M, **like)),
    }
    sizes = [t.numel() for t in init.values()]
    jitter = 1e-6

    def unravel(flat):
        return dict(zip(init, torch.split(flat, sizes)))

    def build_svgp(params):
        f = tgp.GP(make_kernel(params["k"]))
        q = tgp.MultivariateNormal(params["m"], cholesky_parameter(params["A_flat"], M))
        return tgp.SparseVariationalApproximation(f(params["z"], jitter), q), f

    def loss_flat(flat):
        sva, f = build_svgp(unravel(flat))
        lf = tgp.LatentGP(f, tgp.BernoulliLikelihood(), jitter)
        return -tgp.elbo(sva, lf(x), y)

    def fun(flat):
        t = torch.tensor(flat, **like).requires_grad_()
        v = loss_flat(t)
        (g,) = torch.autograd.grad(v, t)
        return v.item(), g.double().cpu().numpy()

    flat0 = torch.cat(list(init.values())).double().cpu().numpy()
    res = scipy.optimize.minimize(fun, flat0, jac=True, method="L-BFGS-B",
                                  options={"maxiter": 150})
    print(f"optimised -elbo: {res.fun:.3f}  ({res.nit} L-BFGS iterations)")

    params = unravel(torch.tensor(res.x, **like))
    with torch.no_grad():
        sva, f = build_svgp(params)
        post = tgp.posterior(sva)
        mu, var = post.mean_and_var(x)
        p_pred = torch.sigmoid(mu / torch.sqrt(1 + torch.pi * var / 8))  # probit-ish squash
    acc = float(((p_pred > 0.5).to(y.dtype) == y).float().mean())
    print(f"training accuracy of posterior mean: {acc:.3f}")
    assert acc > 0.7
    return params, post


if __name__ == "__main__":
    main()
