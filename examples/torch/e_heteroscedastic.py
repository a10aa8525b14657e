#!/usr/bin/env python
"""Heteroscedastic SVGP regression on the PyTorch port (the twin of
``examples/e_heteroscedastic.py``): y ~ N(f¹(x), exp(f²(x))) with
independent mean and log-variance latent GPs, trained jointly by Adam
(``adam_fit``) on the tensor-product Gauss–Hermite ELBO.

f32 on the card, f64 on the CPU, as the JAX example keys its dtype off
the backend.  Runs on the card unless ``main(device="cpu")`` asks for the
CPU."""

import itertools

import _common
import numpy as np
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.models.multi_latent import multi_latent_elbo


def main(N=2000, M=32, steps=1500, seed=0, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=_common.working_dtype(dev), device=dev)
    gen = _common.cpu_generator(seed)
    x = torch.linspace(-3.0, 3.0, N, **like)
    true_sd = 0.05 + 0.75 * (x - x.min()) / (x.max() - x.min())
    y = torch.sin(x) + true_sd * torch.randn(N, generator=gen, dtype=torch.float64).to(**like)
    z = torch.linspace(-3.0, 3.0, M, **like)

    def build(params):
        svas = []
        for tag in ("m", "v"):
            k = params[f"k_{tag}"]
            f = tgp.GP(torch.nn.functional.softplus(k[0]) * tgp.with_lengthscale(
                tgp.SqExponentialKernel(), torch.nn.functional.softplus(k[1])))
            q = tgp.MultivariateNormal(params[f"m_{tag}"], torch.tril(params[f"A_{tag}"]))
            svas.append(tgp.SparseVariationalApproximation(f(z, 1e-4), q))
        return tgp.MultiLatentSVGP(tuple(svas), tgp.HeteroscedasticGaussianLikelihood())

    params = {
        "k_m": torch.tensor([0.5, 0.5], **like), "m_m": torch.zeros(M, **like),
        "A_m": torch.eye(M, **like),
        "k_v": torch.tensor([0.5, 1.5], **like), "m_v": torch.full((M,), -1.0, **like),
        "A_v": 0.3 * torch.eye(M, **like),
    }

    def loss(p):
        return -multi_latent_elbo(build(p), x, y, n_gh=10)

    params, vals = tgp.adam_fit(loss, params, itertools.repeat((), steps), learning_rate=2e-2)
    print(f"ELBO: step 0: {-float(vals[0]):.1f} -> step {steps}: {-float(vals[-1]):.1f}")
    assert float(vals[-1]) < float(vals[0]), "ELBO did not improve"

    with torch.no_grad():
        post_mean, post_logvar = tgp.posterior(build(params))
        probes = torch.tensor([-2.5, 0.0, 2.5], **like)
        sd_learned = torch.exp(0.5 * post_logvar.mean(probes))
        sd_true = 0.05 + 0.75 * (probes - x.min()) / (x.max() - x.min())
        mu = post_mean.mean(probes)
    for p, sl, st in zip(probes.tolist(), sd_learned.tolist(), sd_true.tolist()):
        print(f"x={p:+.1f}: learned noise sd {sl:.3f}  (true {st:.3f})")
    print("mean latent at probes:", np.round(mu.cpu().numpy(), 3), " (true sin:",
          np.round(np.sin(probes.cpu().numpy()), 3), ")")
    # the model must learn that the noise grows with x (the heteroscedastic
    # signal) and track the mean latent
    assert float(sd_learned[-1]) > float(sd_learned[0]), sd_learned
    assert bool(torch.all(torch.isfinite(mu)))
    return params


if __name__ == "__main__":
    main()
