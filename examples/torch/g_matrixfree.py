#!/usr/bin/env python
"""Matrix-free inference on the PyTorch port (the twin of
``examples/g_matrixfree.py``): CG exact regression with a pivoted-Cholesky
preconditioner, the SLQ log evidence and Adam on it, Matheron pathwise
posterior samples, and CG-Newton Laplace classification, every access to
the N×N kernel matrix a blocked matvec (on the card, the Gram matvec
kernel, row 5).

f32 on the card, f64 on the CPU.  Runs on the card unless
``main(device="cpu")`` asks for the CPU."""

import time

import _common
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.models.iterative import logpdf_slq, posterior_cg
from approximategps_tpu_torch.models.laplace_cg import LaplaceCG
from approximategps_tpu_torch.models.sampling import sample_posterior_functions_cg
from approximategps_tpu_torch.utils.training import make_slq_hyperopt_step


def f_true(t):
    return torch.sin(2 * t) + 0.5 * torch.cos(5 * t)


def main(N=20_000, Nh=5_000, Nc=10_000, block=4096, hyperopt_steps=10, seed=0, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=_common.working_dtype(dev), device=dev)
    print(f"device: {dev}")
    gen = _common.cpu_generator(seed)

    # 1. exact regression via preconditioned CG
    x64 = torch.sort(10.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values[:, None]
    y64 = f_true(x64[:, 0]) + 0.1 * torch.randn(N, generator=gen, dtype=torch.float64)
    x, y = x64.to(**like), y64.to(**like)
    f = tgp.GP(1.0 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.5))
    fx = f(x, 0.01)

    t0 = time.time()
    post = posterior_cg(fx, y, tol=1e-6, block_size=block, precond_rank=32)
    xs = torch.linspace(0, 10, 200, **like)[:, None]
    with torch.no_grad():
        mu, var = post.mean_and_var(xs)
    err = float(torch.max(torch.abs(mu - f_true(xs[:, 0]))))
    print(f"[cg-regression]  N={N}: max |mu - f_true| = {err:.3f} "
          f"({time.time() - t0:.1f}s, rank-32 preconditioner, block {block})")
    assert err < 0.15

    with torch.no_grad():
        lml = float(logpdf_slq(fx, y, generator=torch.Generator(device=dev).manual_seed(0),
                               num_probes=8, lanczos_iters=25, block_size=block))
    print(f"[slq-logpdf]     log p(y) ~= {lml:.1f}")

    # 1b. Adam on -logpdf_slq, the pivoted-Cholesky factor rebuilt every 5 steps
    xh, yh = x[:Nh], y[:Nh]

    def build_fx(theta):
        k = torch.nn.functional.softplus(theta[0]) * tgp.with_lengthscale(
            tgp.SqExponentialKernel(), torch.nn.functional.softplus(theta[1]))
        return tgp.GP(k)(xh, 0.01)

    step, init_c = make_slq_hyperopt_step(
        build_fx, yh, torch.Generator(device=dev).manual_seed(3), learning_rate=0.1,
        precond_rank=32, refresh_every=5, num_probes=8, lanczos_iters=25, cg_tol=1e-6,
        block_size=block)
    t0 = time.time()
    carry = init_c(torch.zeros(2, **like))
    first = last = None
    for _ in range(hyperopt_steps):
        carry, nll = step(carry)
        first = float(nll) if first is None else first
        last = float(nll)
    theta_fit = torch.nn.functional.softplus(carry[0].detach())
    print(f"[slq-hyperopt]   {hyperopt_steps} Adam steps on -logpdf_slq: nll {first:.1f} "
          f"-> {last:.1f}, (var, ls) = ({float(theta_fit[0]):.2f}, {float(theta_fit[1]):.2f}) "
          f"({time.time() - t0:.1f}s, rank-32 refreshed every 5)")
    assert last < first

    # 2. pathwise posterior function samples (Matheron + CG)
    t0 = time.time()
    with torch.no_grad():
        fs = sample_posterior_functions_cg(
            torch.Generator(device=dev).manual_seed(1), fx, y, num_samples=16,
            num_features=2048, tol=1e-6, block_size=block, precond_rank=32)
        samples = fs(xs)  # (16, 200)
    spread = float(torch.mean(samples.std(dim=0)))
    print(f"[pathwise]       16 posterior functions, mean pointwise std {spread:.4f} "
          f"({time.time() - t0:.1f}s)")
    assert bool(torch.all(torch.isfinite(samples)))

    # 3. CG-Newton Laplace classification
    xc = (10.0 * torch.rand((Nc, 1), generator=gen, dtype=torch.float64)).to(**like)
    p_true = torch.sigmoid(3.0 * torch.sin(2.0 * xc[:, 0]))
    yc = (torch.rand(Nc, generator=gen, dtype=torch.float64).to(**like) < p_true).to(torch.int64)
    lfx = tgp.LatentGP(tgp.GP(2.0 * tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.8)),
                       tgp.BernoulliLikelihood(), 1e-6)(xc)
    t0 = time.time()
    la = LaplaceCG(maxiter=20, tol=1e-6, cg_tol=1e-6, block_size=block)
    post_c = tgp.posterior(la, lfx, yc)
    with torch.no_grad():
        mu_c = post_c.mean(xs)
    p_hat = torch.sigmoid(mu_c)
    p_ref = torch.sigmoid(3.0 * torch.sin(2.0 * xs[:, 0]))
    acc = float(torch.mean(((p_hat > 0.5) == (p_ref > 0.5)).float()))
    print(f"[laplace-cg]     N={Nc} Bernoulli: sign agreement with the true latent = "
          f"{acc:.2%} ({time.time() - t0:.1f}s)")
    assert acc > 0.9
    print("matrix-free example OK")


if __name__ == "__main__":
    main()
