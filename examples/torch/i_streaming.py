#!/usr/bin/env python
"""Streaming sparse GPs (Bui, Nguyen & Turner 2017) on the PyTorch port
(the twin of ``examples/i_streaming.py``): a data stream in chunks, each
round carrying only the online state forward.

1. Gaussian stream, fixed sites: the whitened natural-parameter sites
   (``site_state`` / ``site_update``) telescope to the full-batch optimum.
2. Inducing sites that grow with the observed domain
   (``online_optimal_q``): approximate, tracking the batch refit.
3. A Bernoulli stream: each round a short Adam fit of ``online_elbo``.

f32 on the card, f64 on the CPU.  Runs on the card unless
``main(device="cpu")`` asks for the CPU."""

import _common
import torch

import approximategps_tpu_torch as tgp


def truth(x):
    return torch.sin(x) + 0.25 * torch.cos(3 * x)


def main(N=3000, M=32, rounds=6, seed=0, device=None):
    dev = _common.resolve_device(device)
    dtype = _common.working_dtype(dev)
    like = dict(dtype=dtype, device=dev)
    noise = 0.05
    gen = _common.cpu_generator(seed)
    x64 = torch.sort(12.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values
    y64 = truth(x64) + noise ** 0.5 * torch.randn(N, generator=gen, dtype=torch.float64)
    xj, yj = x64.to(**like), y64.to(**like)
    chunk = N // rounds

    f = tgp.GP(tgp.with_lengthscale(tgp.SqExponentialKernel(), 0.7))
    # f32 needs a healthy inducing jitter: the streaming update recovers the
    # old sites from (S_old, K_old), so its roundoff scales with cond(K_zz)
    jit_z = 1e-3 if dtype == torch.float32 else 1e-10

    # 1. fixed sites: exact streaming regression (pure addition of sites)
    with torch.no_grad():
        z = torch.linspace(0.0, 12.0, M, **like)
        fz = f(z, jit_z)
        st = tgp.site_state(fz)
        for r in range(rounds):
            sl = slice(r * chunk, (r + 1) * chunk)
            st = tgp.site_update(st, f(xj[sl], noise), yj[sl])
            print(f"round {r}: streamed {(r + 1) * chunk} points")
        q_stream = tgp.site_posterior_q(st)
        q_batch = tgp.optimal_variational_posterior(fz, f(xj, noise), yj)
        xs = torch.linspace(0.0, 12.0, 400, **like)
        p_stream = tgp.posterior(tgp.SparseVariationalApproximation(fz, q_stream, tgp.Centered()))
        p_batch = tgp.posterior(tgp.SparseVariationalApproximation(fz, q_batch, tgp.Centered()))
        mu_s = p_stream.mean(xs)
        gap = float(torch.max(torch.abs(mu_s - p_batch.mean(xs))))
    print(f"fixed sites: max |stream - full refit| mean gap = {gap:.2e}")
    assert gap < (1e-3 if mu_s.dtype == torch.float32 else 1e-7), gap

    # 2. sites that grow with the observed domain
    with torch.no_grad():
        state = None
        for r in range(rounds):
            sl = slice(r * chunk, (r + 1) * chunk)
            hi = float(x64[sl.stop - 1])
            fz_r = f(torch.linspace(0.0, max(hi, 0.5), M, **like), jit_z)
            if state is None:
                state = tgp.OnlineSVGPState(fz_r, fz_r.to_mvn())
            q = tgp.online_optimal_q(state, fz_r, f(xj[sl], noise), yj[sl])
            state = tgp.OnlineSVGPState(fz_r, q)
        p_stream = tgp.posterior(tgp.SparseVariationalApproximation(state.fz, state.q,
                                                                   tgp.Centered()))
        rmse = float(torch.sqrt(torch.mean((p_stream.mean(xs) - truth(xs)) ** 2)))
    print(f"moving sites: rmse vs true function = {rmse:.3f}")
    assert rmse < 0.1, rmse

    # 3. non-conjugate stream (Bernoulli, Adam on online_elbo)
    lf = tgp.LatentGP(f, tgp.BernoulliLikelihood(), jit_z)
    p_true = torch.sigmoid(2.0 * torch.sin(x64))
    yb_all = (torch.rand(N, generator=gen, dtype=torch.float64) < p_true).to(**like)
    fz = f(torch.linspace(0.0, 12.0, M, **like), jit_z)
    with torch.no_grad():
        state = tgp.OnlineSVGPState(fz, fz.to_mvn())

    def fit_round(state, xb, yb, steps=150):
        params = [state.q.mean.detach().clone(), state.q.scale_tril.detach().clone()]

        def nloss(p):
            q = tgp.MultivariateNormal(p[0], torch.tril(p[1]))
            sva = tgp.SparseVariationalApproximation(fz, q, tgp.Centered())
            return -tgp.online_elbo(sva, state, lf(xb), yb)

        params, vals = tgp.adam_fit(nloss, params, [()] * steps, learning_rate=5e-2)
        q = tgp.MultivariateNormal(params[0].detach(), torch.tril(params[1].detach()))
        return tgp.OnlineSVGPState(fz, q), float(vals[-1])

    for r in range(rounds):
        sl = slice(r * chunk, (r + 1) * chunk)
        state, nll = fit_round(state, xj[sl], yb_all[sl])
        print(f"bernoulli round {r}: -online_elbo = {nll:.1f}")

    with torch.no_grad():
        p = tgp.posterior(tgp.SparseVariationalApproximation(fz, state.q, tgp.Centered()))
        acc = float(torch.mean(((torch.sigmoid(p.mean(xj)) > 0.5) == (yb_all > 0.5)).float()))
    print(f"bernoulli stream: train accuracy = {acc:.3f}")
    assert acc > 0.75, acc
    print("streaming example ok")


if __name__ == "__main__":
    main()
