#!/usr/bin/env python
"""Model selection and robust regression on the PyTorch port (the twin of
``examples/f_model_selection.py``):

1. ML against MAP hyperparameter selection (lognormal hyperpriors) of the
   Laplace-Bernoulli model on the reference's fixed dataset, by
   ``lbfgs_fit``.
2. Robust regression with a Student-t likelihood through the
   Gauss–Newton/Fisher Laplace surrogate, against a Gaussian likelihood on
   outlier-contaminated data.

f32 on the card, f64 on the CPU.  Runs on the card unless
``main(device="cpu")`` asks for the CPU."""

import _common
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import test_utils as tu
from approximategps_tpu_torch.utils.priors import lognormal_prior, map_objective
from approximategps_tpu_torch.utils.training import lbfgs_fit


def main(N=120, n_outliers=12, lbfgs_iters=150, seed=3, device=None):
    dev = _common.resolve_device(device)
    dtype = _common.working_dtype(dev)
    like = dict(dtype=dtype, device=dev)
    print(f"device: {dev}, dtype: {dtype}")

    # 1. ML vs MAP hyperparameter selection (Laplace-Bernoulli, the reference's data)
    X, Y = tu.generate_data(device=dev, dtype=dtype)

    def neg_lml(raw):
        theta = torch.stack([raw["variance"], raw["lengthscale"]])
        lf = tu.build_latent_gp(theta)  # softplus-constrains both
        return -tgp.approx_lml(tgp.LaplaceApproximation(), lf(X), Y)

    def raw0():
        return {"variance": torch.tensor(0.0, **like), "lengthscale": torch.tensor(0.5, **like)}

    def sp(t):
        return float(torch.nn.functional.softplus(t.detach()))

    ml_raw, ml_loss, ml_n = lbfgs_fit(neg_lml, raw0(), max_iters=lbfgs_iters)
    print("\nML  optimum: variance %.4f  lengthscale %.4f  (-lml %.5f, %d iters)"
          % (sp(ml_raw["variance"]), sp(ml_raw["lengthscale"]), ml_loss, ml_n))
    priors = {"variance": lognormal_prior(0.0, 1.0), "lengthscale": lognormal_prior(0.0, 1.0)}
    map_raw, map_loss, map_n = lbfgs_fit(map_objective(neg_lml, priors), raw0(),
                                         max_iters=lbfgs_iters)
    print("MAP optimum: variance %.4f  lengthscale %.4f  (-map %.5f, %d iters)"
          % (sp(map_raw["variance"]), sp(map_raw["lengthscale"]), map_loss, map_n))
    # the hyperprior must regularize: MAP variance < ML variance
    assert sp(map_raw["variance"]) < sp(ml_raw["variance"])

    # 2. robust Student-t regression on outlier-contaminated data
    gen = _common.cpu_generator(seed)
    x = torch.sort(6.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values
    f_true = torch.sin(x) + 0.5 * torch.cos(2.0 * x)
    y = f_true + 0.1 * torch.randn(N, generator=gen, dtype=torch.float64)
    out_idx = torch.randperm(N, generator=gen)[:n_outliers]
    sign = 2.0 * torch.randint(0, 2, (n_outliers,), generator=gen, dtype=torch.float64) - 1.0
    y[out_idx] += sign * (2.0 + 2.0 * torch.rand(n_outliers, generator=gen, dtype=torch.float64))

    xj, yj, f_true = x.to(**like), y.to(**like), f_true.to(**like)
    f = tgp.GP(1.0 * tgp.with_lengthscale(tgp.Matern52Kernel(), 0.7))
    jitter = 1e-4 if dtype == torch.float32 else 1e-10
    models = {
        "gaussian": tgp.GaussianLikelihood(torch.tensor(0.1 ** 2, **like)),
        "student-t (GGN fisher)": tgp.GaussNewtonLikelihood(
            tgp.StudentTLikelihood(torch.tensor(3.0, **like), torch.tensor(0.1, **like)),
            mode="fisher"),
    }
    print(f"\nRobust regression: N={N}, {n_outliers} gross outliers")
    rmses = {}
    for name, lik in models.items():
        lfx = tgp.LatentGP(f, lik, jitter)(xj)
        post = tgp.posterior(tgp.LaplaceApproximation(maxiter=300), lfx, yj)
        with torch.no_grad():
            mu = post.mean(xj)
            lml = float(tgp.approx_lml(tgp.LaplaceApproximation(maxiter=300), lfx, yj))
        rmses[name] = float(torch.sqrt(torch.mean((mu - f_true) ** 2)))
        print(f"  {name:24s} posterior-mean RMSE vs truth: {rmses[name]:.4f}   lml: {lml:9.2f}")
    print("\nThe Student-t posterior mean shrugs off the outliers; the Gaussian "
          "one is dragged toward them.")
    assert rmses["student-t (GGN fisher)"] < 0.5 * rmses["gaussian"], rmses
    return rmses


if __name__ == "__main__":
    main()
