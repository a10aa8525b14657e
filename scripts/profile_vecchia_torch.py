#!/usr/bin/env python3
"""Where the time of the PyTorch port's Vecchia serving and training paths
goes, on one CUDA GPU.

    python3 scripts/profile_vecchia_torch.py

Builds ``chip_smoke.py``'s phase-8 configurations (the band build on
linspace(0, 10^6) with a bare Matérn-3/2 and k = 32; ``predict_knn`` over
10^6 training and test points on [0, 1000]^2, lengthscale 5, noise 0.1,
k = 32, tiles of 4096 × 65536) and phase 9 (b)'s training step (the value
and θ-gradient of ``approx_lml`` at N = 10^6 on linspace(0, 10^6), y =
sin(x/3), softplus(0.55)·Matérn-3/2(ℓ = softplus(0.55)), k = 32), runs each
once to warm up, then profiles one band build, one k-NN search alone, one
``predict_knn`` sweep and one training step with ``torch.profiler``: the
device time by kernel name and the device's busy share of the wall time
(``profile_exact_gp_torch.profile``).  Prints the
card's name and power limit first.  Needs a CUDA device (it exits non-zero
without one).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.ops import knn  # noqa: E402
from profile_exact_gp_torch import profile  # noqa: E402


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()

    x = torch.linspace(0.0, float(cs.N_VEC), cs.N_VEC, device=dev)
    kern = tgp.Matern32Kernel()
    build = lambda: tgp.approx_root_prec_band(x, cs.VEC_K, kern)  # noqa: E731
    build()
    profile(f"one band build (N={cs.N_VEC}, k={cs.VEC_K})", build)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    X = cs.SWEEP_SIDE * torch.rand((cs.N_SWEEP, 2), generator=gen, device=dev)
    Xs = cs.SWEEP_SIDE * torch.rand((cs.N_SWEEP, 2), generator=gen, device=dev)
    y = torch.randn((cs.N_SWEEP,), generator=gen, device=dev)
    fx = convert.build_vecchia_fx(
        convert.from_jax_params(cs.SWEEP_THETA, device=dev, dtype=torch.float32), X)
    knn_kw = dict(train_block=cs.SWEEP_TRAIN_BLOCK, test_block=cs.SWEEP_TEST_BLOCK)
    with torch.no_grad():
        search = lambda: knn.knn_search(X, Xs, cs.VEC_K, **knn_kw)  # noqa: E731
        sweep = lambda: tgp.predict_knn(fx, y, Xs, k=cs.VEC_K, **knn_kw)  # noqa: E731
        sweep()
        knn.reset_stats()
        profile(f"one k-NN search (N=N*={cs.N_SWEEP}, k={cs.VEC_K})", search)
        print(f"  search: {knn.stats}")
        knn.reset_stats()
        profile(f"one predict_knn sweep (N=N*={cs.N_SWEEP}, k={cs.VEC_K})", sweep)
        print(f"  search: {knn.stats}")
    del X, Xs, fx

    y = torch.sin(x / 3.0)
    nn = tgp.NearestNeighbors(cs.VEC_K, block_size=cs.VEC_BLOCK)
    step = lambda: cs.lml_value_and_grad(  # noqa: E731
        convert.build_vecchia_fx, cs.VEC_THETA, x, y, nn)
    step()
    profile(f"one training step, vecchia_lml_grad (N={cs.N_VEC}, k={cs.VEC_K})", step)


if __name__ == "__main__":
    sys.exit(main())
