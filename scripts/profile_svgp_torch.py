#!/usr/bin/env python3
"""Where the time of the PyTorch port's SVGP serving sweep and streaming
step goes, on one CUDA GPU.

    python3 scripts/profile_svgp_torch.py

Builds ``chip_smoke.py``'s phase-4 posterior (M = 2048, D = 8, SE, a
non-trivial q) and phase-6 streaming loss (N = 2^20 points, blocks of
16384), runs each once to warm up, then profiles one ``predict_blocks`` sweep
over 10^6 points and one value and gradient of −``streaming_elbo`` with
``torch.profiler``: the device time by kernel name and the device's busy
share of the wall time.  Prints the card's name and power limit first.
Needs a CUDA device (it exits non-zero without one).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from profile_exact_gp_torch import profile  # noqa: E402


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    params = cs.slice_params()
    tparams = convert.from_jax_params(params, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    xs = torch.randn((cs.N_TEST, cs.D), generator=gen, device=dev)
    with torch.no_grad():
        post = cs.build_posterior(tparams)

        def sweep():
            return post.predict_blocks(xs, block_size=cs.BLOCK)

        sweep()
        profile(f"sweep of {cs.N_TEST} points", sweep)

    x = torch.randn((cs.N_STREAM, cs.D), generator=gen, device=dev)
    y = torch.sin(x[:, 0])
    lik = tgp.GaussianLikelihood(cs.NOISE)

    def loss_fn(p):
        sva, _ = cs.bench_sva(p)
        return -tgp.streaming_elbo(sva, lik, x, y, block_size=cs.BLOCK)

    def step():
        return cs.value_and_grad(loss_fn, cs.leaf_params(params, dev, torch.float32))

    step()
    profile(f"streaming value and gradient, N={cs.N_STREAM}", step)


if __name__ == "__main__":
    main()
