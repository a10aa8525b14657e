#!/usr/bin/env python3
"""Where the time of the PyTorch port's SVGP serving sweep, streaming step
and minibatch training step goes, on one CUDA GPU.

    python3 scripts/profile_svgp_torch.py [sweep] [streaming] [minibatch] [row1]

Builds ``chip_smoke.py``'s phase-4 posterior (M = 2048, D = 8, SE, a
non-trivial q), phase-6 streaming loss (N = 2^20 points, blocks of 16384)
and phase-5 minibatch step (Adam on −``elbo`` over 8192 points gathered
from 10^6, the bench's parameters), runs each once to warm up, then
profiles one ``predict_blocks`` sweep over 10^6 points, one value and
gradient of −``streaming_elbo``, one Adam step, and one call of row 1
(``gram_chol_inv`` at M = 2048, D = 8, f32) alone on each of its two
kernels with ``torch.profiler``:
the device time by kernel name, the device's busy share of the wall time
and, for the last two, the longest idle gaps between device events.  The
arguments pick the parts (all four without any).  Prints the card's name
and power limit first.  Needs a CUDA device (it exits non-zero without
one).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.core import kernels as tk  # noqa: E402
from approximategps_tpu_torch.ops import panel_chol  # noqa: E402
from profile_exact_gp_torch import profile  # noqa: E402

PARTS = ("sweep", "streaming", "minibatch", "row1")


def main(parts) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if "sweep" in parts or "streaming" in parts:
        sweep_and_streaming(dev, parts)
    if "minibatch" in parts:
        minibatch(dev)
    if "row1" in parts:
        row1(dev)


def sweep_and_streaming(dev, parts) -> None:
    params = cs.slice_params()
    tparams = convert.from_jax_params(params, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    xs = torch.randn((cs.N_TEST, cs.D), generator=gen, device=dev)
    with torch.no_grad():
        post = cs.build_posterior(tparams)

        def sweep():
            return post.predict_blocks(xs, block_size=cs.BLOCK)

        if "sweep" in parts:
            sweep()
            profile(f"sweep of {cs.N_TEST} points", sweep)
    if "streaming" not in parts:
        return

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


def minibatch(dev) -> None:
    """One Adam step of phase 5 (``bench.py::headline``)."""
    rng = np.random.default_rng(cs.SEED + 2)
    params = {"k": np.array(cs.RAW_K), "z": rng.standard_normal((cs.M, cs.D)),
              "m": np.zeros(cs.M), "A": np.eye(cs.M)}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    x = torch.randn((cs.N_DATA, cs.D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + cs.NOISE * torch.randn((cs.N_DATA,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, cs.N_DATA, (cs.BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    p = {k: t.detach() for k, t in cs.leaf_params(params, dev, torch.float32).items()}

    def step():
        tgp.adam_fit(cs.minibatch_loss, p, batches(1), learning_rate=cs.LR)

    step()
    profile(f"one minibatch Adam step, B={cs.BATCH}, M={cs.M}", step, top=16, gaps=8)


def row1(dev) -> None:
    """Row 1 alone at the step's shape (M = 2048, D = 8, f32, SE), on both
    kernels: the panel steps ("mma", the path's) and the host loop."""
    Z = torch.tensor(np.random.default_rng(cs.SEED + 1).standard_normal((cs.M, cs.D)),
                     dtype=torch.float32, device=dev)
    sig2 = torch.tensor(1.3, device=dev)  # on the card, as the training step's
    se = tk.SqExponentialKernel().kernel_map()
    for part in ("mma", "loop"):
        def call():
            panel_chol.gram_chol_inv(Z, sig2, cs.JITTER, se, part)

        call()
        profile(f"row 1 ({part}), gram_chol_inv M={cs.M} D={cs.D} f32", call, top=12, gaps=8,
                sequence="step_kernel" if part == "mma" else None)


if __name__ == "__main__":
    asked = [a for a in sys.argv[1:] if a in PARTS]
    if len(asked) != len(sys.argv[1:]):
        sys.exit(f"usage: {sys.argv[0]} [{'] ['.join(PARTS)}]")
    main(asked or PARTS)
