#!/usr/bin/env python3
"""Times the matrix-free calls whose pullbacks row 5 carries, for an A/B of
two trees on one card.

    python3 scripts/ab_matrix_free_torch.py TAG

Builds the kernels of the tree it runs in (copy it into another tree's
checkout to time that one), then prints one line ``TAG`` with CUDA-event
medians of 3 after a warm-up (ms): ``laplace_cg_lml``'s value and its value
with the θ-gradient at ``chip_smoke.py`` phase 15's N = 10^5 (16 probes,
rank 512); the product its logdet surrogate differentiates, K(X, X)·V at
R = 16 with θ and V carrying gradients and the points fixed, forward and
pullback (medians of 5); and ``logpdf_slq``'s value and θ-gradient at
phase 7's exact GP (N = 10^5, 16 probes, a carried rank-512 factor); the
card's name and power limit first.  Run the trees in one call, alternating
(A, B, B, A).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.models import iterative  # noqa: E402
from approximategps_tpu_torch.ops import gram_matvec  # noqa: E402


def main(tag: str) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    x, y = convert.laplace_data(cs.N_LAP, cs.D_LAP, seed=cs.SEED + 51, device=dev)
    theta = torch.tensor(convert.LAPLACE_CG_THETA, dtype=torch.float32, device=dev)
    probes = iterative.rademacher_probes(torch.Generator(device=dev).manual_seed(cs.SEED + 52),
                                         cs.LAP_PROBES, cs.N_LAP, torch.float32, dev)
    big = dict(precond_rank=cs.LAP_RANK, block_size=cs.LAP_BLOCK)
    lml_ms = cs.cuda_ms(lambda: cs.lap_lml(theta, x, y, probes, False, **big), 3)
    grad_ms = cs.cuda_ms(lambda: cs.lap_lml(theta, x, y, probes, True, **big), 3)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 53)
    V0 = torch.randn((cs.N_LAP, cs.LAP_PROBES), generator=gen, device=dev)
    W = torch.randn((cs.N_LAP, cs.LAP_PROBES), generator=gen, device=dev)

    def surrogate():
        th, V = theta.clone().requires_grad_(), V0.clone().requires_grad_()
        out = gram_matvec.fused_stationary_matvec(convert.laplace_kernel(th), x)(V)
        return torch.autograd.grad(out, (th, V), W)

    sur_ms = cs.cuda_ms(surrogate, 5)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    xg = 10.0 * torch.rand((cs.N_GP, cs.D_GP), generator=gen, device=dev)
    yg = torch.sin(xg[:, 0]) + 0.1 * torch.randn((cs.N_GP,), generator=gen, device=dev)
    pg = iterative.rademacher_probes(gen, cs.GP_PROBES, cs.N_GP, torch.float32, dev)
    theta0 = convert.from_jax_params(cs.GP_THETA, device=dev, dtype=torch.float32)
    Lk = iterative.pivoted_cholesky(convert.build_exact_fx(theta0, xg).f.kernel, xg, cs.GP_RANK)

    def slq():
        th = theta0.clone().requires_grad_()
        v = -tgp.logpdf_slq(convert.build_exact_fx(th, xg), yg, probes=pg, precond_Lk=Lk,
                            **cs.GP_SLQ)
        return torch.autograd.grad(v, th)[0]

    slq_ms = cs.cuda_ms(slq, 3)
    print(f"{tag}: laplace_cg_lml N={cs.N_LAP} value {lml_ms:.3f} ms, value and θ-gradient "
          f"{grad_ms:.3f} ms; the surrogate's product R={cs.LAP_PROBES} with its pullback "
          f"{sur_ms:.3f} ms; logpdf_slq N={cs.N_GP} value and θ-gradient {slq_ms:.3f} ms "
          f"({cs.CARD})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this tree")
