#!/usr/bin/env python3
"""How far the Vecchia kernels' f32 results lie from each other and from
f64, on the windows of ``tests/test_torch_cuda.py``, on one CUDA GPU.

    python3 scripts/f32_spread_vecchia_torch.py

For each (D, k, N) below and each map, no nugget and a nugget with and
without slot k: the band kernel against its plain version in f32 on
``_band_windows`` (``fwd``), and on ``_bwd_windows`` the pullback's x̄w
against the f32 plain version (``bwd``), the kernel against the f64 plain
version (``bwd vs f64``) and the f32 plain version against the f64 one
(``plain32 bwd vs f64``), each the largest relative to the reference's
largest entry.  Run from a tree's root, it measures that tree's kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_cuda as tc  # noqa: E402
from approximategps_tpu_torch.core import kernels as tk  # noqa: E402
from approximategps_tpu_torch.ops import batched_chol  # noqa: E402

CASES = ((2, 33, 301), (3, 33, 301), (1, 32, 1001), (2, 32, 777), (1, 9, 301), (2, 16, 301))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("f32 spread: no CUDA device")
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    maps = {n: c().kernel_map() for n, c in (("se", tk.SqExponentialKernel),
                                             ("m12", tk.Matern12Kernel),
                                             ("m32", tk.Matern32Kernel),
                                             ("m52", tk.Matern52Kernel))}
    for D, k, N in CASES:
        worst = {}
        for name, kmap in maps.items():
            for nugget, self_ in ((None, True), (0.1, False), (0.1, True)):
                nug = None if nugget is None else torch.tensor([nugget], device=dev)
                xw, valid = tc._band_windows(N, D, k, seed=D)
                a = torch.tensor(xw, dtype=f32, device=dev)
                v = torch.tensor(valid, dtype=f32, device=dev)
                got = batched_chol.vecchia_band(a, v, kmap, nug, self_)
                errs = [("fwd", rel(got, batched_chol.vecchia_band_plain(a, v, kmap, nug, self_)))]
                xw, valid = tc._bwd_windows(N, D, k, seed=D)
                a = torch.tensor(xw, dtype=f32, device=dev)
                v = torch.tensor(valid, dtype=f32, device=dev)
                g = torch.tensor(np.random.default_rng(k).standard_normal((N, k + 1)), dtype=f32,
                                 device=dev)
                got_x = batched_chol.vecchia_band_bwd(a, v, kmap, g, nug, self_)[0]
                ref_x = batched_chol._recompute_pullback(a, v, kmap, nug, self_, g, True,
                                                         nug is not None)[0]
                ref64 = batched_chol._recompute_pullback(
                    a.double(), v.double(), kmap, None if nug is None else nug.double(), self_,
                    g.double(), True, nug is not None)[0]
                errs += [("bwd", rel(got_x, ref_x)), ("bwd vs f64", rel(got_x, ref64)),
                         ("plain32 bwd vs f64", rel(ref_x, ref64))]
                for what, e in errs:
                    worst[(what, name)] = max(worst.get((what, name), 0.0), e)
        print(D, k, N, " ".join(f"{a}/{b} {e:.2e}" for (a, b), e in worst.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
