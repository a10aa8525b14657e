#!/usr/bin/env python3
"""Smoke run of the PyTorch port's SVGP serving path on one CUDA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises, and the script exits non-zero):

1. Device: a CUDA device is required; prints the card's name and power
   limit (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN.
2. Build: compiles the port's CUDA kernels (``approximategps_tpu_torch/
   csrc``) with nvcc into ``approximategps_tpu_torch/_build`` and prints
   the seconds it took.
3. Kernel parity: each hand-written kernel against its plain PyTorch
   version on the card, in f64 and in f32 at the serving path's shapes,
   each error printed beside its limit; then each kernel's time beside the
   plain version's (CUDA events, median).
4. The slice: a NonCentered SVGP posterior at the bench configuration
   (M = 2048 inducing points, D = 8, SE kernel with raw hyperparameters
   [0.5, 0.5], jitter 1e-6; parameters from numpy with a fixed seed) built
   by ``posterior``, then ``predict_blocks`` over 10^6 test points in
   blocks of 16384.  Asserts that both kernels were launched by that run,
   that the outputs are finite, and that they agree with the plain path on
   the card (f32) and with an f64 reference on a subset; prints the build
   and sweep times of the kernel path and of the plain path.

The line before the last is one JSON object with each kernel's route,
source, launches in the slice's run, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.ops import _build, panel_chol, svgp_epilogue

SEED = 0
M, D = 2048, 8
N_TEST, BLOCK = 1_000_000, 16384
JITTER = 1e-6
RAW_K = (0.5, 0.5)  # bench.py's raw (variance, lengthscale)


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| / max|b|."""
    return max_abs(a, b) / b.double().abs().max().item()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_parity(dev) -> dict:
    """Each kernel against its plain version; returns the numbers for the
    kernels line, taken at the serving path's shapes in f32."""
    rng = np.random.default_rng(SEED + 1)
    maps = {
        "se": tk.SqExponentialKernel().kernel_map(),
        "matern12": tk.Matern12Kernel().kernel_map(),
        "matern32": tk.Matern32Kernel().kernel_map(),
        "matern52": tk.Matern52Kernel().kernel_map(),
    }
    sig2 = 1.3
    out = {}

    # kernel A, f64: L to 1e-10, J to 1e-7 (the inverse's error is amplified
    # by cond(K)); M = 520 is not a multiple of the 64-wide panel
    Z64 = torch.tensor(rng.standard_normal((520, D)) / 0.9, device=dev)
    for name, kmap in maps.items():
        L, J = panel_chol.gram_chol_inv(Z64, sig2, JITTER, kmap)
        L0, J0 = panel_chol.gram_chol_inv_plain(Z64, sig2, JITTER, kmap)
        torch.cuda.synchronize()
        eL, eJ = max_abs(L, L0), max_abs(J, J0)
        upper = bool(torch.triu(L, 1).any() or torch.triu(J, 1).any())
        check(eL <= 1e-10 and eJ <= 1e-7 and not upper,
              f"gram_chol_inv f64 M=520 D={D} {name}: max|dL| {eL:.3e} <= 1e-10, "
              f"max|dJ| {eJ:.3e} <= 1e-7, zeros above both diagonals")

    # kernel A, f32 at the slice's shape: relative Frobenius error of L and
    # the inverse's residual |L J - I|
    Z32 = torch.tensor(rng.standard_normal((M, D)), dtype=torch.float32, device=dev)
    eye = torch.eye(M, dtype=torch.float64, device=dev)
    for name in ("se", "matern32"):
        L, J = panel_chol.gram_chol_inv(Z32, sig2, JITTER, maps[name])
        L0, _ = panel_chol.gram_chol_inv_plain(Z32, sig2, JITTER, maps[name])
        torch.cuda.synchronize()
        fro = (torch.linalg.norm(L.double() - L0.double()) / torch.linalg.norm(L0.double())).item()
        res = (L.double() @ J.double() - eye).abs().max().item()
        check(fro <= 1e-4 and res <= 1e-3,
              f"gram_chol_inv f32 M={M} D={D} {name}: ||dL||_F/||L||_F {fro:.3e} <= 1e-4, "
              f"max|LJ - I| {res:.3e} <= 1e-3")
        if name == "se":
            out["gram_chol_inv"] = {"max_abs_err": max_abs(L, L0)}
    se = maps["se"]
    out["gram_chol_inv"]["ms"] = cuda_ms(
        lambda: panel_chol.gram_chol_inv(Z32, sig2, JITTER, se), 10)
    out["gram_chol_inv"]["plain_ms"] = cuda_ms(
        lambda: panel_chol.gram_chol_inv_plain(Z32, sig2, JITTER, se), 10)
    print(f"time gram_chol_inv f32 M={M}: kernel {out['gram_chol_inv']['ms']:.3f} ms, "
          f"plain {out['gram_chol_inv']['plain_ms']:.3f} ms")

    def epilogue_inputs(m, b, dtype):
        R = rng.standard_normal((m, m)) / math.sqrt(m)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        return (t(rng.standard_normal((b, D))), t(rng.standard_normal((m, D))),
                t(R @ R.T + 0.1 * np.eye(m)), t(rng.standard_normal(m)))

    # kernel B, f64: 1e-9 absolute; M and B ragged against every tile
    args64 = epilogue_inputs(520, 4001, torch.float64)
    for name, kmap in maps.items():
        mu, var = svgp_epilogue.svgp_data_epilogue(*args64, kmap)
        mu0, var0 = svgp_epilogue.svgp_data_epilogue_plain(*args64, kmap)
        torch.cuda.synchronize()
        e = max(max_abs(mu, mu0), max_abs(var, var0))
        check(e <= 1e-9, f"svgp_data_epilogue f64 M=520 B=4001 {name}: max abs err {e:.3e} <= 1e-9")

    # kernel B, f32 at the slice's block: max|d| / max|plain| <= 1e-4
    args32 = epilogue_inputs(M, BLOCK, torch.float32)
    for name in ("se", "matern52"):
        mu, var = svgp_epilogue.svgp_data_epilogue(*args32, maps[name])
        mu0, var0 = svgp_epilogue.svgp_data_epilogue_plain(*args32, maps[name])
        torch.cuda.synchronize()
        emu, evar = rel_err(mu, mu0), rel_err(var, var0)
        check(emu <= 1e-4 and evar <= 1e-4,
              f"svgp_data_epilogue f32 M={M} B={BLOCK} {name}: rel err mu {emu:.3e}, "
              f"var {evar:.3e} <= 1e-4")
        if name == "se":
            out["svgp_data_epilogue"] = {"max_abs_err": max(max_abs(mu, mu0), max_abs(var, var0))}
    out["svgp_data_epilogue"]["ms"] = cuda_ms(
        lambda: svgp_epilogue.svgp_data_epilogue(*args32, se), 10)
    out["svgp_data_epilogue"]["plain_ms"] = cuda_ms(
        lambda: svgp_epilogue.svgp_data_epilogue_plain(*args32, se), 10)
    print(f"time svgp_data_epilogue f32 M={M} B={BLOCK}: "
          f"kernel {out['svgp_data_epilogue']['ms']:.3f} ms, "
          f"plain {out['svgp_data_epilogue']['plain_ms']:.3f} ms")
    return out


def slice_params() -> dict:
    """bench.py's configuration with a non-trivial q: the bench's own m = 0,
    A = I give S = 0 and α = 0, which a kernel returning zeros would match."""
    rng = np.random.default_rng(SEED)
    return {
        "k": np.array(RAW_K),
        "z": rng.standard_normal((M, D)),
        "m": 0.3 * rng.standard_normal(M),
        "A": 0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M))),
    }


def build_posterior(tparams: dict):
    """The serving posterior, built as ``bench.py`` builds it."""
    return convert.build_posterior_from_bench_params(tparams, JITTER)


def phase_slice(dev) -> dict:
    params = slice_params()
    tparams = convert.from_jax_params(params, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn((N_TEST, D), generator=gen, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()

    with torch.no_grad():
        # the main path, counted
        panel_chol.gram_chol_inv.launches = 0
        svgp_epilogue.svgp_data_epilogue.launches = 0
        post = build_posterior(tparams)
        mu, var = post.predict_blocks(xs, block_size=BLOCK)
        torch.cuda.synchronize()
        launches = {
            "gram_chol_inv": panel_chol.gram_chol_inv.launches,
            "svgp_data_epilogue": svgp_epilogue.svgp_data_epilogue.launches,
        }
        print(f"slice launches: {launches}")
        check(all(n > 0 for n in launches.values()),
              "both kernels launched by the posterior build and the sweep")
        check(mu.shape == var.shape == (N_TEST,), f"outputs of shape ({N_TEST},)")
        check(bool(torch.isfinite(mu).all() and torch.isfinite(var).all()),
              f"mean and variance finite at all {N_TEST} test points")
        check(bool((var > 0).all()), "posterior variance positive")
        check(post.cache.S_corr is not None and bool(post.cache.S_corr.abs().max() > 0),
              "the S-correction cache is non-zero")

        # the same posterior through the plain path on the card
        sub = xs[:BLOCK]
        with tgp.config_context(use_kernels=False):
            post_plain = build_posterior(tparams)
            mu_p, var_p = post_plain.mean_and_var(sub)
        emu, evar = rel_err(mu[:BLOCK], mu_p), rel_err(var[:BLOCK], var_p)
        check(emu <= 1e-4 and evar <= 1e-4,
              f"slice vs plain path f32, {BLOCK} points: rel err mu {emu:.3e}, var {evar:.3e} <= 1e-4")
        # and an f64 reference on a subset: max|d| / max|ref|
        with tgp.config_context(use_kernels=False):
            post64 = build_posterior(
                convert.from_jax_params(params, device=dev, dtype=torch.float64))
            mu64, var64 = post64.mean_and_var(sub[:4096].double())
        emu, evar = rel_err(mu[:4096], mu64), rel_err(var[:4096], var64)
        check(emu <= 1e-3 and evar <= 1e-3,
              f"slice vs f64 reference, 4096 points: rel err mu {emu:.3e}, var {evar:.3e} <= 1e-3")
        print(f"mu range [{mu.min().item():.4g}, {mu.max().item():.4g}], "
              f"var range [{var.min().item():.4g}, {var.max().item():.4g}]")

        # times: posterior build and the 10^6-point sweep, kernels and plain
        times = {}
        for label, use in (("kernels", True), ("plain", False)):
            with tgp.config_context(use_kernels=use):
                p = build_posterior(tparams)
                times[label] = {
                    "build_ms": cuda_ms(lambda: build_posterior(tparams), 5),
                    "sweep_ms": cuda_ms(lambda: p.predict_blocks(xs, block_size=BLOCK), 3),
                }
            print(f"time slice ({label}): posterior build {times[label]['build_ms']:.3f} ms, "
                  f"sweep of {N_TEST} points {times[label]['sweep_ms']:.3f} ms")
    return launches


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    numbers = phase_parity(dev)
    launches = phase_slice(dev)
    meta = {
        "gram_chol_inv": ("approximategps_tpu_torch/csrc/gram_chol_inv.cu",
                          "approximategps_tpu/ops/panel_chol.py:405"),
        "svgp_data_epilogue": ("approximategps_tpu_torch/csrc/svgp_epilogue.cu",
                               "approximategps_tpu/ops/svgp_epilogue.py:201"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **numbers[k]}
        for k, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
