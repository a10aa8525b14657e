#!/usr/bin/env python3
"""Smoke run of the PyTorch port's SVGP serving and training paths on one
CUDA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises, and the script exits non-zero):

1. Device: a CUDA device is required; prints the card's name and power
   limit (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN.
2. Build: compiles the port's CUDA kernels (``approximategps_tpu_torch/
   csrc``) with nvcc into ``approximategps_tpu_torch/_build`` and prints
   the seconds it took.
3. Kernel parity: each hand-written kernel against its plain PyTorch
   version on the card, in f64 and in f32 at the shapes its path gives it,
   each error printed beside its limit; then each kernel's time beside the
   plain version's (CUDA events, median).  The kernels: the gram-fused
   (L, L⁻¹) build (A), the epilogue forward (B), its backward (3) and the
   (L, L⁻¹) of a given matrix (4).
4. The slice: a NonCentered SVGP posterior at the bench configuration
   (M = 2048 inducing points, D = 8, SE kernel with raw hyperparameters
   [0.5, 0.5], jitter 1e-6; parameters from numpy with a fixed seed) built
   by ``posterior``, then ``predict_blocks`` over 10^6 test points in
   blocks of 16384.  Asserts that both kernels were launched by that run,
   that the outputs are finite, and that they agree with the plain path on
   the card (f32) and with an f64 reference on a subset; prints the build
   and sweep times of the kernel path and of the plain path.
5. The minibatch training step (``bench.py::headline``): Adam on −``elbo``
   over a fresh minibatch of 8192 gathered on the card from 10^6 points
   (D = 8, M = 2048, SE kernel with lengthscale, noise 0.1, jitter 1e-6,
   ``num_data`` = 10^6, lr 1e-3, the bench's parameters k = [0.5, 0.5],
   z ~ N(0, 1), m = 0, A = I).  Asserts that kernel A runs once a step and
   the epilogue never (the minibatch ELBO declines it, as the JAX package's
   does), that step 1's loss and gradients agree with the plain path (f32)
   and an f64 plain reference, and that 30 steps stay finite; prints the ms
   a step of both paths.
6. The full-data streaming step (``bench.py::full_streaming``): the value
   and gradient of −``streaming_elbo`` over N = 2^20 points (D = 8,
   M = 2048, blocks of 16384, y = sin(x_0), Gaussian likelihood 0.1), with
   phase 4's non-trivial q (the bench's m = 0, A = I make S = 0 and α = 0,
   and with them the W term of kernel 3).  Asserts the exact launch counts
   (kernel 4 once, the epilogue forward and backward once a block) and that
   the gradients agree with the plain path (checkpointed Gram blocks); prints
   the ms a value-and-gradient of both paths.

The line before the last is one JSON object with each kernel's route,
source, launches in the path runs of phases 4-6 (each run with the counts
set to 0 just before it), error and times; the last line is
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
from approximategps_tpu_torch.utils.bijectors import softplus

# every kernel's launch counter, by the name the kernels line gives it
COUNTERS = {
    "gram_chol_inv": panel_chol.gram_chol_inv,
    "svgp_data_epilogue": svgp_epilogue.svgp_data_epilogue,
    "svgp_data_epilogue_bwd": svgp_epilogue.svgp_data_epilogue_bwd,
    "chol_inv": panel_chol.chol_inv,
}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}

SEED = 0
M, D = 2048, 8
N_TEST, BLOCK = 1_000_000, 16384
JITTER = 1e-6
RAW_K = (0.5, 0.5)  # bench.py's raw (variance, lengthscale)
N_DATA, BATCH, LR, STEPS = 1_000_000, 8192, 1e-3, 30  # bench.py::headline
N_STREAM = 1 << 20  # bench.py::full_streaming
NOISE = 0.1
# f32 limits for the training paths, relative to each gradient's largest
# entry: the two paths factor Kuu by different routes (the panel kernels
# against cuSOLVER) and sum over 8192 or 2^20 points in other orders
GRAD_RTOL = 1e-3


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
    """max|a − b| / max|b|; max|a − b| where b is zero (a gradient that
    vanishes, as dz at the bench's m = 0, A = I)."""
    scale = b.double().abs().max().item()
    return max_abs(a, b) / (scale if scale > 0 else 1.0)


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

    # kernel 4, (L, L⁻¹) of a given matrix: the Gram of kernel A's inputs
    # plus jitter, with a small asymmetry (the kernel factors sym(A)); f64
    # at M = 520 with kernel A's limits, f32 at the streaming step's M
    def spd(Z, kmap):
        r2 = tk.pairwise_sq_dist(Z, Z, mode="broadcast")
        A = sig2 * kmap.k_of_r2(r2) + JITTER * torch.eye(Z.shape[0], dtype=Z.dtype, device=dev)
        return A + 1e-7 * torch.triu(torch.ones_like(A), 1)

    for name, kmap in maps.items():
        A64 = spd(Z64, kmap)
        L, J = panel_chol.chol_inv(A64)
        L0, J0 = panel_chol.chol_inv_plain(A64)
        torch.cuda.synchronize()
        eL, eJ = max_abs(L, L0), max_abs(J, J0)
        upper = bool(torch.triu(L, 1).any() or torch.triu(J, 1).any())
        check(eL <= 1e-10 and eJ <= 1e-7 and not upper,
              f"chol_inv f64 M=520 {name}: max|dL| {eL:.3e} <= 1e-10, "
              f"max|dJ| {eJ:.3e} <= 1e-7, zeros above both diagonals")
    for name in ("se", "matern32"):
        A32 = spd(Z32, maps[name])
        L, J = panel_chol.chol_inv(A32)
        L0, _ = panel_chol.chol_inv_plain(A32)
        torch.cuda.synchronize()
        fro = (torch.linalg.norm(L.double() - L0.double()) / torch.linalg.norm(L0.double())).item()
        res = (L.double() @ J.double() - eye).abs().max().item()
        check(fro <= 1e-4 and res <= 1e-3,
              f"chol_inv f32 M={M} {name}: ||dL||_F/||L||_F {fro:.3e} <= 1e-4, "
              f"max|LJ - I| {res:.3e} <= 1e-3")
        if name == "se":
            out["chol_inv"] = {"max_abs_err": max_abs(L, L0)}
    A32 = spd(Z32, se)
    out["chol_inv"]["ms"] = cuda_ms(lambda: panel_chol.chol_inv(A32), 10)
    out["chol_inv"]["plain_ms"] = cuda_ms(lambda: panel_chol.chol_inv_plain(A32), 10)
    print(f"time chol_inv f32 M={M}: kernel {out['chol_inv']['ms']:.3f} ms, "
          f"plain {out['chol_inv']['plain_ms']:.3f} ms")

    # kernel 3, the epilogue's pullback, against the closed-form plain
    # version: the relative error max|d| / max|plain| of each cotangent.
    # f64 1e-9; f32 1e-3 (sums over 2048 rows and 16384 points in other
    # orders, with signed cotangents that cancel)
    def bwd_inputs(m, b, dtype):
        Xs, Zs, Se, ae = epilogue_inputs(m, b, dtype)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        return Xs, Zs, Se, ae, t(rng.standard_normal(b)), t(rng.standard_normal(b))

    names = ("Xs_bar", "Zs_bar", "Se_bar", "ae_bar")

    def bwd_errors(args, kmap):
        got = svgp_epilogue.svgp_data_epilogue_bwd(*args, kmap)
        ref = svgp_epilogue.svgp_data_epilogue_bwd_plain(*args, kmap)
        torch.cuda.synchronize()
        return [rel_err(g, r) for g, r in zip(got, ref)], max(max_abs(g, r) for g, r in zip(got, ref))

    bargs64 = bwd_inputs(520, 4001, torch.float64)
    for name, kmap in maps.items():
        errs, _ = bwd_errors(bargs64, kmap)
        check(max(errs) <= 1e-9, f"svgp_data_epilogue_bwd f64 M=520 B=4001 {name}: rel err "
              + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)) + " <= 1e-9")
    bargs32 = bwd_inputs(M, BLOCK, torch.float32)
    for name in ("se", "matern52"):
        errs, worst = bwd_errors(bargs32, maps[name])
        check(max(errs) <= 1e-3, f"svgp_data_epilogue_bwd f32 M={M} B={BLOCK} {name}: rel err "
              + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)) + " <= 1e-3")
        if name == "se":
            out["svgp_data_epilogue_bwd"] = {"max_abs_err": worst}
    out["svgp_data_epilogue_bwd"]["ms"] = cuda_ms(
        lambda: svgp_epilogue.svgp_data_epilogue_bwd(*bargs32, se), 5)
    out["svgp_data_epilogue_bwd"]["plain_ms"] = cuda_ms(
        lambda: svgp_epilogue.svgp_data_epilogue_bwd_plain(*bargs32, se), 5)
    print(f"time svgp_data_epilogue_bwd f32 M={M} B={BLOCK}: "
          f"kernel {out['svgp_data_epilogue_bwd']['ms']:.3f} ms, "
          f"plain {out['svgp_data_epilogue_bwd']['plain_ms']:.3f} ms")
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
        # the serving path, counted
        reset_counts()
        post = build_posterior(tparams)
        mu, var = post.predict_blocks(xs, block_size=BLOCK)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"slice launches: {launches}")
        n_blocks = -(-N_TEST // BLOCK)
        check(launches == {"gram_chol_inv": 1, "svgp_data_epilogue": n_blocks,
                           "svgp_data_epilogue_bwd": 0, "chol_inv": 0},
              f"the posterior build launched kernel A once and the sweep kernel B "
              f"{n_blocks} times")
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


def bench_sva(p: dict):
    """The SVGP of ``bench.py``'s losses: σ² = softplus(k[0]), lengthscale
    softplus(k[1]), SE kernel, inducing jitter 1e-6, q = N(m, tril(A)),
    NonCentered; returns (sva, f)."""
    kernel = softplus(p["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                        softplus(p["k"][1]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
    return tgp.SparseVariationalApproximation(f(p["z"], JITTER), q), f


def minibatch_loss(p: dict, xb, yb):
    """``bench.py::_svgp_loss_fn``: −elbo on a minibatch, num_data = 10^6."""
    sva, f = bench_sva(p)
    return -tgp.elbo(sva, f(xb, NOISE), yb, num_data=N_DATA)


def leaf_params(params: dict, dev, dtype) -> dict:
    return {k: v.requires_grad_() for k, v in
            convert.from_jax_params(params, device=dev, dtype=dtype).items()}


def value_and_grad(loss_fn, p: dict, *args):
    loss = loss_fn(p, *args)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def check_grads(what: str, v, g, v_ref, g_ref, limit: float) -> None:
    errs = {k: rel_err(g[k], g_ref[k]) for k in g}
    ev = abs(v.double().item() - v_ref.double().item()) / abs(v_ref.double().item())
    check(ev <= limit and max(errs.values()) <= limit,
          f"{what}: rel err loss {ev:.3e}, " + ", ".join(f"d{k} {e:.3e}" for k, e in errs.items())
          + f" <= {limit:g}")


def phase_minibatch(dev) -> dict:
    rng = np.random.default_rng(SEED + 2)
    params = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)), "m": np.zeros(M),
              "A": np.eye(M)}  # bench.py::_svgp_params
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((N_DATA, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + NOISE * torch.randn((N_DATA,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, N_DATA, (BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    # step 1's loss and gradients: the kernel path against the plain path
    # (f32) and an f64 plain reference, at the bench's parameters (where the
    # loss does not depend on z: α = 0 and S = 0) and at phase 4's
    # non-trivial q, which reaches every term of the pullbacks
    xb, yb = next(batches(1))
    for what, ps in (("bench q", params), ("non-trivial q", slice_params())):
        v, g = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb)
        with tgp.config_context(use_kernels=False):
            vp, gp = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb)
            v64, g64 = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float64),
                                      xb.double(), yb.double())
        check_grads(f"minibatch step 1 ({what}), kernels vs plain path f32", v, g, vp, gp,
                    GRAD_RTOL)
        check_grads(f"minibatch step 1 ({what}), kernels vs f64 plain reference", v, g, v64, g64,
                    GRAD_RTOL)

    # the training path, counted: adam_fit over fresh minibatches
    p = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
    reset_counts()
    p, losses = tgp.adam_fit(minibatch_loss, p, batches(STEPS), learning_rate=LR)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"minibatch launches over {STEPS} steps: {launches}")
    check(launches == {"gram_chol_inv": STEPS, "svgp_data_epilogue": 0,
                       "svgp_data_epilogue_bwd": 0, "chol_inv": 0},
          f"kernel A launched once a step, the epilogue never ({STEPS} steps)")
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all())
                                                     for t in p.values()),
          f"{STEPS} Adam steps: losses and parameters finite "
          f"(loss {losses[0].item():.6g} -> {losses[-1].item():.6g})")

    for label, use in (("kernels", True), ("plain", False)):
        with tgp.config_context(use_kernels=use):
            q = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
            reps = 10
            ms = cuda_ms(lambda: tgp.adam_fit(minibatch_loss, q, batches(reps), LR), 3) / reps
        print(f"time minibatch step ({label}): {ms:.3f} ms a step (Adam, B={BATCH}, M={M}, "
              f"fresh gather from N={N_DATA})")
    return launches


def phase_streaming(dev) -> dict:
    params = slice_params()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((N_STREAM, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0])
    lik = tgp.GaussianLikelihood(NOISE)

    def loss_fn(p):
        sva, _ = bench_sva(p)
        return -tgp.streaming_elbo(sva, lik, x, y, block_size=BLOCK)

    n_blocks = N_STREAM // BLOCK
    reset_counts()
    v, g = value_and_grad(loss_fn, leaf_params(params, dev, torch.float32))
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"streaming launches: {launches}")
    check(launches == {"gram_chol_inv": 0, "svgp_data_epilogue": n_blocks,
                       "svgp_data_epilogue_bwd": n_blocks, "chol_inv": 1},
          f"kernel 4 launched once, the epilogue forward and backward {n_blocks} times each")
    check(bool(torch.isfinite(v)) and all(bool(torch.isfinite(t).all()) for t in g.values()),
          "streaming value and gradients finite")
    with tgp.config_context(use_kernels=False):
        vp, gp = value_and_grad(loss_fn, leaf_params(params, dev, torch.float32))
    check_grads(f"streaming step N={N_STREAM}, kernels vs plain path f32", v, g, vp, gp,
                GRAD_RTOL)
    for label, use in (("kernels", True), ("plain", False)):
        with tgp.config_context(use_kernels=use):
            q = leaf_params(params, dev, torch.float32)
            ms = cuda_ms(lambda: value_and_grad(loss_fn, q), 3)
        print(f"time streaming value and gradient ({label}): {ms:.3f} ms "
              f"(N={N_STREAM}, {n_blocks} blocks of {BLOCK}, M={M})")
    return launches


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    numbers = phase_parity(dev)
    by_path = {
        "serving": phase_slice(dev),
        "minibatch": phase_minibatch(dev),
        "streaming": phase_streaming(dev),
    }
    meta = {
        "gram_chol_inv": ("approximategps_tpu_torch/csrc/gram_chol_inv.cu",
                          "approximategps_tpu/ops/panel_chol.py:405"),
        "svgp_data_epilogue": ("approximategps_tpu_torch/csrc/svgp_epilogue.cu",
                               "approximategps_tpu/ops/svgp_epilogue.py:201"),
        "svgp_data_epilogue_bwd": ("approximategps_tpu_torch/csrc/svgp_epilogue_bwd.cu",
                                   "approximategps_tpu/ops/svgp_epilogue.py:271"),
        "chol_inv": ("approximategps_tpu_torch/csrc/gram_chol_inv.cu",
                     "approximategps_tpu/ops/panel_chol.py:338"),
    }
    kernels = []
    for k, (src, rep) in meta.items():
        per_path = {path: counts[k] for path, counts in by_path.items()}
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(per_path.values()), "launches_by_path": per_path,
                        **numbers[k]})
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched by a path run")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
