#!/usr/bin/env python3
"""Smoke run of the PyTorch port's SVGP serving and training paths, its
matrix-free exact GP, its Vecchia serving and training paths, the Vecchia
tier on prebuilt Grams, the fused Gram, the natural-gradient and Poisson
SVGP steps, block-Vecchia, the Laplace approximation (dense and
matrix-free), pathwise sampling, the multi-latent and online SVGPs and
leave-one-out cross-validation, bf16 projection storage and the large-M
SVGP step, and the twins of the ten examples on one CUDA GPU.

    python3 chip_smoke.py                   # phases 1-23
    python3 chip_smoke.py --examples-full   # phases 1, 2 and 23 at the twins' own sizes

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
   (L, L⁻¹) build (A), the epilogue forward (B, row 2), its backward (3),
   the (L, L⁻¹) of a given matrix (4) and the fused Gram matvec (5).  Rows
   1 and 4 in f32 (the panel steps with look-ahead and 3xTF32 products,
   which f32 takes by dtype; f64 takes the host loop) at M = 2048 on two
   maps, row 4 on the Gram plus the jitter and a small asymmetry, against
   the plain version (‖dL‖_F/‖L‖_F ≤ 1e-4, max|LJ − I| ≤ 1e-3, and both ≤
   ``ROW1_TIGHT32`` = 2e-5, which one or two TF32 products in place of
   three would miss), each twice (equal bitwise), then each and its plain
   version timed beside the tensor-core and the SIMT bound and the time
   before the redesign (``EARLIER_MS``).  Rows
   2 and 3 in f32 on both kernels (the tensor-core one the path takes and
   the SIMT one), every map, at the path's block (2048, 16384, 8) and at
   (2050, 16385, 8) and (150, 1001, 3), against the plain version in f64
   and (D = 8) f32, each run twice (equal bitwise); then both kernels and
   the plain version timed at the path's block beside the tensor-core and
   the SIMT bound.  Row 5: every
   map, g and g′, in f64 at N = 8192, and the self-Gram's one-pass pullback
   in f32 there (R = 1, 16, 48) against the f64 plain pullback; at
   N = M = 10^5, D = 2 in f32 both pass kernels (narrow SIMT, wide tensor
   cores) at R = 1, 2, 4, 8, 16 and 32, each checked, run twice (equal
   bitwise) and timed, which places the crossover; the pass that
   ``pass_part`` picks at R = 1, 16 and 32 beside the plain version, its
   SIMT bound and its bound; the general pullback (three passes) and the
   self-Gram's one-pass pullback at R = 16.  Row 4 again at phase 22's
   M = 8192 (the SE Gram of 8192 points N(0, 1) in D = 8): f32 against the
   plain version in f32 and f64 (twice, equal bitwise), f64 on the host loop
   against the f64 plain version, then timed beside the plain version and
   both bounds.
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
   (kernel 4 once, the epilogue forward and backward once a call, each
   call as many blocks as ``streaming_data_term`` groups: ``stream_calls``)
   and that the gradients agree with the plain path (checkpointed Gram
   blocks); prints the ms a value-and-gradient of both paths.
7. The matrix-free exact GP (``bench.py::laplace_cg_lml``'s sizes with a
   Gaussian likelihood): N = 10^5 points in [0, 10]², y = sin(x_0) +
   0.1·N(0, 1), SE kernel from raw θ = softplus⁻¹(1.5, 1.2, 0.1); 5 steps of
   ``make_slq_hyperopt_step`` (Adam lr 1e-2 on −``logpdf_slq``, 16 probes,
   30 Lanczos iterations, CG tol 1e-5 and at most 400 iterations, a rank-512
   pivoted-Cholesky preconditioner refreshed every 25 steps, blocks of
   8192), then ``posterior_cg(...).mean_and_var`` at 32 test points.
   Asserts that every matvec went through kernel 5 (launches = the counted
   matvecs + the pullbacks' passes; none on the plain block path), step 1's
   loss and gradient and the serve against the plain path (f32), the serve
   of both paths against the f64 path at N = 10^5, at N = 8192 the f64
   kernel path against the f64 plain path and the dense exact ``logpdf``
   and posterior, and that losses and θ stay finite; prints CG iterations,
   host syncs, ms a step and ms a serve of both paths (the plain path once:
   it is slow).

8. The Vecchia serving slice (``bench.py``'s Vecchia rows; k = 32): (a) the
   band kernel (a window to the lanes of a warp, its Gram and factor in
   their registers) against its plain version in f64 and f32, every map,
   both layouts and a broadcast mask, with and without a nugget, k on both
   sides of each template width's edge (8, 9, 16, 17, 32, 33, 64), N
   ragged, duplicated points and masked slots, each f32 call twice (equal
   bitwise), beside the earlier kernel's errors; (b) the band build
   (``approx_root_prec_band``, N = 10^6 on linspace(0, 10^6), bare
   Matérn-3/2), the ``approx_lml`` value (y =
   sin(x/3), softplus(0.55)·Matérn-3/2(ℓ = softplus(0.55)), noise 0),
   ``predict_knn`` over 10^6 training and test points on [0, 1000]^2
   (ℓ = 5, noise 0.1, tiles of 4096 × 65536) and the sparse build with
   random predecessors at N = 2^18, each on the kernel path (one launch,
   counted) and the plain path (none), against each other, with their
   times, the k-NN search timed apart and its host syncs counted, and the
   kernel alone at the build's and the sweep's shapes; (c) in f64,
   ``approx_lml`` at N = 33, k = 32 against the dense exact ``logpdf``,
   ``predict_knn`` at N = 32, k = 32 against the exact posterior, and the
   kernel path against the plain path at N = 65536.

9. Vecchia training (``bench.py::vecchia_lml_grad`` and
   ``vecchia_nugget_lml_grad``; k = 32): (a) the pullback kernel against its
   plain version (the recompute pullback) in f64 and f32, every map, both
   layouts, no nugget and a nugget with and without slot k, k on both sides
   of each width's edge, N ragged, masked slots and exact duplicates among
   the neighbours, x̄w and the nugget's cotangent (window by window and in
   total), f32 also against the plain version in f64 on the same windows,
   two calls equal bitwise, beside the earlier kernel's errors, then
   checked and timed at the path's shape; (b) the value and θ-gradient of
   ``approx_lml`` at N = 10^6
   on linspace(0, 10^6), y = sin(x/3), softplus(0.55)·Matérn-3/2(ℓ =
   softplus(0.55)), noise 0, on three routes (kernels forward and backward;
   the kernel forward with the recompute pullback; the plain path), one
   launch of each kernel a step on the first and none on the last, checked
   against each other and an f64 run, with each route's lengthscale error
   beside the one its point cotangents' residue predicts; (c) the same for the noisy-data model + softplus(0.02)·White;
   (d) five Adam steps (``adam_fit``, lr 1e-2) on (c); (e) the maximin
   ordering with scaled (ρ = 3) and nearest neighbours at N = 2^16, D = 2,
   the host ordering timed apart; (f) in f64, the θ-gradients at N = 33,
   k = 32 (full conditioning) against autograd of the dense exact
   ``logpdf``, and the kernel path against the plain path at N = 65536.

10. Row 6, the band rows from prebuilt Grams (a window to a warp, its
    triangle in the lanes' registers): (a) the kernel against the plain
    masked math on the same Grams in f64 and f32, k = 1, 7, 32, 33 and 64,
    B ragged, masked slots and deflated pivots, a strided Kw, then at 10^6
    windows of the training path (k = 32), checked and timed beside its
    bound and the plain version, and timed at one launch of each path (a
    training block of 8192 at k = 32, a sweep tile of 4096 at k = 64); (b) the value
    and θ-gradient of ``approx_lml`` for σ²·RQ(α = 2)∘ℓ + τ²·White (raw θ
    (0.55, 0.55, softplus⁻¹(2), 0.02)) on ``bench.py::vecchia_lml_grad``'s
    data, N = 10^6, k = 32, blocks of 8192: the RQ kernel does not unwrap,
    so row 6 launches once a block (123) and the band kernel never; checked
    against the plain path (once), each route's point-cotangent residue r
    and the lengthscale entry's cancellation C printed, with f64 checks
    against the dense exact GP (N = 33) and the plain path (N = 65536); (c) ``predict_knn`` over 10^6 training and test points on
    [0, 1000]^2 with per-point noise 0.1·(1 + u), Matérn-3/2 (ℓ = 5), k = 64
    (the JAX package's row-6 branch), tiles of 4096: row 6 once a tile
    (245), checked against the plain path and in f64 at 65536 points.
11. Row 11, the fused stationary Gram: (a) the kernel against its plain
    version, four maps, f64 and f32, at the minibatch step's Kuf
    (2048 × 8192, D = 8), (1000, 777, 1) and (129, 4099, 11), pairs at
    r = 0, then timed at the step's shape, by CUDA events around the call
    (the wrapper's host time inside) and device-only (``torch.profiler``'s
    kernel events), beside the time before the redesign; (b) phase 5's minibatch step
    under ``gram_mode="fused"``: row 11 once a cross-Gram the step builds
    (counted on the default path), step 1's loss and gradients against the
    plain path (f32), 30 Adam steps, ms a step beside the default mode's.
12. The natural-gradient hybrid step (``bench.py::natgrad_hybrid``):
    ``make_natgrad_adam_step`` (Adam 1e-3 on k and z, nat_lr 0.1 on q) over
    fresh minibatches of 8192 gathered from 10^6 points (phase 5's data
    model, M = 2048, D = 8, SE, jitter 1e-6, noise 0.1), from k = (0.5,
    0.5), z ~ N(0, 1), m = 0, L = I.  Step 1 on both paths: exact launch
    counts (row 1 once for the posterior build, row 4 twice for the update;
    none on the plain path), the elbo, k, z, m and L after it against the
    plain path (f32), m and L of both paths against the f64 plain path
    (printed); 10 steps counted, finite, the smallest pivot of L by step;
    ms a step of both paths; in f64 at N = 4096, M = 256 (full batch), one
    step with nat_lr = 1 from an arbitrary q lands on the optimal q: the
    elbo there equals ``vfe_elbo`` to 1e-8.
13. The Poisson SVGP step (``bench.py::poisson_svgp``): 8192 points on
    [0, 100] with counts from numpy, num_data 10^5, M = 1024 inducing points
    on linspace(0, 100), jitter 1e-3, analytic expected log-likelihood,
    Adam 1e-3: step 1's gradients against the plain path (the bench's q and
    a non-trivial one), 10 steps with row 1 once a step, ms a step of both
    paths; then every likelihood at 10^6 points in f64 and f32 on the card:
    Gauss–Hermite against the analytic expectation, Monte Carlo against it
    (or against Gauss–Hermite) within 5 standard errors, and
    ``log_prob_d1_d2`` against autograd.
14. Block-Vecchia (``bench.py::block_vecchia_lml`` and
    ``block_vecchia_lml_grad``): N = 10^6 on linspace(0, 10^6), y =
    sin(x/3), b = k = 64, previous neighbours, softplus(0.55)·Matérn-3/2(ℓ =
    softplus(0.55)): ``approx_lml`` and its θ-gradient (no hand-written
    kernel; batched block Grams and ``torch.linalg``), against the f64 run,
    timed; in f64, b = 1 against scalar Vecchia (N = 4096, k = 6), full
    conditioning against the exact GP's logpdf and posterior (N = 512), and
    maximin with nearest neighbours on the card against the CPU (N = 2^14
    in 2-D).
15. The Laplace approximation (``bench.py::laplace_n5k``,
    ``laplace_cg_mode`` and ``laplace_cg_lml``; data from numpy, Bernoulli
    labels): (a) the value and θ-gradient of −``laplace_lml`` at N = 5000
    (dense Newton, at most 20 steps, jitter 1e-6; no kernel) against the
    f64 run, three steps timed; (b) the CG-Newton mode of 1.5·SE(ℓ = 1.2)
    in 2-D (Newton to 1e-4, at most 60 steps, CG to 1e-6, at most 400) at
    N = 2·10^4 on three routes (the resident Gram, ``storage="dense"``,
    rank 128, no kernel; chunked through row 5; chunked plain), against
    each other and the f64 dense mode (``torch.linalg`` on the card), then
    at N = 10^5 (rank 512, blocks of 8192) through row 5, held by the move
    of one more Newton step from it, with the Newton steps, CG iterations,
    host syncs and row 5's launches by pass and width, and each route's ms;
    (c) ``laplace_cg_lml`` at N = 10^5 (16 probes, 30 Lanczos steps): the
    value and the value with its θ-gradient, timed, with row 5's narrow
    pass (R = 1), wide pass (R = 16) and self-Gram pullback at R = 1 (the
    Newton IFT) and R = 16 (the logdet surrogate) each launched and
    counted, and the gradient against the f64 run (row 5's f64 kernels);
    at N = 2·10^4 with one probe set row 5 against the plain route (value
    and gradient) and the f64 run, logdet B by SLQ at one W on the three
    routes, and, a statistical check, the lml against the dense f64
    ``laplace_lml`` within four standard errors of the probes' mean; (d)
    ``posterior(LaplaceCG)`` and ``mean_and_var`` at 32 test points at
    N = 10^5 (row 5's widest fused block, R = 32), and at N = 2·10^4
    against the dense f64 ``LaplacePosterior``; ``sample_prior_msqrt`` with
    16 samples at N = 10^5 (one row-5 launch a Lanczos step), their
    covariance on 256 points against K within five Monte-Carlo standard
    deviations (statistical), and at N = 2·10^4 row 5 against the plain
    route with the same normals; (e) row 5's self-Gram pullback at R = 1,
    N = 10^5, against its plain version, timed beside its bound.

16. Pathwise sampling: (a) ``sample_posterior_functions_cg`` at phase 7's
    data model and size (N = 10^5 on [0, 10]^2, 1.5·SE(ℓ = 1.2), noise
    0.1), 16 samples, 2048 features, rank 512, CG tol 1e-6 (converged in
    fewer than 1000 iterations), at 4096 query points: every product on
    row 5's wide pass at R = 16 (the CG iterations and the update
    K(x, X)·V), counted by pass, both routes timed; at
    N = 2·10^4 the same draws on row 5, on the plain route and in f64, and
    the 16-sample mean against ``posterior_cg``'s in posterior standard
    deviations; (b) ``sample_svgp_functions`` on phase 4's posterior, 16
    samples, 1024 features, over 10^6 points in blocks of 16384 under
    ``gram_mode="fused"`` (row 1 once, row 11 once a block) and the default
    route, both timed; 256 samples at 2048 points against ``mean_and_var``
    within 6 standard errors.
17. The heteroscedastic two-latent SVGP step (``convert.heteroscedastic_loss``):
    phase 5's N, D, B and Adam rate, M = 2048 a latent, Gauss–Hermite with
    10 points a latent: row 1 twice a step, step 1's value and gradients
    against the plain path and the f64 plain path, 10 steps with no NaN,
    ms a step of both paths.
18. Online SVGP: (a) ``site_update`` over phase 6's 2^20 points in 64
    blocks of 16384 (M = 2048), then ``site_posterior_q``, timed (no
    kernel); (b) at 2^16 points the stream against the batch optimum
    (``optimal_variational_posterior``) in f32, and both against f64; (c)
    ``online_elbo``'s value and gradient after that round (B = 8192): row 1
    once, against the plain path, timed.
19. Leave-one-out: ``loo_logpdf``'s value and θ-gradient at N = 5000
    (``laplace_n5k``'s points, softplus-SE, noise 0.1), f32 against f64 on
    the card, timed; no kernel.
20. The data-parallel layer (``parallel/``, ``dp_streaming_elbo``, the
    ``mesh=`` paths) over a ``torch.distributed`` world of this one process
    on NCCL (one card takes one rank; no other backend is tried), each path
    run with the counts set to 0 and held against its single-card
    counterpart on the same inputs, both timed (the difference is the
    layer's cost at a world of one): (a) ``dp_predict_blocks`` over phase
    4's 10^6 points (row 1 once, row 2 62 times); (b) ``make_dp_train_step``
    on phase 5's minibatch cell, 30 Adam steps over the same batches as
    ``adam_fit`` from the same start (row 1 once a step); (c)
    ``dp_streaming_elbo`` at phase 6's 2^20 points (row 4 once, rows 2 and
    3 once a call of phase 6's grouped blocks); (d) the matrix-free tier on
    row bands: ``logpdf_slq``'s value and θ-gradient at phase 7's exact GP,
    a ``posterior_cg`` serve, ``newton_inner_loop_cg`` at 10^5 (chunked,
    the cross pass) and at 2·10^4 (``storage="dense"``: the rank's 1.6 GB
    band of K stored), and ``laplace_lml_cg``'s θ-gradient at 2·10^4
    against the f64 run on the band route and the single-card one (row 5's
    cross pass at R = 1 and 16, the general pullback's transposed pass and
    the lengthscale's r²·g′ pass), row 5's launches counted by pass.
21. Phase 5's minibatch cell under ``compute_dtype="bfloat16"`` (the (M, B)
    projection intermediates stored in bf16, sums in f32): step 1's value
    within 2e-2 of the f32 step and its gradients against it (the bench's q
    and a non-trivial one), 30 finite Adam steps with row 1 once a step, ms
    a step beside the f32 step's in the same run.
22. The minibatch step at M = 8192 (``bench.py --M 8192``: z ~ N(0, 1),
    m = 0, A = I; B = 8192 from 10^6 points): above s_corr_max_m the build
    takes ``chol_with_inv``, so row 4 runs once a step at M = 8192.  Step 1
    at a non-trivial q in (a) the defaults (bf16 storage and the triangular
    products on the card), (b) ``compute_dtype="float32"``, (c) f32 with
    the dense products, and (b) with ``chol_mode="plain"`` (cuSOLVER): (b)
    against (c) and the plain route, (a) against (b); then 10 Adam steps in
    each of (a), (b), (c) with their launches, ms a step and peak memory.
23. The twins of the ten examples (``examples/torch/``) at
    ``scripts/run_examples.py``'s reduced sizes, their asserts live: each
    one's seconds and its launches by row.

The line before the last is one JSON object with each kernel's route,
source, launches in the path runs of phases 4-23 (each run with the counts
set to 0 just before it), error, times and bound (the least time the card
could take for the work: operations over the peak rate of their unit or
bytes over the memory rate, whichever is larger), and row 4 once more at
M = 8192 (``chol_inv@M=8192``: phase 3's numbers, phase 22's launches); the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import socket
import statistics
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch import convert
from approximategps_tpu_torch.core import kernels as tk
from approximategps_tpu_torch.models import iterative, laplace_cg, sampling, svgp_streaming, \
    vecchia
from approximategps_tpu_torch.ops import _build, batched_chol, gram, gram_matvec, knn, \
    panel_chol, svgp_epilogue
from approximategps_tpu_torch.utils.bijectors import softplus

# every kernel's launch counter, by the name the kernels line gives it
COUNTERS = {
    "gram_chol_inv": panel_chol.gram_chol_inv,
    "svgp_data_epilogue": svgp_epilogue.svgp_data_epilogue,
    "svgp_data_epilogue_bwd": svgp_epilogue.svgp_data_epilogue_bwd,
    "chol_inv": panel_chol.chol_inv,
    "gram_matvec": gram_matvec.gram_matvec,
    "vecchia_band": batched_chol.vecchia_band,
    "vecchia_band_bwd": batched_chol.vecchia_band_bwd,
    "batched_chol_solve_band": batched_chol.batched_chol_solve_band,
    "stationary_gram": gram.stationary_gram,
}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    iterative.reset_stats()
    knn.reset_stats()
    for k in gram_matvec.pullback_passes:
        gram_matvec.pullback_passes[k] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def only(**counts) -> dict:
    """Every kernel's count 0 but the ones named."""
    return {name: counts.get(name, 0) for name in COUNTERS}

SEED = 0
M, D = 2048, 8
N_TEST, BLOCK = 1_000_000, 16384
JITTER = 1e-6
# Row 1 in f32 (phase 3): beside today's limits (‖dL‖_F/‖L‖_F ≤ 1e-4, max|LJ − I| ≤ 1e-3)
# a tighter one on both, set from the card's readings at M = 2048 (at most 2.1e-6 and
# 1.2e-6 on both kernels): with one or two TF32 products in place of three, the host
# emulation in tests/test_torch_panel_chol_steps.py moves both ten times past it on these
# inputs, so such a kernel fails it
ROW1_TIGHT32 = 2e-5
# the CUDA-event medians (ms) of rows 1, 4 and 11 at phase 3's and phase 11's shapes before
# rows 4 and 11 were redesigned (row 4 on the host loop, row 11 written by 4-byte stores;
# row 1 unchanged since), from this script, printed beside today's (NVIDIA H100 80GB HBM3,
# 700.00 W)
EARLIER_MS = {"gram_chol_inv": 1.606, "chol_inv": 2.611, "stationary_gram": 0.086}
RAW_K = (0.5, 0.5)  # bench.py's raw (variance, lengthscale)
N_DATA, BATCH, LR, STEPS = 1_000_000, 8192, 1e-3, 30  # bench.py::headline
N_STREAM = 1 << 20  # bench.py::full_streaming
NOISE = 0.1
# f32 limits for the training paths, relative to each gradient's largest
# entry: the two paths factor Kuu by different routes (the panel kernels
# against cuSOLVER) and sum over 8192 or 2^20 points in other orders
GRAD_RTOL = 1e-3
# the exact GP in f32, kernels against the plain path, relative to the
# largest entry: CG stops at a relative residual of 1e-5 on each path, at
# other points of two trajectories, the plain path's Gram blocks take r² by
# the |x|² identity (an error of about eps·|x − c|² ≈ 6e-6 here), and each
# f32 path's posterior mean sits about 2e-4 from the f64 one (phase 7
# prints both)
GP_RTOL = 1e-3
# the matrix-free exact GP (bench.py::laplace_cg_lml's sizes, Gaussian
# likelihood): raw θ = softplus⁻¹ of (variance, lengthscale, noise variance)
N_GP, D_GP, N_GP64 = 100_000, 2, 8192
GP_THETA = np.log(np.expm1(np.array([1.5, 1.2, 0.1])))
GP_SLQ = dict(lanczos_iters=30, cg_tol=1e-5, cg_maxiter=400, block_size=8192)
GP_PROBES, GP_RANK, GP_LR, GP_REFRESH, GP_STEPS, GP_N_TEST = 16, 512, 1e-2, 25, 5, 32
# the Vecchia serving slice (bench.py's Vecchia rows, nothing cut but the
# sparse build's N): the band build and approx_lml at N = 10^6 on
# linspace(0, 10^6), predict_knn over 10^6 training and test points on
# [0, 1000]^2, the sparse build at N = 2^18; k = 32 throughout
N_VEC, VEC_K, VEC_BLOCK = 1_000_000, 32, 8192
N_SWEEP, SWEEP_SIDE, SWEEP_TEST_BLOCK, SWEEP_TRAIN_BLOCK = 1_000_000, 1000.0, 4096, 65536
N_SPARSE, N_VEC64 = 1 << 18, 65536
VEC_THETA = np.array([0.55, 0.55, -np.inf])  # bench.py::vecchia_lml_grad, noise 0
SWEEP_THETA = np.log(np.expm1(np.array([1.0, 5.0, 0.1])))  # variance 1, lengthscale 5, noise 0.1
# f32 limit of the band kernel against its plain version, relative to the
# largest entry: the two round each pivot in another order, and the window
# Grams of points a lengthscale apart with 32 neighbours amplify that by
# their conditioning (the same windows in f64 differ by about 60 eps), so
# f32 sits near 1e-5; f64 1e-12
BAND_RTOL32 = 1e-4
# the Vecchia paths in f32, kernels against the plain path (the bordered
# factorization against the masked one, each with its own rounding)
VEC_RTOL = 1e-4
# Vecchia training (bench.py::vecchia_lml_grad and vecchia_nugget_lml_grad):
# phase 8's N = 10^6, k = 32 and blocks of 8192; the nugget model's raw θ;
# the general orderings at N = 2^16 in 2-D (points about a lengthscale
# apart); f64 checks at N = 65536; five Adam steps
NUGGET_THETA = np.array([0.55, 0.55, 0.02])
N_ORDER, SIDE_ORDER, RHO, N_TRAIN64, ADAM_STEPS, ADAM_LR = 1 << 16, 256.0, 3.0, 65536, 5, 1e-2
# f32 limits of the pullback kernel against its plain version (f64 1e-10).
# x̄w, relative to its largest entry: both solve with each window's Gram
# twice, in other orders, and 33 points a lengthscale apart in 1-D amplify
# that rounding about 2000× (the two differ by about 2100 eps in f64 on the
# same windows), about 2.5e-4 in f32; phase 9 (a) prints the f32 plain
# version's own distance from the f64 one beside the kernel's
BWD_XW_RTOL32 = 1e-3
# the nugget's cotangent: each window's share relative to the largest share
# and the total relative to the sum of the shares' magnitudes Σ|p|: with
# random cotangents the shares cancel (Σ|p|/|Σp| is printed, and reaches 3e4
# on some maps and windows), so f32 rounds the total at eps of Σ|p|, not of
# |Σp|
BWD_NUG_RTOL32 = 1e-4
# phases 8 (a) and 9 (a)'s (D, k, N): k at the kernels' limits and on both sides of each
# template width's edge (a window is padded to 8, 16, 32 or 64 rows), N ragged against
# every width's block (32, 16, 8 and 2 windows)
BAND_PARITY = BWD_PARITY = ((1, 32, 10001), (2, 32, 10001), (3, 7, 4099), (2, 8, 2049),
                            (1, 9, 2049), (2, 16, 2049), (3, 17, 2049), (2, 33, 2049),
                            (8, 64, 2049))
# the errors of the kernels the warp-per-window design replaced (a window to a team of four
# threads, its triangle in shared memory) in the cases phases 8 (a) and 9 (a) held them to,
# printed beside the new errors: (dtype, D, k) -> the band's rel err, and x̄w's and the
# nugget shares' rel err of the pullback; from this script on the tree before the redesign
# (NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_BAND_ERR = {("float64", 1, 32): 1.340e-14, ("float64", 2, 32): 2.727e-15,
                    ("float64", 3, 7): 3.747e-15, ("float64", 8, 64): 9.701e-15,
                    ("float32", 1, 32): 8.497e-06, ("float32", 2, 32): 3.587e-07,
                    ("float32", 3, 7): 3.594e-07, ("float32", 8, 64): 2.803e-06}
EARLIER_BWD_ERR = {("float64", 1, 32): (4.793e-13, 2.401e-15),
                   ("float64", 2, 32): (7.721e-14, 2.577e-15),
                   ("float64", 3, 7): (5.226e-16, 4.354e-16),
                   ("float64", 8, 64): (8.791e-16, 1.813e-15),
                   ("float32", 1, 32): (5.785e-04, 1.630e-06),
                   ("float32", 2, 32): (4.529e-05, 2.306e-07),
                   ("float32", 3, 7): (4.676e-07, 4.488e-07),
                   ("float32", 8, 64): (6.543e-07, 1.100e-06)}
# the f32 θ-gradients at N = 10^6, relative to their largest entry.  The
# lengthscale entry is Σᵢ xᵢ·∂L/∂xᵢ over points up to 10^6: the point
# cotangents sum to 0 by translation invariance, but in f32 each path leaves
# a residue r = Σ∂L/∂x / Σ|∂L/∂x| of about eps, which that entry multiplies by
# C = Σ|xᵢ·∂L/∂xᵢ| / |Σ xᵢ·∂L/∂xᵢ| (about 10^5 here): its error is about r·C,
# printed for each path beside the measured one; the other entries do not
# cancel.  Kernels against the recompute route (the same forward, so the
# pullback alone) and against the f64 run:
TRAIN_ROUTE_RTOL32 = TRAIN_F64_RTOL32 = 1e-3
# kernels against the plain path on the lengthscale entry, whose own residue
# puts it further from the f64 run (its other entries are held at VEC_RTOL)
TRAIN_PLAIN_RTOL32 = 1e-2
# Row 6 (phase 10): the Vecchia tier that runs on prebuilt Grams.  (b) the RQ + white
# training model on bench.py::vecchia_lml_grad's data: raw θ = (variance, lengthscale,
# α = softplus⁻¹(2), the JAX default, nugget); (c) predict_knn with per-point noise
# 0.1·(1 + u) at k = 64, the JAX package's row-6 branch (k > 48), on
# bench.py::vecchia_predict_knn_sweep's points, raw (variance 1, ℓ = 5)
RQ_THETA = np.array([0.55, 0.55, math.log(math.expm1(2.0)), 0.02])
HETERO_K, HETERO_THETA = 64, np.log(np.expm1(np.array([1.0, 5.0])))
# (a)'s (D, k, B): k at 1, 7, 32, 33 (the first of the two-rows-a-lane width) and the
# kernel's limit of 64, B ragged against the kernel's blocks; the timed shape: 10^6
# windows at k = 32
ROWS_PARITY = ((1, 1, 10001), (1, 7, 10001), (2, 32, 10001), (2, 33, 4099), (8, 64, 2049))
N_ROWS64 = 65536
# f32 limit of row 6 against its plain version, relative to the largest entry: the two
# factor the same Grams in another summation order (the kernel updates each row
# right-looking, column by column, where the plain version takes each entry's dot at once),
# and windows a lengthscale apart amplify that rounding by their conditioning, as for the
# band kernel (BAND_RTOL32)
ROWS_RTOL32 = 1e-4
# Row 11 (phase 11): (a)'s (N, M, D): the minibatch step's Kuf, ragged tiles at D = 1,
# two coordinate chunks at D = 11; f32 limit relative to the largest entry: r² summed in
# another order (FMAs over the coordinates against the plain version's sum of squares),
# a few eps of each entry
GRAM_PARITY = ((M, BATCH, D), (1000, 777, 1), (129, 4099, 11))
GRAM_RTOL32 = 1e-5
# Phase 12, the natural-gradient hybrid step (bench.py::natgrad_hybrid): phase 5's N, M, D, B
# and Adam rate, nat_lr 0.1, the start k = (0.5, 0.5), z ~ N(0, 1), m = 0, L = I, 10 steps;
# the f64 conjugate check at N = 4096, M = 256 (full batch)
N_NAT, M_NAT, NAT_LR, NAT_STEPS, NAT_N64, NAT_M64 = N_DATA, M, 0.1, 10, 4096, 256
# step 1's hyperparameters after Adam, kernels against the plain path, relative to each one's
# largest entry: Adam's first step moves every entry by lr with its gradient's sign, and z's
# gradient vanishes at the bench's start (α = 0, S = 0), so roundoff picks its sign on each
# path and an entry of z may differ by 2·lr = 2e-3, about 4.4e-4 of max|z|
NAT_HYPER_RTOL = 1e-3
# step 1's (m, L) after the natural gradient, kernels against the plain path and against the
# f64 plain path, relative to the largest entry: both factor S⁻¹ − 2·lr·S̄ = I + 1221·AAᵀ
# (A = Lk⁻¹Kuf at B = 8192) and then its inverse in f32, row 4 against cuSOLVER; each f32
# path's m lay 2e-3–3e-3 from the f64 one on an NVIDIA H100 80GB HBM3 (printed), so f32
# decides this limit
NAT_Q_RTOL = 1e-2
# Phase 13, the Poisson SVGP step (bench.py::poisson_svgp): 8192 points on [0, 100], counts
# ~ Poisson(exp(sin x)) from numpy, num_data 10^5, M = 1024 inducing points on
# linspace(0, 100), inducing jitter 1e-3, Adam 1e-3, 10 steps; the likelihood checks at 10^6
# points
POIS_M, POIS_BATCH, POIS_N, POIS_JITTER, POIS_STEPS, N_LIK = 1024, 8192, 100_000, 1e-3, 10, \
    1_000_000
# Phase 14, block-Vecchia (bench.py::block_vecchia_lml and block_vecchia_lml_grad): N = 10^6
# on linspace(0, 10^6), y = sin(x/3), blocks of 64 each conditioning on the previous 64
# points, softplus(0.55)·Matérn-3/2(ℓ = softplus(0.55)), noise 0; f64 checks: b = 1 against
# scalar Vecchia (N = 4096, k = 6), full conditioning against the exact GP (N = 512), maximin
# with nearest neighbours against the CPU (N = 2^14 in 2-D)
N_BV, BV_B, BV_K = 1_000_000, 64, 64
BV_THETA = np.array([0.55, 0.55, -np.inf])
N_BV_SCALAR, BV_SCALAR_K, N_BV_EXACT, N_BV_NEAREST = 4096, 6, 512, 1 << 14
# f32 against f64 at N = 10^6, relative (the gradient to its largest entry): sums over 15625
# blocks' log-determinants and quadratic forms, the gradient through each block's two
# Cholesky pullbacks (Matérn-3/2 Grams of 64 points a lengthscale apart); an NVIDIA H100
# 80GB HBM3 (700 W) read 9.9e-5 on the value and 9.0e-4 on the lengthscale entry
BV_VALUE_RTOL32, BV_GRAD_RTOL32 = 1e-3, 1e-2
# Phase 15, the Laplace approximation (bench.py::laplace_n5k, laplace_cg_mode, laplace_cg_lml),
# data from numpy (convert.laplace_data: points uniform on [0, 10]^D, Bernoulli(1/2) labels).
# laplace_n5k: N = 5000 sorted in 1-D, softplus-SE from raw θ = (1, 1), jitter 1e-6, at most
# 20 Newton steps.  The CG rows: D = 2, 1.5·SE(ℓ = 1.2) (convert.LAPLACE_CG_THETA), Newton to
# 1e-4 (at most 60 steps), CG to 1e-6 (at most 400); N = 2·10^4 with rank-128 preconditioning
# (the resident Gram, or chunked with blocks of 8192 on the kernel and the plain routes), N = 10^5
# with rank 512 and blocks of 8192; the lml with 16 probes and 30 Lanczos steps; the serve at
# 32 test points; the prior sampler's 16 samples (noise 0.01) checked on 256 of the points
N_LAP5K, LAP5K_JITTER, LAP5K_MAXITER = 5000, 1e-6, 20
N_LAP, N_LAP_MID, D_LAP, LAP_BLOCK = 100_000, 20_000, 2, 8192
LAP_NEWTON = dict(maxiter=60, tol=1e-4, cg_tol=1e-6, cg_maxiter=400)
LAP_RANK, LAP_RANK_MID, LAP_PROBES, LAP_LANCZOS, LAP_N_TEST = 512, 128, 16, 30, 32
LAP_SAMPLES, LAP_SAMPLE_NOISE, LAP_SUBSET = 16, 0.01, 256
# f32 limits of phase 15, relative to the largest entry (a scalar: to itself), each a few times
# what this script read on an NVIDIA H100 80GB HBM3 (700 W): laplace_n5k against its f64 run
# (value 2.7e-8, gradient 1.6e-5); the CG modes at 2·10^4 against each other and the f64 dense
# mode (at most 2.1e-4: Newton stops at a relative step of 1e-4, or where the f32 step stops
# shrinking); one more Newton step from the mode at 10^5 (1.0e-3, the f32 floor); the lml's
# value, row 5 against the plain route (2.1e-7); logdet B by SLQ at one W, row 5 against the
# plain route (1.55e-5) and, no further than max(LAP_LOGDET_RTOL32, twice the plain route's
# distance), the f64 run (1.41e-4, plain 1.57e-4: f32 Lanczos); the θ-gradient against the
# f64 run, row 5 no further than max(LAP_GRAD_RTOL32, twice the plain route's distance): at
# 2·10^4 row 5 read 1.39e-5 and the plain route 1.25e-5 (row 5 read 1.04e-3 while the
# self-Gram pullback wrote V̄ row-major into a tensor with the column-major strides of the
# logdet surrogate's V = w∘Zᵀ, which scrambled it; see scripts/profile_exact_gp_torch.py
# lengthscale); at 10^5 (rank 512) row 5 alone (2.5e-5); the prior sampler with the same
# normals, row 5
# against the plain route (6.3e-5); the serve against the f64 dense posterior (the mean
# 4.0e-5, and the variance's largest error over the prior variance 8.7e-7)
LAP5K_RTOL32, LAP_MODE_RTOL32, LAP_STEP_RTOL32, LAP_LML_RTOL32 = 1e-4, 1e-3, 3e-3, 1e-6
LAP_LOGDET_RTOL32, LAP_GRAD_RTOL32, LAP_GRAD_BIG_RTOL32 = 5e-5, 5e-5, 1e-4
LAP_SAMPLE_RTOL32, LAP_POST_RTOL32 = 2e-4, 2e-4
# Phase 16, pathwise sampling.  (a) sample_posterior_functions_cg at laplace_cg_lml's exact-GP
# size (phase 7's data model: N = 10^5 on [0, 10]^2, y = sin(x_0) + 0.1·N(0, 1), noise 0.1),
# 1.5·SE(ℓ = 1.2) (convert.LAPLACE_CG_THETA), 16 samples, 2048 features, a rank-512
# preconditioner, CG tol 1e-6 in at most 1000 iterations, blocks of 8192 on the plain route,
# 4096 query points.  At noise 0.01 (phase 15's prior sampler's) the f32 block CG of both routes
# ran its 1000 iterations without converging, and their samples lay 1.9 times their scale apart
# (an NVIDIA H100 80GB HBM3, 700 W): ε's white noise reaches K's eigenvalues near σ², which the
# rank-512 factor leaves, so the sampler holds phase 7's noise and checks convergence; the same
# draws at N = 2·10^4 on row 5, on the plain route and in f64, the 16-sample mean against
# posterior_cg's (f64) at 256 of the query points.  (b) sample_svgp_functions on phase 4's
# posterior, 16 samples, 1024 features, over 10^6 points in blocks of 16384 on the default and
# the fused Gram route; 256 samples at 2048 points against mean_and_var
N_PS, N_PS_MID, PS_SAMPLES, PS_FEATURES, PS_RANK, PS_TOL = 100_000, 20_000, 16, 2048, 512, 1e-6
PS_NOISE, PS_MAXITER, PS_N_TEST, PS_N_MOMENT, SVGP_PS_FEATURES = 0.1, 1000, 4096, 256, 1024
SVGP_PS_MOMENT_N, SVGP_PS_MOMENT_S = 2048, 256
# f32 limits of phase 16 (a), relative to the samples' largest entry, each a few times what an
# NVIDIA H100 80GB HBM3 (700 W) read: row 5 against the plain route (1.3e-3 at 10^5, 6.9e-4 at
# 2·10^4: CG stops at 1e-6 at another iterate on each), each against the f64 run at 2·10^4
# (row 5 1.9e-4, plain 6.3e-4); statistical: the RMS over 256 points of the 16-sample mean's
# distance from the posterior mean in posterior standard deviations (1/√16 = 0.25 expected;
# read 0.238)
PS_ROUTE_RTOL32, PS_F64_RTOL32, PS_MEAN_Z_RMS = 5e-3, 3e-3, 1.0
# (b): the fused Gram route against the default route on one block, relative to the samples'
# largest entry (read 2.7e-6); statistical: the moments' largest distance in standard errors
# over 2048 correlated points (read 3.84 for the mean, 4.34 for the variance, whose statistic
# is skewed and carries the 1024 features' bias of about a quarter of a standard error)
SVGP_PS_ROUTE_RTOL32, SVGP_PS_Z = 1e-5, 6.0
# Phase 17, the heteroscedastic two-latent SVGP step (convert.heteroscedastic_loss): phase 5's
# N, D, B and Adam rate, M = 2048 a latent, Gauss–Hermite with 10 points a latent (100 nodes),
# y = sin(x_0) + 0.1·exp(0.3·x_1)·N(0, 1), both latents' q non-trivial, 10 steps
ML_STEPS, ML_GH = 10, 10
# f32 limits, relative to each gradient's largest entry: kernels against the plain path
# (GRAD_RTOL) and against the f64 plain path (read at most 4.2e-5 on an NVIDIA H100 80GB HBM3,
# 700 W, in A's and z's gradients)
ML_F64_RTOL32 = 2e-4
# Phase 18, online SVGP: (a) site_update over phase 6's 2^20 points in 64 blocks of 16384
# (M = 2048, phase 4's inducing points and kernel, noise 0.1), then site_posterior_q; (b) at
# 2^16 points the stream against the batch optimum (f32), each against the f64 batch optimum;
# (c) online_elbo's value and gradient (B = 8192, num_data 2^20) of a NonCentered approximation
# at new inducing points after the first 2^16 points' round
# (b)'s f32 limit, relative to the largest entry of the batch optimum's mean and covariance (read
# 5.4e-5 on an NVIDIA H100 80GB HBM3, 700 W; each lay 2e-5–7e-5 from the f64 optimum)
N_ONLINE_CHECK, ONLINE_Q_RTOL32 = 1 << 16, 3e-4
# Phase 19, LOO: loo_logpdf at laplace_n5k's N = 5000 sorted on [0, 10], softplus-SE from raw
# θ = (1, 1), noise 0.1, y = sin(x) + 0.1·N(0, 1) (numpy); f32 against f64 on the card (read:
# value 2.2e-6, θ-gradient 9.4e-5 of its largest entry, an NVIDIA H100 80GB HBM3, 700 W)
N_LOO, LOO_NOISE, LOO_VALUE_RTOL32, LOO_GRAD_RTOL32 = 5000, 0.1, 1e-5, 5e-4
# Phase 20, the data-parallel layer over an NCCL world of one: each path against its single-card
# counterpart in f32, relative to the largest entry.  At a world of one the band is all of K and
# the cross pass is the self-Gram's forward pass, so the serve, the steps, the stream, the SLQ
# value and gradient and the chunked Newton mode repeat the single-card bits unless the layer
# adds rounding (DP_RTOL32: an NVIDIA H100 80GB HBM3, 700 W, read every one bitwise equal but
# the SLQ θ-gradient, 7.1e-8, and the stream's dA, 5.9e-8, where autograd adds the cotangents
# in another order); the stored band is the cross Gram K(X, X), built by another route than the
# symmetric Gram (DP_DENSE_RTOL32; read 1.7e-4: Newton stops at a relative step of 1e-4)
DP_RTOL32, DP_DENSE_RTOL32 = 1e-6, 1e-3
# Phase 21, phase 5's cell under compute_dtype="bfloat16": step 1's value against the f32 step
# (tests/test_svgp.py's gate) and its gradients, relative to each one's largest entry (read at
# most 1.39e-1 on an NVIDIA H100 80GB HBM3, 700 W).  S's cotangent (K∘w)Kᵀ is stored in bf16
# and comes back through the L⁻¹ sandwich of the whitened cache's pullback: the JAX package's
# own bf16 gradient sits as far from its f32 one (dA 1.14e-1 in both packages on the CPU at
# M = 2048, B = 2048; `PYTHONPATH=. python tests/test_torch_compute_dtype.py 2048 2048`).
# The same step above s_corr_max_m, with no S-correction, is held to BF16_NO_S_GRAD_RTOL
# (1.1e-2 in both packages on the CPU there)
BF16_VALUE_RTOL, BF16_GRAD_RTOL, BF16_NO_S_GRAD_RTOL = 2e-2, 3e-1, 5e-2
# Phase 22, the step at M = 8192 (bench.py --M 8192), 10 steps a setting; row 4 at that M in
# phase 3.  f32 limits relative to each gradient's largest entry, each a few times the reading
# on an NVIDIA H100 80GB HBM3, 700 W: the triangular and dense products are the same sums in
# another order (LARGE_DENSE_RTOL32; read 1.1e-5), cuSOLVER's factor takes another route
# (LARGE_PLAIN_RTOL32; read 1.9e-4), bf16 storage against f32 (LARGE_BF16_GRAD_RTOL; read
# 3.7e-2)
M_LARGE, LARGE_STEPS = 8192, 10
LARGE_DENSE_RTOL32, LARGE_PLAIN_RTOL32, LARGE_BF16_GRAD_RTOL = 1e-4, 1e-3, 1e-1
# row 4 at M = 8192: ||dL||_F/||L||_F and max|LJ − I| in f64 (host loop; read 4.5e-14 and
# 6.9e-15) and f32 (panel steps; read 3.0e-5 against cuSOLVER's f32 factor, itself 3.0e-5 from
# f64, 4.1e-6 against f64, and 1.7e-6)
LARGE_F64_FRO, LARGE_F64_RES, LARGE_F32_FRO, LARGE_F32_RES = 1e-12, 1e-12, 1e-4, 2e-5
# H100 SXM peaks (data sheet, 700 W): f32 outside the tensor cores, HBM;
# special-function unit results (exp): 16 a clock an SM (Hopper white
# paper) × 132 SMs × 1.98 GHz boost; TF32 on the tensor cores (dense)
PEAK_F32, PEAK_BYTES, PEAK_SFU, PEAK_TF32 = 67e12, 3.35e12, 16 * 132 * 1.98e9, 495e12
# row 5's f32 passes: the widths both kernels are timed at to place the
# crossover, and the widths the kernels line reports
GMV_CROSSOVER_R, GMV_TIMED_R = (1, 2, 4, 8, 16, 32), (1, 16, 32)


CARD = "not read"  # the card's name and power limit, as nvidia-smi gives them (phase 1)


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


def device_ms(fn, name: str, calls: int) -> float:
    """Median device-only time of the kernel events whose name holds
    ``name`` over ``calls`` calls of ``fn`` after one warm-up, from
    ``torch.profiler``'s device-side events (no host time inside); NaN where
    the profiler records no such event."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return statistics.median(times) if times else float("nan")


def timed(fn):
    """(result, host ms) of ``fn`` between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
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

    # kernel A, f32 at the slice's shape (the panel steps): relative Frobenius
    # error of L and the inverse's residual |L J - I| against the plain
    # version in f32, run twice (equal bitwise)
    Z32 = torch.tensor(rng.standard_normal((M, D)), dtype=torch.float32, device=dev)
    eye = torch.eye(M, dtype=torch.float64, device=dev)
    check(panel_chol.gram_chol_inv_part(M, D, torch.float32) == "mma",
          "gram_chol_inv f32 takes the panel steps (part mma), f64 the host loop")

    def f32_factor_check(what, run, L0):
        L, J = run()
        L2, J2 = run()
        torch.cuda.synchronize()
        fro = (torch.linalg.norm(L.double() - L0.double())
               / torch.linalg.norm(L0.double())).item()
        res = (L.double() @ J.double() - eye).abs().max().item()
        same = torch.equal(L, L2) and torch.equal(J, J2)
        upper = bool(torch.triu(L, 1).any() or torch.triu(J, 1).any())
        check(fro <= 1e-4 and res <= 1e-3 and max(fro, res) <= ROW1_TIGHT32 and same
              and not upper,
              f"{what}: ||dL||_F/||L||_F {fro:.3e} <= 1e-4, max|LJ - I| {res:.3e} <= 1e-3, "
              f"both <= {ROW1_TIGHT32:g}, two runs equal bitwise, zeros above both diagonals")
        return max_abs(L, L0)

    for name in ("se", "matern32"):
        L0, _ = panel_chol.gram_chol_inv_plain(Z32, sig2, JITTER, maps[name])
        err = f32_factor_check(f"gram_chol_inv f32 M={M} D={D} {name}",
                               lambda: panel_chol.gram_chol_inv(Z32, sig2, JITTER, maps[name]), L0)
        if name == "se":
            out["gram_chol_inv"] = {"max_abs_err": err}
    se = maps["se"]
    ms = cuda_ms(lambda: panel_chol.gram_chol_inv(Z32, sig2, JITTER, se), 10)
    plain_ms = cuda_ms(lambda: panel_chol.gram_chol_inv_plain(Z32, sig2, JITTER, se), 10)
    (b_ms, b_by), (s_ms, s_by) = gram_chol_bounds()
    out["gram_chol_inv"].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "bound_ms_simt": s_ms})
    print(f"time gram_chol_inv f32 M={M}: kernel {ms:.3f} ms (before rows 4 and 11's redesign "
          f"{EARLIER_MS['gram_chol_inv']:.3f}), plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}), SIMT bound {s_ms:.3f} ms ({s_by})")

    def epilogue_inputs(m, b, dtype, d=D):
        R = rng.standard_normal((m, m)) / math.sqrt(m)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        return (t(rng.standard_normal((b, d))), t(rng.standard_normal((m, d))),
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
    parity_epilogue_parts(maps, epilogue_inputs, "fwd")
    se = maps["se"]
    out["svgp_data_epilogue"].update(time_epilogue_parts(
        "svgp_data_epilogue", lambda part: svgp_epilogue.svgp_data_epilogue(*args32, se, part),
        lambda: svgp_epilogue.svgp_data_epilogue_plain(*args32, se), 10))

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
    # f32 on the panel steps, as row 1
    for name in ("se", "matern32"):
        A32 = spd(Z32, maps[name])
        L0, _ = panel_chol.chol_inv_plain(A32)
        err = f32_factor_check(f"chol_inv f32 M={M} {name}", lambda: panel_chol.chol_inv(A32), L0)
        if name == "se":
            out["chol_inv"] = {"max_abs_err": err}
    out["chol_inv@M=8192"] = parity_chol_inv_large(dev, rng, spd)
    A32 = spd(Z32, se)
    ms = cuda_ms(lambda: panel_chol.chol_inv(A32), 10)
    plain_ms = cuda_ms(lambda: panel_chol.chol_inv_plain(A32), 10)
    (b_ms, b_by), (s_ms, s_by) = gram_chol_bounds(gram=False)
    out["chol_inv"].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "bound_ms_simt": s_ms})
    print(f"time chol_inv f32 M={M}: kernel {ms:.3f} ms (before its redesign "
          f"{EARLIER_MS['chol_inv']:.3f}), plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}), SIMT bound {s_ms:.3f} ms ({s_by})")

    # kernel 3, the epilogue's pullback, against the closed-form plain
    # version: the relative error max|d| / max|plain| of each cotangent.
    # f64 1e-9; f32 1e-3 (sums over 2048 rows and 16384 points in other
    # orders, with signed cotangents that cancel)
    def bwd_inputs(m, b, dtype, d=D):
        Xs, Zs, Se, ae = epilogue_inputs(m, b, dtype, d)
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
    parity_epilogue_parts(maps, bwd_inputs, "bwd")
    out["svgp_data_epilogue_bwd"].update(time_epilogue_parts(
        "svgp_data_epilogue_bwd",
        lambda part: svgp_epilogue.svgp_data_epilogue_bwd(*bargs32, se, part),
        lambda: svgp_epilogue.svgp_data_epilogue_bwd_plain(*bargs32, se), 5))
    out["gram_matvec"] = parity_gram_matvec(dev, maps)
    return out


def parity_chol_inv_large(dev, rng, spd) -> dict:
    """Row 4 at phase 22's M = 8192 (the posterior build above s_corr_max_m
    factors Kuu there): in f32 on the panel steps against the plain version
    (cuSOLVER) in f32 and f64, and in f64 on the host loop against the f64
    plain version, on the SE Gram of 8192 points N(0, 1) in D = 8 plus the
    jitter and phase 3's small asymmetry; each f32 run twice (equal
    bitwise); then the kernel and the plain version timed beside the
    tensor-core and the SIMT bound (M³/3 FMAs).  Returns the numbers for
    the kernels line."""
    se = tk.SqExponentialKernel().kernel_map()
    Z = torch.tensor(rng.standard_normal((M_LARGE, D)), device=dev)
    A64 = spd(Z, se)
    A32 = A64.float()
    eye = torch.eye(M_LARGE, dtype=torch.float64, device=dev)
    L64p, J64p = panel_chol.chol_inv_plain(A64)
    L64, J64 = panel_chol.chol_inv(A64)
    torch.cuda.synchronize()
    fro64 = (torch.linalg.norm(L64 - L64p) / torch.linalg.norm(L64p)).item()
    res64 = (L64 @ J64 - eye).abs().max().item()
    check(fro64 <= LARGE_F64_FRO and res64 <= LARGE_F64_RES,
          f"chol_inv f64 M={M_LARGE} (host loop) vs plain f64: ||dL||_F/||L||_F {fro64:.3e} <= "
          f"{LARGE_F64_FRO:g}, max|LJ - I| {res64:.3e} <= {LARGE_F64_RES:g}")
    del L64, J64
    L32p, _ = panel_chol.chol_inv_plain(A32)
    L, J = panel_chol.chol_inv(A32)
    L2, J2 = panel_chol.chol_inv(A32)
    torch.cuda.synchronize()
    fro = (torch.linalg.norm(L.double() - L32p.double()) / torch.linalg.norm(L32p.double())).item()
    fro_64 = (torch.linalg.norm(L.double() - L64p) / torch.linalg.norm(L64p)).item()
    fro_p = (torch.linalg.norm(L32p.double() - L64p) / torch.linalg.norm(L64p)).item()
    res = (L.double() @ J.double() - eye).abs().max().item()
    same = torch.equal(L, L2) and torch.equal(J, J2)
    upper = bool(torch.triu(L, 1).any() or torch.triu(J, 1).any())
    check(fro <= LARGE_F32_FRO and fro_64 <= LARGE_F32_FRO and res <= LARGE_F32_RES and same
          and not upper,
          f"chol_inv f32 M={M_LARGE} (panel steps): ||dL||_F/||L||_F vs plain f32 {fro:.3e}, vs "
          f"plain f64 {fro_64:.3e} (plain f32 vs f64 {fro_p:.3e}) <= {LARGE_F32_FRO:g}, "
          f"max|LJ - I| {res:.3e} <= {LARGE_F32_RES:g}, two runs equal bitwise, zeros above both "
          f"diagonals")
    err = max_abs(L, L32p)
    del L, J, L2, J2, L32p, L64p, J64p, A64
    ms = cuda_ms(lambda: panel_chol.chol_inv(A32), 5)
    plain_ms = cuda_ms(lambda: panel_chol.chol_inv_plain(A32), 5)
    (b_ms, b_by), (s_ms, s_by) = gram_chol_bounds(m=M_LARGE, gram=False)
    print(f"time chol_inv f32 M={M_LARGE}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}), SIMT bound {s_ms:.3f} ms ({s_by}) ({CARD})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_simt": s_ms}


# rows 2 and 3 in f32: (M, B, D) of the parity checks of both kernels of
# each, the path's block first, then M and B ragged against the 128-wide
# tiles and 128-point blocks of the tensor-core kernels (and D below 8)
EPI_PARITY = ((M, BLOCK, D), (M + 2, BLOCK + 1, D), (150, 1001, 3))


def parity_epilogue_parts(maps: dict, inputs, which: str) -> None:
    """Rows 2 (``which`` "fwd") and 3 ("bwd") in f32: the tensor-core kernel
    ("mma", the path's) and the SIMT kernel ("simt") on every map at each
    shape of ``EPI_PARITY``, against the plain version in f64 on the same
    inputs and (at D = 8) in f32: relative to the largest entry, 1e-4
    forward and 1e-3 pullback, today's limits; each run twice, equal
    bitwise.  ``inputs(m, b, dtype, d)`` makes the arguments."""
    limit = 1e-4 if which == "fwd" else 1e-3
    fn = svgp_epilogue.svgp_data_epilogue if which == "fwd" else svgp_epilogue.svgp_data_epilogue_bwd
    plain = (svgp_epilogue.svgp_data_epilogue_plain if which == "fwd"
             else svgp_epilogue.svgp_data_epilogue_bwd_plain)
    what = "svgp_data_epilogue" + ("" if which == "fwd" else "_bwd")
    for m, b, d in EPI_PARITY:
        args = inputs(m, b, torch.float32, d)
        a64 = [a.double() for a in args]
        for name, kmap in maps.items():
            ref64 = plain(*a64, kmap)
            ref32 = plain(*args, kmap) if d == D else None
            for part in ("mma", "simt"):
                got = fn(*args, kmap, part)
                again = fn(*args, kmap, part)
                torch.cuda.synchronize()
                e64 = max(rel_err(g, r) for g, r in zip(got, ref64))
                e32 = max(rel_err(g, r) for g, r in zip(got, ref32)) if ref32 else 0.0
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                check(e64 <= limit and e32 <= limit and same,
                      f"{what} {part} f32 M={m} B={b} D={d} {name}: rel err vs plain f64 "
                      f"{e64:.3e}" + (f", vs plain f32 {e32:.3e}" if ref32 else "")
                      + f" <= {limit:g}, two runs equal bitwise")


def gram_chol_bounds(m: int = M, d: int = D, gram: bool = True):
    """((ms, what bounds it) by the tensor-core count, (ms, ...) by the SIMT
    count) of row 1 (``gram``) or row 4 in f32 at (m, d): the factor and
    the triangular inverse are m³/6 FMAs each, as 3xTF32 (three TF32
    products an FMA) on the tensor cores or as f32 FMAs on the SIMT units;
    beside them row 1's Gram over the lower triangle, 3d + 1 flops and one
    exp an entry, and row 4's symmetrization, an add and a product an entry
    of the triangle; Zs (row 1) or A (row 4) read once, L and J written
    once."""
    fmas = m ** 3 / 3
    if gram:
        simt, exps, nbytes = m * m / 2 * (3 * d + 1), m * m / 2, 4 * (m * d + 2 * m * m)
    else:
        simt, exps, nbytes = m * m, 0.0, 4 * 3 * m * m
    return (bound(simt, nbytes, exps, tc_flops=2 * 3 * fmas),
            bound(simt + 2 * fmas, nbytes, exps))


def epilogue_bounds(which: str, m: int = M, b: int = BLOCK, d: int = D):
    """((ms, what bounds it) by the tensor-core count, (ms, ...) by the SIMT
    count) of row 2 ("fwd") or row 3 ("bwd") in f32 at (m, b, d): the
    forward's quadratic form over Se's triangle is m²b/2 FMAs, the
    pullback's Se·K0 m²b and S̄e m²b/2; as 3xTF32 (three TF32 products an
    FMA) on the tensor cores, or as f32 FMAs on the SIMT units.  Beside
    them: K0's 3d + 1 flops and one exp an entry, mu (or āe) m·b FMAs, and
    each input read once and each output written once."""
    fmas = m * m * b / 2 if which == "fwd" else 1.5 * m * m * b
    simt = 2 * m * b + b * m * (3 * d + 1)
    nbytes = (4 * (b * d + m * d + m * m + m + 2 * b) if which == "fwd"
              else 4 * (2 * (b * d + m * d + m * m + m) + 2 * b))
    return (bound(simt, nbytes, b * m, tc_flops=2 * 3 * fmas),
            bound(simt + 2 * fmas, nbytes, b * m))


def time_epilogue_parts(what: str, run, run_plain, reps: int) -> dict:
    """Row 2's or row 3's kernels at the path's shape (f32, M = 2048,
    B = 16384, D = 8): the tensor-core kernel, the SIMT kernel and the plain
    version in one run (CUDA-event medians), beside both bounds."""
    which = "fwd" if what == "svgp_data_epilogue" else "bwd"
    ms = {part: cuda_ms(lambda: run(part), reps) for part in ("mma", "simt")}
    plain_ms = cuda_ms(run_plain, reps)
    (b_ms, b_by), (s_ms, s_by) = epilogue_bounds(which)
    print(f"time {what} f32 M={M} B={BLOCK} D={D}: mma {ms['mma']:.3f} ms, simt "
          f"{ms['simt']:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
          f"SIMT bound {s_ms:.3f} ms ({s_by})")
    return {"ms": ms["mma"], "ms_simt": ms["simt"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_simt": s_ms}


def plain_pullback(Xq, Zk, V, W, kmap, rows: int):
    """(X̄q, Z̄k, V̄) of ⟨W, K(Xq, Zk)·V⟩ by autograd through the plain
    version, ``rows`` query rows at a time: the whole graph at
    N = M = 10^5 would not fit the card."""
    Zk, V = Zk.detach().requires_grad_(), V.detach().requires_grad_()
    gx, gz, gv = [], torch.zeros_like(Zk), torch.zeros_like(V)
    for i in range(0, Xq.shape[0], rows):
        xq = Xq[i:i + rows].detach().requires_grad_()
        out = gram_matvec.gram_matvec_plain(xq, Zk, V, kmap)
        a, b, c = torch.autograd.grad(out, (xq, Zk, V), W[i:i + rows])
        gx.append(a)
        gz += b
        gv += c
    return torch.cat(gx), gz, gv


def matvec_work(N: int, M: int, D: int, R: int, elt: int = 4):
    """(flops, bytes, exps) of one pass out = h(r²(Xq, Zk))·V: an entry
    costs D subtractions and D FMAs, the scaling of r² and R FMAs (two flops
    each) and one exp; each input read once and the output written once."""
    return N * M * (3 * D + 1 + 2 * R), elt * (N * D + M * D + M * R + N * R), N * M


def matvec_bound(N: int, M: int, D: int, R: int, part: str, elt: int = 4):
    """(ms, what bounds it) of one pass by the count of the kernel that runs
    it: an entry's exp, its 3D + 1 SIMT flops of r², and its R products,
    as 2R SIMT flops on the narrow pass ("simt") or 3·R FMAs of 3xTF32 on
    the tensor cores on the wide one ("mma"); the bytes as in matvec_work."""
    flops, nbytes, exps = matvec_work(N, M, D, R, elt)
    if part == "mma":
        return bound(flops - 2 * R * N * M, nbytes, exps, tc_flops=2 * 3 * R * N * M)
    return bound(flops, nbytes, exps)


def self_bwd_work(N: int, D: int, R: int, elt: int = 4):
    """(SIMT flops, bytes, exps, tensor-core flops) of the self-Gram's
    pullback, counted over the N(N+1)/2 unordered pairs the function needs:
    K and the weights g′_ij·c_ij are symmetric, so one exp (g and g′ from
    it), its 3D + 1 flops of r² and the product g′·c serve both rows of a
    pair, with D FMAs of X̄ on each side (x_i − x_j flips sign) on the SIMT
    units; on the tensor cores (3xTF32) c's depth of 2R and R (V̄) FMAs on
    each side; X, V and Ō read once, V̄ and X̄ written once."""
    pairs = N * (N + 1) // 2
    return (pairs * (7 * D + 2), elt * (2 * N * D + 3 * N * R), pairs, pairs * 2 * 3 * 4 * R)


def bound(flops: float, nbytes: float, exps: float = 0.0, tc_flops: float = 0.0):
    """(ms, what bounds it): the least time the card could take, the larger
    of the operations over the peak rate of their unit (SIMT f32, special
    functions, TF32 tensor cores) and the bytes over the memory rate."""
    ops_ms = 1e3 * max(flops / PEAK_F32, exps / PEAK_SFU, tc_flops / PEAK_TF32)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def parity_gram_matvec(dev, maps: dict) -> dict:
    """Kernel 5 against its plain version: f64 at N = 8192 (every map, g,
    g′ and r²·g′, the pullback on the self-Gram), then f32 at the path's
    shape, N = M = 10^5 and D = 2 on the SE map (g at every width, r²·g′ at
    R = 1 and 16), with the times of R = 1, R = 16 and one pullback at
    R = 16."""
    rng = np.random.default_rng(SEED + 6)
    t = lambda a, dtype=torch.float64: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    X64 = t(rng.uniform(0.0, 10.0, (N_GP64, D_GP)))
    Z64 = t(rng.uniform(0.0, 10.0, (N_GP64 * 7 // 8 + 9, D_GP)))  # M ragged against the tiles
    for name, kmap in maps.items():
        worst = 0.0
        for R in (1, 16):
            V = t(rng.standard_normal((Z64.shape[0], R) if R > 1 else Z64.shape[0]))
            for deriv in (0, 1, 2):
                got = gram_matvec.gram_matvec_pass(X64, Z64, V, kmap, deriv)
                worst = max(worst, rel_err(got, gram_matvec.gram_matvec_plain(X64, Z64, V, kmap,
                                                                               deriv)))
        check(worst <= 1e-12, f"gram_matvec f64 N={N_GP64} M={Z64.shape[0]} D={D_GP} {name}, "
              f"g, g' and r2*g', R = 1 and 16: rel err {worst:.3e} <= 1e-12")
    names = ("Xq_bar", "Zk_bar", "V_bar")
    V64, W64 = t(rng.standard_normal((N_GP64, 16))), t(rng.standard_normal((N_GP64, 16)))
    for name in ("se", "matern12", "matern52"):
        got = gram_matvec.gram_matvec_bwd(X64, X64, V64, W64, maps[name])
        ref = plain_pullback(X64, X64, V64, W64, maps[name], rows=N_GP64)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        check(max(errs) <= 1e-10, f"gram_matvec pullback f64 self-Gram N={N_GP64} R=16 {name}: "
              "rel err " + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)) + " <= 1e-10")

    # the self-Gram's one-pass pullback in f32 on every map, against the f64
    # plain pullback (X̄ = X̄q + Z̄k), R = 1, 16 and 48 (two column chunks)
    X32 = X64.float()
    for name, kmap in maps.items():
        errs = []
        for R in (1, 16, 48):
            V32, W32 = (t(rng.standard_normal((N_GP64, R)), torch.float32) for _ in range(2))
            before = gram_matvec.gram_matvec.launches
            got = gram_matvec.gram_matvec_self_bwd(X32, V32, W32, kmap)
            one = gram_matvec.gram_matvec.launches == before + 1
            ref = plain_pullback(X32.double(), X32.double(), V32.double(), W32.double(), kmap,
                                 rows=N_GP64)
            errs.append((R, rel_err(got[0], ref[0] + ref[1]), rel_err(got[1], ref[2]), one))
        check(all(max(ex, ev) <= 1e-4 and one for _, ex, ev, one in errs),
              f"gram_matvec self-Gram pullback f32 N={N_GP64} {name}, one launch, against f64: "
              + ", ".join(f"R={R} X {ex:.3e} V {ev:.3e}" for R, ex, ev, _ in errs) + " <= 1e-4")

    se = maps["se"]
    X = t(rng.uniform(0.0, 10.0, (N_GP, D_GP)), torch.float32)
    out = {}
    # both f32 pass kernels at the path's shape: checked, run twice (bitwise),
    # timed, to place the crossover that pass_part holds
    times = {}
    for R in GMV_CROSSOVER_R:
        V = t(rng.standard_normal((N_GP, R) if R > 1 else N_GP), torch.float32)
        ref = gram_matvec.gram_matvec_plain(X, X, V, se)
        results = {}
        for part in ("simt", "mma"):
            run = lambda: gram_matvec.gram_matvec_pass(X, X, V, se, part=part)  # noqa: E731
            got = results[part] = run()
            e = rel_err(got, ref)
            check(e <= 1e-5 and torch.equal(got, run()),
                  f"gram_matvec {part} f32 N=M={N_GP} D={D_GP} R={R} se: rel err {e:.3e} <= 1e-5, "
                  "two runs equal bitwise")
            times[part, R] = cuda_ms(run, 5)
        print(f"time gram_matvec f32 N=M={N_GP} D={D_GP} R={R}: simt {times['simt', R]:.3f} ms, "
              f"mma {times['mma', R]:.3f} ms (pass_part: {gram_matvec.pass_part(R)})")
        if R in GMV_TIMED_R:
            part = gram_matvec.pass_part(R)
            plain_ms = cuda_ms(lambda: gram_matvec.gram_matvec_plain(X, X, V, se), 2)
            b_ms, b_by = matvec_bound(N_GP, N_GP, D_GP, R, part)
            s_ms = bound(*matvec_work(N_GP, N_GP, D_GP, R))[0]
            print(f"time gram_matvec f32 N=M={N_GP} D={D_GP} R={R}: {part} pass "
                  f"{times[part, R]:.3f} ms, plain {plain_ms:.3f} ms, SIMT bound {s_ms:.3f} ms, "
                  f"bound {b_ms:.3f} ms ({b_by})")
            out[f"r{R}"] = {"max_abs_err": max_abs(results[part], ref),
                            "part": part, "ms": times[part, R], "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_simt": s_ms}
    # the r²·g′ pass (the lengthscale's cotangent of every θ-only pullback) on
    # the kernel each width takes
    for R in (1, 16):
        V = t(rng.standard_normal((N_GP, R) if R > 1 else N_GP), torch.float32)
        part = gram_matvec.pass_part(R)
        got = gram_matvec.gram_matvec_pass(X, X, V, se, deriv=2, part=part)
        e = rel_err(got, gram_matvec.gram_matvec_plain(X, X, V, se, deriv=2))
        check(e <= 1e-5, f"gram_matvec {part} f32 N=M={N_GP} D={D_GP} R={R} se, r2*g' map: "
              f"rel err {e:.3e} <= 1e-5")
    faster = [R for R in GMV_CROSSOVER_R if times["mma", R] < times["simt", R]]
    print(f"crossover: the mma pass is faster at R = {faster}; "
          f"pass_part takes it from R = {gram_matvec.MMA_FROM_R}")
    V, W = (t(rng.standard_normal((N_GP, 16)), torch.float32) for _ in range(2))
    ref = plain_pullback(X, X, V, W, se, rows=2048)
    # the general Function's pullback: the transposed pass and two coordinate passes
    got = gram_matvec.gram_matvec_bwd(X, X, V, W, se)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    check(max(errs) <= 1e-4, f"gram_matvec pullback f32 N=M={N_GP} D={D_GP} R=16 se: rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)) + " <= 1e-4")
    ms = cuda_ms(lambda: gram_matvec.gram_matvec_bwd(X, X, V, W, se), 3)
    plain_ms = cuda_ms(lambda: plain_pullback(X, X, V, W, se, rows=2048), 1)
    # the transposed pass at R = 16 and two derivative passes at (1 + D)·16
    works = [matvec_work(N_GP, N_GP, D_GP, R) for R in (16, 48, 48)]
    b_ms, b_by = bound(sum(w[0] for w in works),
                       4 * (4 * N_GP * D_GP + 3 * N_GP * 16), sum(w[2] for w in works))
    print(f"time gram_matvec pullback f32 N=M={N_GP} D={D_GP} R=16: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    out["bwd"] = {"max_abs_err": max(max_abs(g, r) for g, r in zip(got, ref)), "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    # the self-Gram's pullback in one pass: X̄ = X̄q + Z̄k and V̄
    run = lambda: gram_matvec.gram_matvec_self_bwd(X, V, W, se)  # noqa: E731
    before = gram_matvec.gram_matvec.launches
    got = run()
    one = gram_matvec.gram_matvec.launches == before + 1
    refs = (ref[0] + ref[1], ref[2])
    errs = [rel_err(g, r) for g, r in zip(got, refs)]
    again = run()
    check(max(errs) <= 1e-4 and one and all(torch.equal(a, b) for a, b in zip(got, again)),
          f"gram_matvec self-Gram pullback f32 N=M={N_GP} D={D_GP} R=16 se, one launch: rel err "
          f"X {errs[0]:.3e}, V {errs[1]:.3e} <= 1e-4, two runs equal bitwise")
    ms = cuda_ms(run, 3)
    plain_ms = cuda_ms(lambda: gram_matvec.gram_matvec_self_bwd_plain(X, V, W, se), 1)
    flops, nbytes, exps, tc = self_bwd_work(N_GP, D_GP, 16)
    b_ms, b_by = bound(flops, nbytes, exps, tc_flops=tc)
    s_ms = bound(flops + tc / 3, nbytes, exps)[0]
    print(f"time gram_matvec self-Gram pullback f32 N=M={N_GP} D={D_GP} R=16: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, SIMT bound {s_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    out["bwd_self"] = {"max_abs_err": max(max_abs(g, r) for g, r in zip(got, refs)), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_ms_simt": s_ms}
    # the kernels line reports R = 16, the shape of the probe blocks (every
    # Lanczos step and the probe solves), beside R = 1, R = 32 (the serve's
    # cross solve) and both pullbacks
    numbers = dict(out["r16"])
    for part in ("r1", "r32", "bwd", "bwd_self"):
        numbers.update({f"{k}_{part}": v for k, v in out[part].items() if k != "max_abs_err"})
    return numbers


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
        check(launches == only(gram_chol_inv=1, svgp_data_epilogue=n_blocks),
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


def headline_batches(dev, seed: int):
    """Phase 5's data (10^6 points N(0, 1) in D = 8, y = sin(x_0) + 0.1·N(0, 1))
    and a generator of fresh minibatches gathered on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N_DATA, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + NOISE * torch.randn((N_DATA,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, N_DATA, (BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    return batches


def phase_minibatch(dev) -> dict:
    rng = np.random.default_rng(SEED + 2)
    params = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)), "m": np.zeros(M),
              "A": np.eye(M)}  # bench.py::_svgp_params
    batches = headline_batches(dev, SEED + 3)

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
    check(launches == only(gram_chol_inv=STEPS),
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


def stream_calls(dev) -> int:
    """Fused-epilogue calls of phase 6's data term: its blocks of 16384, as
    many a call as ``streaming_data_term`` groups at (M, D) in f32 on this
    card (the pullback's scratch decides)."""
    n_blocks = N_STREAM // BLOCK
    k = svgp_streaming._fused_blocks_per_call(n_blocks, BLOCK, M, D, torch.float32, dev)
    return -(-n_blocks // k)


def phase_streaming(dev) -> dict:
    params = slice_params()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((N_STREAM, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0])
    lik = tgp.GaussianLikelihood(NOISE)

    def loss_fn(p):
        sva, _ = bench_sva(p)
        return -tgp.streaming_elbo(sva, lik, x, y, block_size=BLOCK)

    n_blocks, calls = N_STREAM // BLOCK, stream_calls(dev)
    reset_counts()
    v, g = value_and_grad(loss_fn, leaf_params(params, dev, torch.float32))
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"streaming launches: {launches}")
    check(launches == only(svgp_data_epilogue=calls, svgp_data_epilogue_bwd=calls,
                           chol_inv=1),
          f"kernel 4 launched once, the epilogue forward and backward {calls} times each "
          f"(one call a group of the {n_blocks} blocks)")
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


def phase_exact_gp(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = 10.0 * torch.rand((N_GP, D_GP), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((N_GP,), generator=gen, device=dev)
    xs = 10.0 * torch.rand((GP_N_TEST, D_GP), generator=gen, device=dev)
    probes = iterative.rademacher_probes(gen, GP_PROBES, N_GP, torch.float32, dev)
    theta0 = convert.from_jax_params(GP_THETA, device=dev, dtype=torch.float32)

    def build(theta):
        return convert.build_exact_fx(theta, x)

    def serve(theta):
        with torch.no_grad():
            post = tgp.posterior_cg(build(theta), y, tol=GP_SLQ["cg_tol"], precond_rank=GP_RANK,
                                    block_size=GP_SLQ["block_size"])
            return post.mean_and_var(xs)

    # the path, counted: the hyperparameter steps, then the serve
    reset_counts()
    step, init = tgp.make_slq_hyperopt_step(build, y, None, learning_rate=GP_LR,
                                            precond_rank=GP_RANK, refresh_every=GP_REFRESH,
                                            probes=probes, **GP_SLQ)
    carry, init_ms = timed(lambda: init(theta0.clone()))
    Lk0 = carry[2].clone()
    losses, step_ms = [], []
    for _ in range(GP_STEPS):
        (carry, loss), ms = timed(lambda: step(carry))
        losses.append(loss)
        step_ms.append(ms)
    train = dict(iterative.stats)
    theta = carry[0].detach()
    (mu, var), serve_ms = timed(lambda: serve(theta))
    launches = read_counts()
    stats, passes = dict(iterative.stats), dict(gram_matvec.pullback_passes)
    serve_stats = {k: stats[k] - train[k] for k in stats}
    print(f"exact GP launches: {launches}; matvecs {stats['matvec_fused']} fused, "
          f"{stats['matvec_plain']} plain; pullbacks {passes['calls']} with {passes['passes']} "
          "passes")
    print(f"exact GP CG: training {train['cg_solves']} solves, {train['cg_iterations']} "
          f"iterations, {train['cg_host_syncs']} host syncs in {GP_STEPS} steps; serve "
          f"{serve_stats['cg_solves']} solves, {serve_stats['cg_iterations']} iterations, "
          f"{serve_stats['cg_host_syncs']} host syncs")
    check(launches["gram_matvec"] == stats["matvec_fused"] + passes["passes"]
          and stats["matvec_plain"] == 0
          and all(n == 0 for k, n in launches.items() if k != "gram_matvec"),
          f"every matvec of the path on kernel 5: {launches['gram_matvec']} launches = "
          f"{stats['matvec_fused']} matvecs + {passes['passes']} pullback passes, "
          "0 on the plain block path")
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all() and torch.isfinite(theta).all()),
          f"{GP_STEPS} hyperparameter steps: losses and θ finite (loss {losses[0].item():.6g} -> "
          f"{losses[-1].item():.6g}, variance, lengthscale, noise "
          f"{[round(v, 5) for v in softplus(theta).tolist()]})")
    check(mu.shape == var.shape == (GP_N_TEST,)
          and bool(torch.isfinite(mu).all() and torch.isfinite(var).all()),
          f"posterior_cg mean and variance finite at {GP_N_TEST} points")
    print(f"time exact GP (kernels): init {init_ms:.3f} ms (rank-{GP_RANK} factor), steps "
          + ", ".join(f"{m:.3f}" for m in step_ms) + f" ms; serve {serve_ms:.3f} ms "
          f"(posterior_cg build + mean_and_var at {GP_N_TEST} points)")

    # step 1 against the plain path on the card: the same probes and factor
    def value_and_grad(use: bool, th, xx, yy, pp, Lk, **kw):
        th = th.clone().requires_grad_()
        with tgp.config_context(use_kernels=use):
            v = -tgp.logpdf_slq(convert.build_exact_fx(th, xx), yy, probes=pp, precond_Lk=Lk,
                                **kw)
            return v.detach(), torch.autograd.grad(v, th)[0]

    v, g = value_and_grad(True, theta0, x, y, probes, Lk0, **GP_SLQ)
    (v0, g0), plain_step_ms = timed(lambda: value_and_grad(False, theta0, x, y, probes, Lk0,
                                                           **GP_SLQ))
    ev, eg = abs(v.item() - v0.item()) / abs(v0.item()), rel_err(g, g0)
    check(ev <= GP_RTOL and eg <= GP_RTOL,
          f"exact GP step 1, kernels vs plain path f32: rel err loss {ev:.3e}, dθ {eg:.3e} "
          f"<= {GP_RTOL:g}")
    (mu0, var0), plain_serve_ms = timed(lambda: _plain(serve, theta))
    emu = rel_err(mu, mu0)
    evar = max_abs(var, var0) / softplus(theta[0]).item()
    check(emu <= GP_RTOL and evar <= GP_RTOL,
          f"posterior_cg at {GP_N_TEST} points, kernels vs plain path f32: rel err mu "
          f"{emu:.3e}, max|d var| / prior variance {evar:.3e} <= {GP_RTOL:g}")
    print(f"time exact GP (plain, once): value and gradient {plain_step_ms:.3f} ms, serve "
          f"{plain_serve_ms:.3f} ms")
    # what f32 can give here: both paths against the f64 path on the same
    # (f32) data, with CG run to 1e-10
    with torch.no_grad():
        mu64 = tgp.posterior_cg(convert.build_exact_fx(theta.double(), x.double()), y.double(),
                                tol=1e-10, precond_rank=GP_RANK,
                                block_size=GP_SLQ["block_size"]).mean_and_var(xs.double())[0]
    ek, ep = rel_err(mu, mu64), rel_err(mu0, mu64)
    check(max(ek, ep) <= GP_RTOL,
          f"posterior_cg mean at {GP_N_TEST} points against the f64 path (N={N_GP}, CG tol "
          f"1e-10): rel err kernels {ek:.3e}, plain {ep:.3e} <= {GP_RTOL:g}")

    # f64 at N = 8192: the kernel path against the plain path, the dense
    # exact logpdf and the dense exact posterior
    x64, y64, p64 = x[:N_GP64].double(), y[:N_GP64].double(), probes[:, :N_GP64].double()
    th64 = theta0.double()
    fx64 = convert.build_exact_fx(th64, x64)
    Lk64 = iterative.pivoted_cholesky(fx64.f.kernel, x64, GP_RANK)
    kw64 = dict(GP_SLQ, cg_tol=1e-10, cg_maxiter=1000)
    v64, g64 = value_and_grad(True, th64, x64, y64, p64, Lk64, **kw64)
    v64p, g64p = value_and_grad(False, th64, x64, y64, p64, Lk64, **kw64)
    ev, eg = abs(v64.item() - v64p.item()) / abs(v64p.item()), rel_err(g64, g64p)
    check(ev <= 1e-8 and eg <= 1e-8,
          f"exact GP f64 N={N_GP64}, kernels vs plain path: rel err loss {ev:.3e}, dθ {eg:.3e} "
          "<= 1e-8")
    exact = -tgp.logpdf(fx64, y64).item()
    e = abs(v64.item() - exact) / abs(exact)
    check(e <= 0.05, f"exact GP f64 N={N_GP64}: SLQ loss {v64.item():.8g} against the dense "
          f"exact {exact:.8g}, rel err {e:.3e} <= 0.05")
    with torch.no_grad():
        mu64, var64 = tgp.posterior_cg(fx64, y64, tol=1e-10, precond_rank=GP_RANK).mean_and_var(
            xs.double())
        mu64d, var64d = tgp.posterior(fx64, y64).mean_and_var(xs.double())
    emu = rel_err(mu64, mu64d)
    evar = max_abs(var64, var64d) / softplus(th64[0]).item()
    check(emu <= 1e-6 and evar <= 1e-6,
          f"posterior_cg f64 N={N_GP64} vs the dense exact posterior: rel err mu {emu:.3e}, "
          f"max|d var| / prior variance {evar:.3e} <= 1e-6")
    print(f"exact GP timing summary: step {statistics.median(step_ms):.3f} ms (median of "
          f"{GP_STEPS}, kernels) vs {plain_step_ms:.3f} ms (plain value and gradient, once); "
          f"serve {serve_ms:.3f} ms vs {plain_serve_ms:.3f} ms")
    return launches


def band_windows(X: torch.Tensor, k: int):
    """Previous-k windows (N, D, k+1) of the points X (N, D) and their
    (N, k) mask, as the JAX package's tests build them."""
    N = X.shape[0]
    idx = torch.arange(N, device=X.device)[:, None] - k + torch.arange(k, device=X.device)
    xw = torch.cat([X[idx.clamp(min=0)], X[:, None, :]], dim=1).transpose(1, 2).contiguous()
    return xw, (idx >= 0).to(X.dtype)


def band_work(valid: torch.Tensor, D: int, sfu_per_pair: int, in_bytes: float, elt: int):
    """(flops, bytes, special-function results) of the band kernel on these
    windows, counted from its loops: (k+1)(k)(k−1)/6 + (k+1)k/2 FMAs for the
    factor and k(k−1)/2 for the back substitution; for each pair of valid
    slots D differences and D FMAs, about 4 flops of the map and its sqrt and
    exp (SE: the exp alone); the band written once."""
    N, k = valid.shape
    kp1 = k + 1
    fmas = kp1 * (kp1 - 1) * (kp1 - 2) // 6 + kp1 * (kp1 - 1) // 2 + k * (k - 1) // 2
    nv = valid.double().sum(dim=1) + 1
    pairs = float((nv * (nv - 1) / 2).sum())
    return N * 2 * fmas + pairs * (3 * D + 4), in_bytes + elt * N * kp1, pairs * sfu_per_pair


def parity_vecchia_band(dev) -> None:
    """Phase 8 (a): the band kernel against its plain version on the card,
    f64 and f32, every map, both layouts (row 10's has no nugget_self
    switch) and a broadcast mask (``predict_knn``'s, on the windows past the
    first k), no nugget and a nugget with and without slot k, k on both sides
    of each template width's edge, N ragged against every width's block;
    previous-k windows of points about a lengthscale apart, every tenth a
    copy of the one before (a deflated pivot), the first k rows masked (those
    slots must be exactly 0).  Each f32 call runs twice and gives the same
    bits."""
    rng = np.random.default_rng(SEED + 8)
    maps = [cls().kernel_map() for cls in (tk.SqExponentialKernel, tk.Matern12Kernel,
                                           tk.Matern32Kernel, tk.Matern52Kernel)]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, BAND_RTOL32)):
        for D, k, N in BAND_PARITY:
            X = (np.cumsum(rng.uniform(0.5, 1.5, (N, 1)), axis=0) if D == 1
                 else rng.uniform(0.0, 4.0 * N ** (1.0 / D), (N, D)))
            X[1::10] = X[0::10][: X[1::10].shape[0]]
            xw, valid = band_windows(torch.tensor(X, dtype=dtype, device=dev), k)
            xwT, validT = xw.permute(1, 2, 0).contiguous(), valid.T.contiguous()
            ones = valid.new_ones(()).expand(N - k, k)
            worst, zeros, repeats = 0.0, True, True
            for kmap in maps:
                for nugget, self_ in ((None, True), (0.1, False), (0.1, True)):
                    nug = None if nugget is None else torch.tensor([nugget], dtype=dtype,
                                                                   device=dev)
                    ref = batched_chol.vecchia_band_plain(xw, valid, kmap, nug, self_)
                    runs = [(lambda: batched_chol.vecchia_band(xw, valid, kmap, nug, self_), ref,
                             valid),
                            (lambda: batched_chol.vecchia_band(xw[k:], ones, kmap, nug, self_),
                             ref[k:], ones)]
                    if self_:
                        runs.append((lambda: batched_chol.vecchia_band_t(xwT, validT, kmap, nug),
                                     ref, valid))
                    for run, want, mask in runs:
                        got = run()
                        if dtype == torch.float32:
                            repeats = repeats and torch.equal(got, run())
                        worst = max(worst, rel_err(got, want))
                        zeros = zeros and bool((got[:, :k][mask == 0] == 0).all())
            before = EARLIER_BAND_ERR.get((str(dtype)[6:], D, k))
            check(worst <= tol and zeros and repeats,
                  f"vecchia_band {str(dtype)[6:]} N={N} D={D} k={k}, 4 maps, both layouts and a "
                  f"broadcast mask, no nugget / nugget with and without slot k: rel err "
                  f"{worst:.3e} <= {tol:g} (the earlier kernel's "
                  + ("not measured" if before is None else f"{before:.3e}") + "), masked slots "
                  "exactly 0" + (", two calls equal bitwise" if dtype == torch.float32 else ""))


def counted(fn, launches: dict):
    """Run ``fn`` with every count from 0 and add its launches to
    ``launches``; returns (result, this run's counts)."""
    reset_counts()
    res = fn()
    torch.cuda.synchronize()
    got = read_counts()
    for k in launches:
        launches[k] += got[k]
    return res, got


def phase_vecchia(dev) -> tuple[dict, dict]:
    """Phase 8: the Vecchia serving slice.  Returns (the path runs'
    launches, the numbers of the kernels line)."""
    parity_vecchia_band(dev)
    launches = {k: 0 for k in COUNTERS}
    only_band = lambda got: got["vecchia_band"] == 1 and sum(got.values()) == 1  # noqa: E731
    f32 = torch.float32

    def plain(fn):
        """``fn`` on the plain path, host-timed once; it launches nothing."""
        reset_counts()
        with tgp.config_context(use_kernels=False):
            res, ms = timed(fn)
        check(sum(read_counts().values()) == 0, "the plain path launched no kernel")
        return res, ms

    # (b) the band build: bench.py::vecchia_build
    x = torch.linspace(0.0, float(N_VEC), N_VEC, device=dev)
    m32 = tgp.Matern32Kernel()
    build = lambda: tgp.approx_root_prec_band(x, VEC_K, m32, block_size=VEC_BLOCK)  # noqa: E731
    band, got = counted(build, launches)
    check(only_band(got), f"band build N={N_VEC} k={VEC_K}: vecchia_band launched once, "
          f"nothing else ({got})")
    band0, build_plain_ms = plain(build)
    out_of_range = torch.arange(VEC_K)[:, None] + torch.arange(VEC_K)[None, :] < VEC_K
    e = rel_err(band, band0)
    check(bool(torch.isfinite(band).all()) and bool((band[:VEC_K, :VEC_K][out_of_range.to(dev)]
                                                      == 0).all()) and e <= VEC_RTOL,
          f"band build: finite, out-of-range slots exactly 0, kernel vs plain path rel err "
          f"{e:.3e} <= {VEC_RTOL:g}")
    build_ms = cuda_ms(build, 5)
    print(f"time band build (N={N_VEC}, k={VEC_K}): kernels {build_ms:.3f} ms, plain "
          f"{build_plain_ms:.3f} ms (once, blocks of {VEC_BLOCK})")

    # the kernel alone at the build's shape: row 10's windows, as the build makes them
    rows = [torch.cat([x[:1].expand(VEC_K - t), x[:N_VEC - VEC_K + t]]) for t in range(VEC_K)]
    xwT = torch.stack(rows + [x]).reshape(1, VEC_K + 1, N_VEC)
    iota = torch.arange(N_VEC, device=dev)
    validT = torch.stack([iota >= VEC_K - t for t in range(VEC_K)]).to(f32)
    kmap = m32.kernel_map()
    got_b = batched_chol.vecchia_band_t(xwT, validT, kmap)
    ref_b = batched_chol.vecchia_band_plain(xwT.permute(2, 0, 1), validT.T, kmap)
    numbers = {"max_abs_err": max_abs(got_b, ref_b),
               "ms": cuda_ms(lambda: batched_chol.vecchia_band_t(xwT, validT, kmap), 10),
               "plain_ms": cuda_ms(lambda: batched_chol.vecchia_band_plain(
                   xwT.permute(2, 0, 1), validT.T, kmap), 2)}
    numbers["bound_ms"], numbers["bound_by"] = bound(*band_work(
        validT.T, 1, 2, 4 * (xwT.numel() + validT.numel()), 4))
    print(f"time vecchia_band f32 at the build's shape (N={N_VEC}, k={VEC_K}, D=1, Matern-3/2, "
          f"row 10 layout): kernel {numbers['ms']:.3f} ms, plain {numbers['plain_ms']:.3f} ms, "
          f"bound {numbers['bound_ms']:.3f} ms ({numbers['bound_by']}); rel err "
          f"{rel_err(got_b, ref_b):.3e}")
    del xwT, validT, got_b, ref_b, band, band0

    # the approx_lml value: bench.py::vecchia_lml_grad's value
    y = torch.sin(x / 3.0)
    fx = convert.build_vecchia_fx(convert.from_jax_params(VEC_THETA, device=dev, dtype=f32), x)
    nn = tgp.NearestNeighbors(VEC_K, block_size=VEC_BLOCK)
    with torch.no_grad():
        lml = lambda: tgp.approx_lml(nn, fx, y)  # noqa: E731
        v, got = counted(lml, launches)
        check(only_band(got), f"approx_lml: vecchia_band launched once ({got})")
        v0, lml_plain_ms = plain(lml)
        e = abs(v.item() - v0.item()) / abs(v0.item())
        check(math.isfinite(v.item()) and e <= VEC_RTOL,
              f"approx_lml N={N_VEC}: {v.item():.8g} (kernels) vs {v0.item():.8g} (plain), rel "
              f"err {e:.3e} <= {VEC_RTOL:g}")
        lml_ms = cuda_ms(lml, 5)
    print(f"time approx_lml value (N={N_VEC}): kernels {lml_ms:.3f} ms, plain "
          f"{lml_plain_ms:.3f} ms (once)")

    # predict_knn: bench.py::vecchia_predict_knn_sweep
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    X = SWEEP_SIDE * torch.rand((N_SWEEP, 2), generator=gen, device=dev)
    Xs = SWEEP_SIDE * torch.rand((N_SWEEP, 2), generator=gen, device=dev)
    ys = torch.randn((N_SWEEP,), generator=gen, device=dev)
    theta_s = convert.from_jax_params(SWEEP_THETA, device=dev, dtype=f32)
    fxs = convert.build_vecchia_fx(theta_s, X)
    knn_kw = dict(train_block=SWEEP_TRAIN_BLOCK, test_block=SWEEP_TEST_BLOCK)
    with torch.no_grad():
        sweep = lambda: tgp.predict_knn(fxs, ys, Xs, k=VEC_K, **knn_kw)  # noqa: E731
        (mu, var), got = counted(sweep, launches)
        stats = dict(knn.stats)
        check(only_band(got), f"predict_knn: vecchia_band launched once ({got})")
        check(mu.shape == var.shape == (N_SWEEP,) and bool(torch.isfinite(mu).all())
              and bool(torch.isfinite(var).all()) and bool((var > 0).all()),
              f"predict_knn: mean and variance finite, variance positive, at {N_SWEEP} points")
        print(f"predict_knn search: {stats['tiles']} tiles, {stats['host_syncs']} host syncs of "
              f"the grid certificate, {stats['fallbacks']} fell back to the scan")
        (mu0, var0), sweep_plain_ms = plain(sweep)
        emu, evar = rel_err(mu, mu0), rel_err(var, var0)
        check(emu <= VEC_RTOL and evar <= VEC_RTOL,
              f"predict_knn, kernels vs plain path: rel err mu {emu:.3e}, var {evar:.3e} <= "
              f"{VEC_RTOL:g}")
        sweep_ms = cuda_ms(sweep, 3)
        idx = knn.knn_search(X, Xs, VEC_K, **knn_kw)[0]
        search_ms = cuda_ms(lambda: knn.knn_search(X, Xs, VEC_K, **knn_kw), 3)
        # after the search: the gathers, the band and the kriging sums
        krige_ms = cuda_ms(lambda: vecchia._krige(fxs, ys, Xs, idx, SWEEP_TEST_BLOCK, None), 5)
        # the kernel alone at the sweep's shape: the windows predict_knn gives it
        s = 1.0 / softplus(theta_s[1])
        pts = torch.cat([(X * s)[idx], (Xs * s)[:, None, :]], dim=1)
        xw, valid = pts.transpose(1, 2), X.new_ones(()).expand(N_SWEEP, VEC_K)
        ratio = (softplus(theta_s[2]) / softplus(theta_s[0])).reshape(1)
        band_fn = lambda: batched_chol.vecchia_band(xw, valid, kmap, ratio, False)  # noqa: E731
        got_s = band_fn()
        ref_s = batched_chol.vecchia_band_plain(xw, valid, kmap, ratio, False)
        numbers["max_abs_err_sweep"] = max_abs(got_s, ref_s)
        numbers["ms_sweep"] = cuda_ms(band_fn, 5)
        numbers["plain_ms_sweep"] = cuda_ms(
            lambda: batched_chol.vecchia_band_plain(xw, valid, kmap, ratio, False), 1)
        numbers["bound_ms_sweep"], numbers["bound_by_sweep"] = bound(*band_work(
            valid, 2, 2, 4 * (pts.numel() + 2), 4))
        print(f"time vecchia_band f32 at the sweep's shape (N={N_SWEEP}, k={VEC_K}, D=2, "
              f"nugget, row 8 layout as a view): kernel {numbers['ms_sweep']:.3f} ms, plain "
              f"{numbers['plain_ms_sweep']:.3f} ms, bound {numbers['bound_ms_sweep']:.3f} ms "
              f"({numbers['bound_by_sweep']}); rel err {rel_err(got_s, ref_s):.3e}")
        del pts, xw, got_s, ref_s, idx
    print(f"time predict_knn sweep (N=N*={N_SWEEP}, k={VEC_K}): kernels {sweep_ms:.3f} ms, plain "
          f"{sweep_plain_ms:.3f} ms (once); timed apart: the k-NN search {search_ms:.3f} ms "
          f"(host-bound: one sync a tile), the rest {krige_ms:.3f} ms (gathers, the band kernel "
          f"{numbers['ms_sweep']:.3f} ms, the kriging sums)")

    # the sparse build: bench.py::vecchia_sparse_build's predecessors at N = 2^18
    rs = np.random.default_rng(0)
    ar = np.arange(N_SPARSE)[:, None]
    offs = np.sort(rs.integers(1, 1 << 30, size=(N_SPARSE, VEC_K)) % np.maximum(ar, 1), axis=1)
    nbr = torch.tensor(np.where(ar > np.arange(VEC_K)[None, :], np.maximum(ar - 1 - offs, 0), -1),
                       device=dev)
    x0 = torch.linspace(0.0, float(N_SPARSE), N_SPARSE, device=dev)
    sparse = lambda: tgp.approx_root_prec_sparse(x0, nbr, m32)  # noqa: E731
    rep, got = counted(sparse, launches)
    check(only_band(got), f"sparse build N={N_SPARSE}: vecchia_band launched once ({got})")
    rep0, sparse_plain_ms = plain(sparse)
    e = max(rel_err(rep.coeff, rep0.coeff), rel_err(rep.diag, rep0.diag))
    check(e <= VEC_RTOL, f"sparse build, kernels vs plain path: rel err {e:.3e} <= {VEC_RTOL:g}")
    print(f"time sparse build (N={N_SPARSE}, k={VEC_K}, random predecessors): kernels "
          f"{cuda_ms(sparse, 5):.3f} ms, plain {sparse_plain_ms:.3f} ms (once)")

    # (c) f64: full conditioning against the dense exact GP, then the kernel
    # path against the plain path at N = 65536
    f64 = torch.float64
    th64 = convert.from_jax_params(VEC_THETA, device=dev, dtype=f64)
    x33 = torch.linspace(0.0, 32.0, 33, dtype=f64, device=dev)
    fx33 = convert.build_vecchia_fx(th64, x33)
    y33 = torch.sin(x33 / 3.0)
    v = tgp.approx_lml(tgp.NearestNeighbors(32), fx33, y33).item()
    exact = tgp.logpdf(fx33, y33).item()
    check(abs(v - exact) <= 1e-10 * abs(exact),
          f"f64 approx_lml N=33 k=32 (full conditioning): {v:.12g} vs the exact logpdf "
          f"{exact:.12g}, rel err {abs(v - exact) / abs(exact):.3e} <= 1e-10")
    g64 = torch.Generator(device=dev).manual_seed(SEED + 10)
    ths64 = convert.from_jax_params(SWEEP_THETA, device=dev, dtype=f64)
    X32 = 30.0 * torch.rand((32, 2), generator=g64, device=dev, dtype=f64)
    Xs32 = 30.0 * torch.rand((100, 2), generator=g64, device=dev, dtype=f64)
    fx32 = convert.build_vecchia_fx(ths64, X32)
    y32 = torch.randn((32,), generator=g64, device=dev, dtype=f64)
    mu, var = tgp.predict_knn(fx32, y32, Xs32, k=32)
    mu0, var0 = tgp.posterior(fx32, y32).mean_and_var(Xs32)
    emu, evar = rel_err(mu, mu0), rel_err(var, var0)
    check(emu <= 1e-10 and evar <= 1e-10, f"f64 predict_knn N=32 k=32 against the exact "
          f"posterior: rel err mu {emu:.3e}, var {evar:.3e} <= 1e-10")
    x64 = torch.linspace(0.0, float(N_VEC64), N_VEC64, dtype=f64, device=dev)
    kern64 = fx33.f.kernel
    reset_counts()
    b64 = tgp.approx_root_prec_band(x64, VEC_K, kern64)
    with tgp.config_context(use_kernels=False):
        b64p = tgp.approx_root_prec_band(x64, VEC_K, kern64, block_size=VEC_BLOCK)
    side = SWEEP_SIDE * math.sqrt(N_VEC64 / N_SWEEP)
    Xp = side * torch.rand((N_VEC64, 2), generator=g64, device=dev, dtype=f64)
    Xq = side * torch.rand((N_VEC64, 2), generator=g64, device=dev, dtype=f64)
    yp = torch.randn((N_VEC64,), generator=g64, device=dev, dtype=f64)
    fxp = convert.build_vecchia_fx(ths64, Xp)
    mu, var = tgp.predict_knn(fxp, yp, Xq, k=VEC_K)
    n_k = read_counts()["vecchia_band"]  # since the reset: the build's and this one
    with tgp.config_context(use_kernels=False):
        mu0, var0 = tgp.predict_knn(fxp, yp, Xq, k=VEC_K)
    eb, emu, evar = rel_err(b64, b64p), rel_err(mu, mu0), rel_err(var, var0)
    check(max(eb, emu, evar) <= 1e-12 and n_k == 2,
          f"f64 N={N_VEC64} k={VEC_K}, kernels (2 launches) vs plain path: band build rel err "
          f"{eb:.3e}, predict_knn mu {emu:.3e}, var {evar:.3e} <= 1e-12")
    print(f"vecchia launches in the path runs: {launches}")
    return launches, numbers


def bwd_windows(X: torch.Tensor, k: int):
    """Previous-k windows of the points X (N, D) as phase 9 (a) checks the
    pullback on them: the (N, k) mask (the first k rows masked) and the
    gathered (N, k+1, D) points, every third window repeating a neighbour in
    the next slot (an exact duplicate, a deflated pivot).  No window's point
    repeats a neighbour: that sets F at its floor, where roundoff decides the
    pullback on every path (u₀ = F^(−1/2) amplifies it by 1/√(8 eps))."""
    N = X.shape[0]
    ar = torch.arange(N, device=X.device)
    idx = ar[:, None] - k + torch.arange(k, device=X.device)
    rep = (ar % 3 == 0) & (idx[:, 0] >= 0)
    idx[rep, 1] = idx[rep, 0]
    pts = torch.cat([X[idx.clamp(min=0)], X[:, None, :]], dim=1)
    return pts, (idx >= 0).to(X.dtype)


def bwd_work(valid: torch.Tensor, D: int, sfu_per_pair: int, in_bytes: float, elt: int):
    """(flops, bytes, special-function results) of the pullback on these
    windows, counted from its loops: the forward's factor, three triangular
    solves of k(k−1)/2 FMAs and three k-dots; for each pair of valid slots
    its Gram entry (D differences, D FMAs, about 4 flops of the map, a sqrt
    and an exp, which also serve g′) and about 4 + 2D flops of Ḡ, r̄² and the
    two x̄w updates; x̄w and the nugget partial written once."""
    N, k = valid.shape
    kp1 = k + 1
    fmas = (kp1 * (kp1 - 1) * (kp1 - 2) // 6 + kp1 * (kp1 - 1) // 2 + 3 * k * (k - 1) // 2
            + 3 * k)
    nv = valid.double().sum(dim=1) + 1
    pairs = float((nv * (nv - 1) / 2).sum())
    return (N * 2 * fmas + pairs * (3 * D + 4 + 4 + 2 * D), in_bytes + elt * N * (D * kp1 + 1),
            pairs * sfu_per_pair)


@contextlib.contextmanager
def recompute_pullback():
    """The band's backward through its plain version, the recompute
    pullback, as the tree had it before the pullback kernel: route 2 of
    phase 9, timed beside the kernel."""
    real = batched_chol.vecchia_band_bwd_pass

    def plain(xw, valid, kmap, nugget, nugget_self, gbar, need_x=True, need_nug=True,
              per_window=False):
        x_bar, parts = batched_chol._recompute_pullback(xw, valid, kmap, nugget, nugget_self,
                                                        gbar, need_x, need_nug and nugget is not None)
        if parts is None or per_window:
            return x_bar, parts
        return x_bar, torch.sum(parts).reshape(nugget.shape)

    batched_chol.vecchia_band_bwd_pass = plain
    try:
        yield
    finally:
        batched_chol.vecchia_band_bwd_pass = real


def bwd_parity(xw, valid, kmap, g, nug, self_) -> dict:
    """The pullback kernel against its plain version on these windows: x̄w's
    error relative to its largest entry ("x"), the nugget's per-window
    shares' relative to the largest share ("p"), the total's relative to
    |Σp| ("total") and the shares' cancellation Σ|p|/|Σp| ("cancel"); for
    f32 windows also the kernel's and the f32 plain version's errors against
    the plain version in f64 on the same windows ("x64", "p64", "plain_x64",
    "plain_p64"); "layout": x̄w in the windows' strides, its masked slots
    exactly 0; "repeats": two calls give the same bits (x̄w, and the total
    is the sum of the second call's shares); "max_abs": the largest absolute
    difference."""
    got_x, got_t = batched_chol.vecchia_band_bwd(xw, valid, kmap, g, nug, self_)
    again_x, got_p = batched_chol.vecchia_band_bwd(xw, valid, kmap, g, nug, self_,
                                                   per_window=True)
    k, has_nug = valid.shape[1], nug is not None

    def plain(dtype):
        c = [None if t is None else t.to(dtype) for t in (xw, valid, nug, g)]
        return batched_chol._recompute_pullback(c[0], c[1], kmap, c[2], self_, c[3], True,
                                                has_nug)

    ref_x, ref_p = plain(xw.dtype)
    out = {"x": rel_err(got_x, ref_x), "max_abs": max_abs(got_x, ref_x),
           "layout": got_x.stride() == xw.stride() and bool(
               (got_x[:, :, :k].transpose(1, 2)[valid == 0] == 0).all()),
           "repeats": torch.equal(got_x, again_x) and (
               not has_nug or torch.equal(got_t, torch.sum(got_p).reshape(1)))}
    if has_nug:
        total = ref_p.double().sum().item()
        out.update(p=rel_err(got_p, ref_p), total=abs(got_t.item() - total) / abs(total),
                   cancel=ref_p.double().abs().sum().item() / abs(total),
                   max_abs=max(out["max_abs"], max_abs(got_p, ref_p)))
    if xw.dtype == torch.float32:
        ref64_x, ref64_p = plain(torch.float64)
        out.update(x64=rel_err(got_x, ref64_x), plain_x64=rel_err(ref_x, ref64_x))
        if has_nug:
            out.update(p64=rel_err(got_p, ref64_p), plain_p64=rel_err(ref_p, ref64_p))
    return out


def bwd_within(e: dict, tol_x: float, tol_n: float) -> bool:
    """x̄w within tol_x and the shares within tol_n of both references, and
    the total within tol_n of Σ|p| (f32) or of |Σp| (f64)."""
    f32 = "x64" in e
    ok = e["layout"] and e["repeats"] and max(e["x"], e.get("x64", 0.0)) <= tol_x
    if "p" in e:
        ok = ok and max(e["p"], e.get("p64", 0.0)) <= tol_n
        ok = ok and e["total"] <= tol_n * (e["cancel"] if f32 else 1.0)
    return ok


def parity_vecchia_band_bwd(dev) -> None:
    """Phase 9 (a): the pullback kernel against its plain version on the
    card, f64 and f32 on the same windows, every map, both layouts (row 10's
    (D, k+1, N) view and row 8's gathered (N, k+1, D) view), no nugget and a
    nugget with and without slot k, k on both sides of each template width's
    edge, N ragged against every width's block,
    masked slots and exact duplicates among the neighbours; x̄w (in the
    layout it came in, its masked slots exactly 0) and the nugget's
    cotangent, window by window and in total (:func:`bwd_parity`)."""
    rng = np.random.default_rng(SEED + 11)
    maps = [cls().kernel_map() for cls in (tk.SqExponentialKernel, tk.Matern12Kernel,
                                           tk.Matern32Kernel, tk.Matern52Kernel)]
    for D, k, N in BWD_PARITY:
        X = (np.cumsum(rng.uniform(0.5, 1.5, (N, 1)), axis=0) if D == 1
             else rng.uniform(0.0, 1.2 * N ** (1.0 / D), (N, D)))
        gn = rng.standard_normal((N, k + 1))
        for dtype, tol_x, tol_n in ((torch.float64, 1e-10, 1e-10),
                                    (torch.float32, BWD_XW_RTOL32, BWD_NUG_RTOL32)):
            # the f32 points in both precisions, so that both see the same windows
            Xt = torch.tensor(X, dtype=torch.float32, device=dev).to(dtype)
            pts, valid = bwd_windows(Xt, k)
            gathered = pts.transpose(1, 2)  # row 8's layout, a view
            rows10 = pts.permute(2, 1, 0).contiguous().permute(2, 0, 1)  # row 10's, a view
            g = torch.tensor(gn, dtype=torch.float32, device=dev).to(dtype)
            worst, ok = {}, True
            for kmap in maps:
                for nugget, self_ in ((None, True), (0.1, False), (0.1, True)):
                    nug = None if nugget is None else torch.tensor([nugget], dtype=dtype,
                                                                   device=dev)
                    for xw in (gathered, rows10):
                        e = bwd_parity(xw, valid, kmap, g, nug, self_)
                        ok = ok and bwd_within(e, tol_x, tol_n)
                        for key, val in e.items():
                            if key not in ("layout", "repeats"):
                                worst[key] = max(worst.get(key, 0.0), val)
            f32 = dtype == torch.float32
            vs64 = lambda a, b: (f" (vs f64 {worst[a]:.3e}; the f32 plain version's "  # noqa: E731
                                 f"{worst[b]:.3e})" if f32 else "")
            before = EARLIER_BWD_ERR.get((str(dtype)[6:], D, k))
            check(ok, f"vecchia_band_bwd {str(dtype)[6:]} N={N} D={D} k={k}, 4 maps, both "
                  f"layouts, no nugget / nugget with and without slot k: x̄w rel err "
                  f"{worst['x']:.3e}{vs64('x64', 'plain_x64')} <= {tol_x:g}; nugget shares "
                  f"{worst['p']:.3e}{vs64('p64', 'plain_p64')} <= {tol_n:g}, total "
                  f"{worst['total']:.3e} of |Σp| <= {tol_n:g}"
                  + (" × Σ|p|/|Σp|" if f32 else "")
                  + f" (Σ|p|/|Σp| up to {worst['cancel']:.1f}); the earlier kernel's x̄w and "
                  + ("shares not measured" if before is None
                     else f"shares {before[0]:.3e} and {before[1]:.3e}")
                  + "; x̄w in the windows' strides, masked slots exactly 0, two calls equal "
                  "bitwise")


def lml_value_and_grad(build, theta0, x, y, nn, points: bool = False):
    """(approx_lml, its θ-gradient) of the model ``build(θ, x)`` at θ0, and
    with ``points`` its gradient in the points x too."""
    theta = torch.tensor(theta0, dtype=x.dtype, device=x.device).requires_grad_()
    if points:
        x = x.detach().requires_grad_()
    v = tgp.approx_lml(nn, build(theta, x), y)
    return (v.detach(), *torch.autograd.grad(v, (theta, x) if points else (theta,)))


def train_row(dev, name: str, build, theta0, launches: dict) -> None:
    """Phase 9 (b) and (c): one bench training row at N = 10^6 on its three
    routes, checked and timed; each f32 route's lengthscale error against
    the f64 run beside the r·C its point cotangents' residue predicts."""
    x = torch.linspace(0.0, float(N_VEC), N_VEC, device=dev)
    y = torch.sin(x / 3.0)
    nn = tgp.NearestNeighbors(VEC_K, block_size=VEC_BLOCK)
    step = lambda points=False: lml_value_and_grad(build, theta0, x, y, nn, points)  # noqa: E731
    runs = {}
    runs["kernels"], got = counted(lambda: step(True), launches)
    check(got["vecchia_band"] == 1 and got["vecchia_band_bwd"] == 1 and sum(got.values()) == 2,
          f"{name}: one launch of the band kernel and one of its pullback a step ({got})")
    ms = {"kernels": cuda_ms(step, 5)}
    reset_counts()
    with recompute_pullback():
        runs["recompute route"] = step(True)
        ms["recompute"] = cuda_ms(step, 5)
    check(read_counts()["vecchia_band_bwd"] == 0, f"{name}: the recompute route launched no "
          "pullback kernel")
    reset_counts()
    with tgp.config_context(use_kernels=False):
        runs["plain"], ms["plain"] = timed(lambda: step(True))
    check(sum(read_counts().values()) == 0, f"{name}: the plain path launched no kernel")
    v64, g64, gx64 = lml_value_and_grad(build, theta0, x.double(), y.double(), nn, True)
    xg = x.double() * gx64
    C = xg.abs().sum().item() / abs(xg.sum().item())
    scale64 = g64.abs().max().item()
    for route, (v_r, g_r, gx_r) in runs.items():
        res = gx_r.double().sum().item() / gx_r.double().abs().sum().item()
        print(f"{name} {route}: gradient {g_r.tolist()}, value {v_r.item():.9g}; lengthscale "
              f"entry {abs(g_r[1].item() - g64[1].item()) / scale64:.3e} from the f64 run, r·C "
              f"{abs(res) * C * abs(g64[1].item()) / scale64:.3e} (residue r {res:.3e}, "
              f"C {C:.4g})")
    print(f"{name} f64 kernels: gradient {g64.tolist()}, value {v64.item():.12g}")
    (v, g, _), (v0, g0, _) = runs["kernels"], runs["plain"]
    g2 = runs["recompute route"][1]
    e0 = abs(v.item() - v0.item()) / abs(v0.item())
    e64 = abs(v.item() - v64.item()) / abs(v64.item())
    eg2, eg64 = rel_err(g, g2), rel_err(g, g64)
    scale0 = g0.double().abs().max().item()
    eg0_ell = abs(g[1].item() - g0[1].item()) / scale0
    eg0_other = max(abs(g[i].item() - g0[i].item()) for i in (0, 2)) / scale0
    finite = bool(torch.isfinite(g).all()) and math.isfinite(v.item())
    check(finite and max(e0, e64) <= VEC_RTOL and eg2 <= TRAIN_ROUTE_RTOL32
          and eg64 <= TRAIN_F64_RTOL32 and eg0_other <= VEC_RTOL
          and eg0_ell <= TRAIN_PLAIN_RTOL32,
          f"{name} N={N_VEC} k={VEC_K} f32: value rel err {e0:.3e} (plain), {e64:.3e} (f64) <= "
          f"{VEC_RTOL:g}; gradient rel err {eg2:.3e} (recompute route) <= "
          f"{TRAIN_ROUTE_RTOL32:g}, {eg64:.3e} (f64; the plain path's {rel_err(g0, g64):.3e}) "
          f"<= {TRAIN_F64_RTOL32:g}; against the plain path {eg0_other:.3e} (σ², τ²) <= "
          f"{VEC_RTOL:g}, {eg0_ell:.3e} (lengthscale) <= {TRAIN_PLAIN_RTOL32:g}")
    print(f"time {name} value and gradient (N={N_VEC}, k={VEC_K}): kernels {ms['kernels']:.3f} ms, "
          f"kernel forward + recompute pullback {ms['recompute']:.3f} ms (CUDA events, medians "
          f"of 5), plain {ms['plain']:.3f} ms (once)")


def phase_vecchia_train(dev) -> tuple[dict, dict]:
    """Phase 9: Vecchia training.  Returns (the path runs' launches, the
    numbers of the kernels line for the pullback kernel)."""
    parity_vecchia_band_bwd(dev)
    launches = {k: 0 for k in COUNTERS}
    f32 = torch.float32

    # (a) the pullback kernel alone at the nugget row's shape: row 10's windows
    x = torch.linspace(0.0, float(N_VEC), N_VEC, device=dev)
    s = 1.0 / softplus(torch.tensor(NUGGET_THETA[1], device=dev, dtype=f32))
    xs = x * s
    rows = [torch.cat([xs[:1].expand(VEC_K - t), xs[:N_VEC - VEC_K + t]]) for t in range(VEC_K)]
    xwT = torch.stack(rows + [xs]).reshape(1, VEC_K + 1, N_VEC)
    iota = torch.arange(N_VEC, device=dev)
    validT = torch.stack([iota >= VEC_K - t for t in range(VEC_K)]).to(f32)
    xw, valid = xwT.permute(2, 0, 1), validT.T
    th = torch.tensor(NUGGET_THETA, device=dev, dtype=f32)
    ratio = (softplus(th[2]) / softplus(th[0])).reshape(1)
    g = torch.randn((N_VEC, VEC_K + 1), generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    kmap = tk.Matern32Kernel().kernel_map()
    e = bwd_parity(xw, valid, kmap, g, ratio, True)
    check(bwd_within(e, BWD_XW_RTOL32, BWD_NUG_RTOL32),
          f"vecchia_band_bwd f32 at the training step's shape (N={N_VEC}, k={VEC_K}, D=1, "
          f"Matern-3/2, nugget, row 10 layout): x̄w rel err {e['x']:.3e} (vs f64 {e['x64']:.3e}; "
          f"the f32 plain version's {e['plain_x64']:.3e}) <= {BWD_XW_RTOL32:g}; nugget shares "
          f"{e['p']:.3e} (vs f64 {e['p64']:.3e}) <= {BWD_NUG_RTOL32:g}, total {e['total']:.3e} "
          f"of |Σp| <= {BWD_NUG_RTOL32:g} × Σ|p|/|Σp| ({e['cancel']:.1f}); x̄w in the windows' "
          "strides, masked slots exactly 0")
    numbers = {"max_abs_err": e["max_abs"],
               "ms": cuda_ms(lambda: batched_chol.vecchia_band_bwd(xw, valid, kmap, g, ratio), 10),
               "plain_ms": cuda_ms(lambda: batched_chol._recompute_pullback(
                   xw, valid, kmap, ratio, True, g, True, True), 2)}
    numbers["bound_ms"], numbers["bound_by"] = bound(*bwd_work(
        valid, 1, 2, 4 * (xwT.numel() + validT.numel() + g.numel() + 1), 4))
    print(f"time vecchia_band_bwd f32 at the training step's shape (N={N_VEC}, k={VEC_K}, D=1, "
          f"Matern-3/2, nugget, row 10 layout): kernel {numbers['ms']:.3f} ms, plain (the "
          f"recompute pullback) {numbers['plain_ms']:.3f} ms, bound {numbers['bound_ms']:.3f} ms "
          f"({numbers['bound_by']})")
    del xwT, validT, xw, valid, g, rows, xs

    # (b), (c) the two bench training rows on their three routes
    train_row(dev, "vecchia_lml_grad", convert.build_vecchia_fx, VEC_THETA, launches)
    train_row(dev, "vecchia_nugget_lml_grad", convert.build_vecchia_nugget_fx, NUGGET_THETA,
              launches)

    # (d) Adam on (c)
    y = torch.sin(x / 3.0)
    nn = tgp.NearestNeighbors(VEC_K, block_size=VEC_BLOCK)
    params = {"theta": torch.tensor(NUGGET_THETA, device=dev, dtype=f32)}
    loss = lambda p, xb, yb: -tgp.approx_lml(  # noqa: E731
        nn, convert.build_vecchia_nugget_fx(p["theta"], xb), yb)
    ((params, losses), got), adam_ms = timed(lambda: counted(
        lambda: tgp.adam_fit(loss, params, [(x, y)] * ADAM_STEPS, learning_rate=ADAM_LR),
        launches))
    losses = [v.item() for v in losses]
    check(got["vecchia_band"] == got["vecchia_band_bwd"] == ADAM_STEPS
          and all(map(math.isfinite, losses)) and bool(torch.isfinite(params["theta"]).all()),
          f"{ADAM_STEPS} Adam steps (lr {ADAM_LR:g}) on -approx_lml of the nugget model: losses "
          f"{losses}, θ {params['theta'].tolist()}, finite; launches {got}")
    print(f"time {ADAM_STEPS} Adam steps (N={N_VEC}, k={VEC_K}, nugget model): {adam_ms:.3f} ms "
          f"(host clock, first steps included)")

    # (e) the general orderings: maximin with scaled and with nearest neighbours
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    Xo = SIDE_ORDER * torch.rand((N_ORDER, 2), generator=gen, device=dev)
    yo = torch.sin(Xo[:, 0] / 3.0)
    check(tgp.native.native_available(), "the host ordering code built with g++")
    for neighbors in ("scaled", "nearest"):
        t0 = time.perf_counter()
        order = tgp.resolve_ordering(Xo, "maximin")
        Xh = Xo.cpu().numpy()
        nbr = (tgp.scaled_ball_predecessors(Xh, order, RHO, VEC_K) if neighbors == "scaled"
               else tgp.nearest_predecessor_neighbors(Xh, order, VEC_K))
        host_ms = 1e3 * (time.perf_counter() - t0)
        nn = tgp.NearestNeighbors(VEC_K, ordering="maximin", neighbors=neighbors, rho=RHO)
        step = lambda: lml_value_and_grad(  # noqa: E731
            convert.build_vecchia_nugget_fx, NUGGET_THETA, Xo, yo, nn)
        ((v, g), got), step_ms = timed(lambda: counted(step, launches))
        check(got["vecchia_band"] == 1 and got["vecchia_band_bwd"] == 1,
              f"maximin + {neighbors}: one launch of each kernel ({got})")
        reset_counts()
        with tgp.config_context(use_kernels=False):
            (v0, g0), plain_ms = timed(step)
        check(sum(read_counts().values()) == 0, "the plain path launched no kernel")
        e, eg = abs(v.item() - v0.item()) / abs(v0.item()), rel_err(g, g0)
        filled = float((torch.as_tensor(nbr) >= 0).double().mean())
        check(e <= VEC_RTOL and eg <= VEC_RTOL,
              f"maximin + {neighbors} (ρ = {RHO:g}) N={N_ORDER} D=2 k={VEC_K} f32, nugget model: "
              f"value rel err {e:.3e}, gradient {eg:.3e} <= {VEC_RTOL:g} (kernels vs plain "
              f"path; points within 256 of 0, so no entry cancels); {filled:.3f} of the slots "
              "filled")
        print(f"time maximin + {neighbors} (N={N_ORDER}): host ordering and neighbour sets "
              f"{host_ms:.3f} ms, value and gradient with them {step_ms:.3f} ms (kernels, once), "
              f"{plain_ms:.3f} ms (plain, once)")

    # (f) f64: full conditioning against the dense exact GP, then the kernel
    # path against the plain path at N = 65536
    f64 = torch.float64
    x33 = torch.linspace(0.0, 32.0, 33, dtype=f64, device=dev)
    y33 = torch.sin(x33 / 3.0)
    x64 = torch.linspace(0.0, float(N_TRAIN64), N_TRAIN64, dtype=f64, device=dev)
    y64 = torch.sin(x64 / 3.0)
    for name, build, theta0 in (("noise 0", convert.build_vecchia_fx, VEC_THETA),
                                ("nugget", convert.build_vecchia_nugget_fx, NUGGET_THETA)):
        v, g = lml_value_and_grad(build, theta0, x33, y33, tgp.NearestNeighbors(32))
        theta = torch.tensor(theta0, dtype=f64, device=dev).requires_grad_()
        ve = tgp.logpdf(build(theta, x33), y33)
        (ge,) = torch.autograd.grad(ve, theta)
        e, eg = abs(v.item() - ve.item()) / abs(ve.item()), rel_err(g, ge)
        check(e <= 1e-10 and eg <= 1e-10,
              f"f64 {name} N=33 k=32 (full conditioning) vs autograd of the dense exact logpdf: "
              f"value rel err {e:.3e}, θ-gradient {eg:.3e} <= 1e-10 ({g.tolist()})")
        nn = tgp.NearestNeighbors(VEC_K, block_size=VEC_BLOCK)
        reset_counts()
        v, g = lml_value_and_grad(build, theta0, x64, y64, nn)
        got = read_counts()
        with tgp.config_context(use_kernels=False):
            v0, g0 = lml_value_and_grad(build, theta0, x64, y64, nn)
        e, eg = abs(v.item() - v0.item()) / abs(v0.item()), rel_err(g, g0)
        check(e <= 1e-12 and eg <= 1e-10 and got["vecchia_band_bwd"] == 1,
              f"f64 {name} N={N_TRAIN64} k={VEC_K}, kernels (one pullback launch) vs plain path: "
              f"value rel err {e:.3e} <= 1e-12, θ-gradient {eg:.3e} <= 1e-10")
    print(f"vecchia training launches in the path runs: {launches}")
    return launches, numbers


def rows_grams(N: int, Dw: int, k: int, dev, dtype, point_repeats: bool):
    """Masked (Kw, kni, kdiag, valid) under Matérn-3/2 of previous-k windows
    of points about a lengthscale apart (sorted in 1-D, as the bench's): the
    first k rows masked (identity rows, zero coupling), every third window
    with a neighbour repeated in the next slot (a deflated pivot), and with
    ``point_repeats`` every tenth point a copy of the one before (F at its
    floor, where f32 roundoff decides the answer: f64 only)."""
    rng = np.random.default_rng(SEED + 13 + k)
    X = (np.cumsum(rng.uniform(0.5, 1.5, (N, 1)), axis=0) if Dw == 1
         else rng.uniform(0.0, 1.2 * N ** (1.0 / Dw), (N, Dw)))
    if point_repeats:
        X[1::10] = X[0::10][: X[1::10].shape[0]]
    idx = np.arange(N)[:, None] - k + np.arange(k)[None, :]
    if k >= 2:
        rep = (np.arange(N) % 3 == 0) & (idx[:, 0] >= 0)
        idx[rep, 1] = idx[rep, 0]
    xw = np.concatenate([X[np.clip(idx, 0, N - 1)], X[:, None, :]], axis=1).swapaxes(1, 2)
    valid = torch.tensor((idx >= 0).astype(np.float64), dtype=dtype, device=dev)
    xw = torch.tensor(np.ascontiguousarray(xw), dtype=dtype, device=dev)
    return (*batched_chol.window_gram_inputs(xw, valid, tk.Matern32Kernel().kernel_map()), valid)


def rows_work(N: int, k: int, elt: int):
    """(flops, bytes) of row 6 on N windows, counted from its loops: the
    factor's dots k(k−1)(k−2)/6, pivots k(k−1)/2 and column scalings
    k(k+1)/2 FMAs, the two substitutions k(k−1) and F's dot k; Kw's lower
    triangle, kni and kdiag read once, the band written once."""
    fmas = k * (k - 1) * (k - 2) // 6 + k * (k - 1) // 2 + k * (k + 1) // 2 + k * (k - 1) + k
    return N * 2 * fmas, elt * N * (k * (k + 1) // 2 + k + 1 + k + 1)


def parity_band_rows(dev) -> None:
    """Phase 10 (a): row 6 against the plain masked math on the same Grams,
    f64 and f32, a strided Kw beside the contiguous one; f32 also against
    the f64 plain version of the same windows."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, ROWS_RTOL32)):
        f32 = dtype == torch.float32
        for Dw, k, N in ROWS_PARITY:
            Kw, kni, kd, valid = rows_grams(N, Dw, k, dev, dtype, point_repeats=not f32)
            ref = batched_chol.masked_chol_solve_band_math(Kw, kni, kd)
            worst, zeros = 0.0, True
            for A in (Kw, Kw.transpose(1, 2).contiguous().transpose(1, 2)):
                got = batched_chol.batched_chol_solve_band(A, kni, kd)
                worst = max(worst, rel_err(got, ref))
                zeros = zeros and bool((got[:, :k][valid == 0] == 0).all())
            note = ""
            if f32:
                ref64 = batched_chol.masked_chol_solve_band_math(Kw.double(), kni.double(),
                                                                 kd.double())
                note = (f" (vs the f64 plain version {rel_err(got, ref64):.3e}; the f32 plain "
                        f"version's {rel_err(ref, ref64):.3e})")
            deflated = int((batched_chol._masked_chol_factor(Kw)[1] == 0).sum())
            check(worst <= tol and zeros,
                  f"batched_chol_solve_band {str(dtype)[6:]} B={N} D={Dw} k={k}, contiguous and "
                  f"strided Kw, {deflated} deflated pivots: rel err {worst:.3e} <= {tol:g}{note}, "
                  "masked slots exactly 0")


def phase_band_rows(dev) -> tuple[dict, dict]:
    """Phase 10: row 6 under kernels that do not unwrap and noise that is not
    a scalar.  Returns (the path runs' launches, the kernels line's numbers)."""
    parity_band_rows(dev)
    launches = {k: 0 for k in COUNTERS}
    f32, f64 = torch.float32, torch.float64

    # (a) the kernel alone at 10^6 windows, k = 32: the training path's Grams
    x = torch.linspace(0.0, float(N_VEC), N_VEC, device=dev)
    y = torch.sin(x / 3.0)
    theta = torch.tensor(RQ_THETA, device=dev, dtype=f32)
    kern = convert.build_vecchia_rq_fx(theta, x).f.kernel
    with torch.no_grad():
        Xp = x[:, None]
        Kw, kni, kd = vecchia._window_rows(Xp, vecchia._previous_k(N_VEC, VEC_K, dev),
                                           torch.arange(N_VEC, device=dev), kern,
                                           kern.diag(Xp), lambda *a: a)
        got = batched_chol.batched_chol_solve_band_pass(Kw, kni, kd)
        ref = batched_chol.masked_chol_solve_band_math(Kw, kni, kd)
        e = rel_err(got, ref)
        check(e <= ROWS_RTOL32, f"batched_chol_solve_band f32 at 10^6 windows of the RQ training "
              f"path, k={VEC_K}: rel err {e:.3e} <= {ROWS_RTOL32:g}")
        numbers = {"max_abs_err": max_abs(got, ref),
                   "ms": cuda_ms(lambda: batched_chol.batched_chol_solve_band_pass(Kw, kni, kd),
                                 10),
                   "plain_ms": cuda_ms(lambda: batched_chol.masked_chol_solve_band_math(
                       Kw, kni, kd), 2)}
        numbers["bound_ms"], numbers["bound_by"] = bound(*rows_work(N_VEC, VEC_K, 4))
    print(f"time batched_chol_solve_band f32 (B={N_VEC}, k={VEC_K}, the RQ path's Grams): kernel "
          f"{numbers['ms']:.3f} ms, plain {numbers['plain_ms']:.3f} ms, bound "
          f"{numbers['bound_ms']:.3f} ms ({numbers['bound_by']})")
    # and at the shapes of one launch of the paths: a training block, a sweep tile at k = 64
    sub = [(Kw[:VEC_BLOCK], kni[:VEC_BLOCK], kd[:VEC_BLOCK], "block", VEC_K)]
    Kt, ct, dt, _ = rows_grams(SWEEP_TEST_BLOCK, 2, HETERO_K, dev, f32, point_repeats=False)
    sub.append((Kt, ct, dt, "tile", HETERO_K))
    for A, c, d, what, kk in sub:
        numbers[f"ms_{what}"] = cuda_ms(lambda: batched_chol.batched_chol_solve_band_pass(A, c, d),
                                        20)
        numbers[f"bound_ms_{what}"], numbers[f"bound_by_{what}"] = bound(
            *rows_work(A.shape[0], kk, 4))
        print(f"time batched_chol_solve_band f32 (B={A.shape[0]}, k={kk}, one launch of the "
              f"{'training step' if what == 'block' else 'sweep'}): kernel "
              f"{numbers[f'ms_{what}']:.4f} ms, bound {numbers[f'bound_ms_{what}']:.4f} ms "
              f"({numbers[f'bound_by_{what}']})")
    del Kw, kni, kd, got, ref, sub, Kt, ct, dt

    # (b) training: the value and θ-gradient of the RQ + white model at N = 10^6
    nn = tgp.NearestNeighbors(VEC_K, block_size=VEC_BLOCK)
    n_blocks = -(-N_VEC // VEC_BLOCK)
    step = lambda points=False: lml_value_and_grad(  # noqa: E731
        convert.build_vecchia_rq_fx, RQ_THETA, x, y, nn, points)
    torch.cuda.reset_peak_memory_stats()
    (v, g, gx), got = counted(lambda: step(True), launches)
    check(got == only(batched_chol_solve_band=n_blocks),
          f"RQ approx_lml value and gradient N={N_VEC}: row 6 launched once a block "
          f"({n_blocks}), the band kernel and its pullback never ({got})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = cuda_ms(step, 3)
    reset_counts()
    with tgp.config_context(use_kernels=False):
        (v0, g0, gx0), plain_ms = timed(lambda: step(True))
    check(sum(read_counts().values()) == 0, "the plain path launched no kernel")
    # the lengthscale entry is Σᵢ xᵢ·∂L/∂xᵢ: each route's residue r of its point
    # cotangents times that sum's cancellation C (from the route's own cotangents)
    for route, (v_r, g_r, gx_r) in (("kernels", (v, g, gx)), ("plain", (v0, g0, gx0))):
        gxd = gx_r.double()
        res = gxd.sum().item() / gxd.abs().sum().item()
        xg = x.double() * gxd
        C = xg.abs().sum().item() / abs(xg.sum().item())
        print(f"RQ {route}: gradient {g_r.tolist()}, value {v_r.item():.9g}; residue r "
              f"{res:.3e}, C {C:.4g}, r·C {abs(res) * C:.3e} of the lengthscale entry")
    scale0 = g0.double().abs().max().item()
    e0 = abs(v.item() - v0.item()) / abs(v0.item())
    eg0 = max(abs(g[i].item() - g0[i].item()) for i in (0, 2, 3)) / scale0
    eg0_ell = abs(g[1].item() - g0[1].item()) / scale0
    check(bool(torch.isfinite(g).all()) and math.isfinite(v.item()) and e0 <= VEC_RTOL
          and eg0 <= VEC_RTOL and eg0_ell <= TRAIN_PLAIN_RTOL32,
          f"RQ approx_lml N={N_VEC} k={VEC_K} f32, kernels vs plain path: value rel err {e0:.3e} "
          f"<= {VEC_RTOL:g}; gradient σ², α, τ² {eg0:.3e} <= {VEC_RTOL:g}, lengthscale (the "
          f"cancelling entry) {eg0_ell:.3e} <= {TRAIN_PLAIN_RTOL32:g}")
    print(f"time RQ value and gradient (N={N_VEC}, k={VEC_K}, {n_blocks} blocks of {VEC_BLOCK}): "
          f"kernels {ms:.3f} ms (CUDA events, median of 3; peak memory {peak:.2f} GiB), plain "
          f"{plain_ms:.3f} ms (once)")
    # f64: full conditioning against the dense exact GP, the kernel path
    # against the plain path at N = 65536
    x33 = torch.linspace(0.0, 32.0, 33, dtype=f64, device=dev)
    y33 = torch.sin(x33 / 3.0)
    v33, g33 = lml_value_and_grad(convert.build_vecchia_rq_fx, RQ_THETA, x33, y33,
                                  tgp.NearestNeighbors(32))
    th = torch.tensor(RQ_THETA, dtype=f64, device=dev).requires_grad_()
    ve = tgp.logpdf(convert.build_vecchia_rq_fx(th, x33), y33)
    (ge,) = torch.autograd.grad(ve, th)
    e, eg = abs(v33.item() - ve.item()) / abs(ve.item()), rel_err(g33, ge)
    check(e <= 1e-10 and eg <= 1e-10,
          f"f64 RQ N=33 k=32 (full conditioning) vs autograd of the dense exact logpdf: value "
          f"rel err {e:.3e}, θ-gradient {eg:.3e} <= 1e-10 ({g33.tolist()})")
    x64 = torch.linspace(0.0, float(N_ROWS64), N_ROWS64, dtype=f64, device=dev)
    y64 = torch.sin(x64 / 3.0)
    reset_counts()
    v1, g1 = lml_value_and_grad(convert.build_vecchia_rq_fx, RQ_THETA, x64, y64, nn)
    got = read_counts()
    with tgp.config_context(use_kernels=False):
        v2, g2 = lml_value_and_grad(convert.build_vecchia_rq_fx, RQ_THETA, x64, y64, nn)
    e, eg = abs(v1.item() - v2.item()) / abs(v2.item()), rel_err(g1, g2)
    check(e <= 1e-12 and eg <= 1e-10 and got == only(batched_chol_solve_band=N_ROWS64 // VEC_BLOCK),
          f"f64 RQ N={N_ROWS64} k={VEC_K}, kernels ({got['batched_chol_solve_band']} launches) vs "
          f"plain path: value rel err {e:.3e} <= 1e-12, θ-gradient {eg:.3e} <= 1e-10")

    # (c) serving: predict_knn with per-point noise at k = 64 over 10^6 test points
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    X = SWEEP_SIDE * torch.rand((N_SWEEP, 2), generator=gen, device=dev)
    Xs = SWEEP_SIDE * torch.rand((N_SWEEP, 2), generator=gen, device=dev)
    ys = torch.randn((N_SWEEP,), generator=gen, device=dev)
    noise = 0.1 * (1.0 + torch.rand((N_SWEEP,), generator=gen, device=dev))
    th_h = torch.tensor(HETERO_THETA, device=dev, dtype=f32)
    fxh = convert.build_knn_hetero_fx(th_h, X, noise)
    knn_kw = dict(train_block=SWEEP_TRAIN_BLOCK, test_block=SWEEP_TEST_BLOCK)
    n_tiles = -(-N_SWEEP // SWEEP_TEST_BLOCK)
    with torch.no_grad():
        sweep = lambda: tgp.predict_knn(fxh, ys, Xs, k=HETERO_K, **knn_kw)  # noqa: E731
        (mu, var), got = counted(sweep, launches)
        check(got == only(batched_chol_solve_band=n_tiles),
              f"predict_knn k={HETERO_K}, per-point noise: row 6 launched once a tile of "
              f"{SWEEP_TEST_BLOCK} ({n_tiles}), the band kernel never ({got})")
        check(mu.shape == var.shape == (N_SWEEP,) and bool(torch.isfinite(mu).all())
              and bool(torch.isfinite(var).all()) and bool((var > 0).all()),
              f"predict_knn k={HETERO_K}: mean and variance finite, variance positive")
        reset_counts()
        with tgp.config_context(use_kernels=False):
            (mu0, var0), sweep_plain_ms = timed(sweep)
        check(sum(read_counts().values()) == 0, "the plain path launched no kernel")
        emu, evar = rel_err(mu, mu0), rel_err(var, var0)
        check(emu <= VEC_RTOL and evar <= VEC_RTOL,
              f"predict_knn k={HETERO_K}, per-point noise, kernels vs plain path: rel err mu "
              f"{emu:.3e}, var {evar:.3e} <= {VEC_RTOL:g}")
        sweep_ms = cuda_ms(sweep, 3)
        idx = knn.knn_search(X, Xs, HETERO_K, **knn_kw)[0]
        search_ms = cuda_ms(lambda: knn.knn_search(X, Xs, HETERO_K, **knn_kw), 3)
        krige_ms = cuda_ms(lambda: vecchia._krige(fxh, ys, Xs, idx, SWEEP_TEST_BLOCK, None), 3)
        del idx
    print(f"time predict_knn sweep (N=N*={N_SWEEP}, k={HETERO_K}, per-point noise): kernels "
          f"{sweep_ms:.3f} ms, plain {sweep_plain_ms:.3f} ms (once); timed apart: the k-NN "
          f"search {search_ms:.3f} ms, the rest {krige_ms:.3f} ms (window Grams, row 6 "
          f"{n_tiles} times, the kriging sums)")
    g64g = torch.Generator(device=dev).manual_seed(SEED + 16)
    side = SWEEP_SIDE * math.sqrt(N_VEC64 / N_SWEEP)
    Xp = side * torch.rand((N_VEC64, 2), generator=g64g, device=dev, dtype=f64)
    Xq = side * torch.rand((N_VEC64, 2), generator=g64g, device=dev, dtype=f64)
    yp = torch.randn((N_VEC64,), generator=g64g, device=dev, dtype=f64)
    nz = 0.1 * (1.0 + torch.rand((N_VEC64,), generator=g64g, device=dev, dtype=f64))
    fxp = convert.build_knn_hetero_fx(th_h.double(), Xp, nz)
    reset_counts()
    mu, var = tgp.predict_knn(fxp, yp, Xq, k=HETERO_K)
    got = read_counts()
    with tgp.config_context(use_kernels=False):
        mu0, var0 = tgp.predict_knn(fxp, yp, Xq, k=HETERO_K)
    emu, evar = rel_err(mu, mu0), rel_err(var, var0)
    check(max(emu, evar) <= 1e-12 and got == only(batched_chol_solve_band=N_VEC64 // 4096),
          f"f64 predict_knn N=N*={N_VEC64} k={HETERO_K}, per-point noise, kernels "
          f"({got['batched_chol_solve_band']} launches) vs plain path: rel err mu {emu:.3e}, "
          f"var {evar:.3e} <= 1e-12")
    print(f"row 6 launches in the path runs: {launches}")
    return launches, numbers


@contextlib.contextmanager
def counting_cross_grams():
    """Counts the non-symmetric Grams of stationary kernels built inside."""
    real = tk.StationaryKernel.gram
    n = [0]

    def gram_counted(self, X, Z=None):
        n[0] += Z is not None
        return real(self, X, Z)

    tk.StationaryKernel.gram = gram_counted
    try:
        yield n
    finally:
        tk.StationaryKernel.gram = real


def parity_stationary_gram(dev) -> dict:
    """Phase 11 (a): row 11 against its plain version, four maps, f64 and
    f32, pairs at r = 0; then both timed at the minibatch step's Kuf."""
    rng = np.random.default_rng(SEED + 17)
    maps = {cls.__name__: cls().kernel_map() for cls in (
        tk.SqExponentialKernel, tk.Matern12Kernel, tk.Matern32Kernel, tk.Matern52Kernel)}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, GRAM_RTOL32)):
        for N, Mg, Dg in GRAM_PARITY:
            X = torch.tensor(rng.standard_normal((N, Dg)), dtype=dtype, device=dev)
            Z = torch.tensor(rng.standard_normal((Mg, Dg)), dtype=dtype, device=dev)
            Z[:17] = X[:17]
            worst = 0.0
            for kmap in maps.values():
                got = gram.stationary_gram_pass(X, Z, kmap)
                worst = max(worst, rel_err(got, gram.stationary_gram_plain(X, Z, kmap)))
            check(worst <= tol, f"stationary_gram {str(dtype)[6:]} N={N} M={Mg} D={Dg}, 4 maps, "
                  f"17 pairs at r = 0: rel err {worst:.3e} <= {tol:g}")
    X = torch.randn((M, D), device=dev)
    Z = torch.randn((BATCH, D), device=dev)
    se = maps["SqExponentialKernel"]
    got, ref = gram.stationary_gram_pass(X, Z, se), gram.stationary_gram_plain(X, Z, se)
    run = lambda: gram.stationary_gram_pass(X, Z, se)  # noqa: E731
    numbers = {"max_abs_err": max_abs(got, ref), "ms": cuda_ms(run, 20),
               "device_ms": device_ms(run, "stationary_gram_kernel", 20),
               "plain_ms": cuda_ms(lambda: gram.stationary_gram_plain(X, Z, se), 20)}
    # a pair costs D differences and D FMAs and the map's scaling, one exp
    numbers["bound_ms"], numbers["bound_by"] = bound(M * BATCH * (3 * D + 1),
                                                     4 * (M * D + BATCH * D + M * BATCH), M * BATCH)
    print(f"time stationary_gram f32 N={M} M={BATCH} D={D} se (the step's Kuf): kernel "
          f"{numbers['ms']:.4f} ms by CUDA events around the call (before its redesign "
          f"{EARLIER_MS['stationary_gram']:.3f}), {numbers['device_ms']:.4f} ms device-only "
          f"(torch.profiler), plain {numbers['plain_ms']:.3f} ms, bound "
          f"{numbers['bound_ms']:.4f} ms ({numbers['bound_by']})")
    return numbers


def phase_fused_gram(dev) -> tuple[dict, dict]:
    """Phase 11: row 11 under the minibatch step with ``gram_mode="fused"``.
    Returns (the path runs' launches, the kernels line's numbers)."""
    numbers = parity_stationary_gram(dev)
    rng = np.random.default_rng(SEED + 2)
    params = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)), "m": np.zeros(M),
              "A": np.eye(M)}  # phase 5's
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((N_DATA, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + NOISE * torch.randn((N_DATA,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, N_DATA, (BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    xb, yb = next(batches(1))
    with counting_cross_grams() as n_cross:
        value_and_grad(minibatch_loss, leaf_params(params, dev, torch.float32), xb, yb)
    n_cross = n_cross[0]
    print(f"cross-Grams a minibatch step builds: {n_cross}")
    launches = {k: 0 for k in COUNTERS}
    for what, ps in (("bench q", params), ("non-trivial q", slice_params())):
        with tgp.config_context(gram_mode="fused"):
            (v, g), got = counted(lambda: value_and_grad(
                minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb), launches)
        check(n_cross >= 1 and got == only(gram_chol_inv=1, stationary_gram=n_cross),
              f"minibatch step 1 ({what}), gram_mode fused: row 11 launched once a cross-Gram "
              f"({n_cross}), kernel A once ({got})")
        with tgp.config_context(use_kernels=False):
            vp, gp = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb)
        check_grads(f"minibatch step 1 ({what}), gram_mode fused vs the plain path f32", v, g,
                    vp, gp, GRAD_RTOL)
    p = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
    with tgp.config_context(gram_mode="fused"):
        (p, losses), got = counted(lambda: tgp.adam_fit(minibatch_loss, p, batches(STEPS),
                                                        learning_rate=LR), launches)
    check(got == only(gram_chol_inv=STEPS, stationary_gram=STEPS * n_cross)
          and bool(torch.isfinite(torch.stack(losses)).all()),
          f"{STEPS} Adam steps under gram_mode fused: row 11 {n_cross} a step, kernel A once a "
          f"step, losses finite ({got})")
    for label, mode in (("gram_mode fused", "fused"), ("default gram_mode", "auto")):
        with tgp.config_context(gram_mode=mode):
            q = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
            reps = 10
            ms = cuda_ms(lambda: tgp.adam_fit(minibatch_loss, q, batches(reps), LR), 3) / reps
        print(f"time minibatch step ({label}): {ms:.3f} ms a step (Adam, B={BATCH}, M={M})")
    return launches, numbers


# -- phases 12-14: the natural-gradient step, the Poisson step, block-Vecchia ------------


def nat_elbo(hyper: dict, m, L, xb, yb):
    """``bench.py::natgrad_hybrid``'s elbo_fn: SE prior from raw k, inducing
    jitter 1e-6, q = N(m, tril(L)) NonCentered, noise 0.1, the minibatch
    scaled to N_NAT points."""
    return convert.natgrad_elbo(hyper, m, L, xb, yb, num_data=N_NAT, jitter=JITTER,
                                noise=NOISE)


def nat_start(dev, dtype, M_: int | None = None, z=None):
    """``bench.py::natgrad_hybrid``'s start: k = (0.5, 0.5), z ~ N(0, 1)
    from numpy (M_NAT of them), m = 0, L = I; returns (hyper, m, L)."""
    M_ = M_NAT if M_ is None else M_
    if z is None:
        z = np.random.default_rng(SEED + 20).standard_normal((M_, D))
    hyper = {"k": torch.tensor(RAW_K, dtype=dtype, device=dev),
             "z": torch.as_tensor(z, dtype=dtype, device=dev).clone()}
    return (hyper, torch.zeros(M_, dtype=dtype, device=dev),
            torch.eye(M_, dtype=dtype, device=dev))


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def min_pivot(L: torch.Tensor) -> float:
    return torch.diagonal(L).min().item()


def phase_natgrad(dev) -> dict:
    """Phase 12: the natural-gradient hybrid step.  Returns the path run's
    launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x = torch.randn((N_NAT, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + NOISE * torch.randn((N_NAT,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, N_NAT, (BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    def make():
        return tgp.make_natgrad_adam_step(nat_elbo, learning_rate=LR, nat_lr=NAT_LR)

    # step 1 on both paths from the bench's start, on the same minibatch
    xb, yb = next(batches(1))
    after = {}
    for label, use in (("kernels", True), ("plain", False)):
        step, init = make()
        with tgp.config_context(use_kernels=use):
            carry = init(*nat_start(dev, torch.float32))
            ((hyper, _, m, L, Linv), e), got = counted(lambda: step(carry, xb, yb), {})
        want = only(gram_chol_inv=1, chol_inv=2) if use else only()
        check(got == want, f"natgrad step 1 ({label}): launches {nonzero(got)} "
              f"(row 1 once and row 4 twice on the kernel path, none plain)")
        eye = torch.eye(M_NAT, device=dev)
        print(f"natgrad step 1 ({label}): elbo {e.item():.8g}, smallest pivot of L "
              f"{min_pivot(L):.4g}, max|L L⁻¹ − I| {max_abs(L @ Linv, eye):.3e}")
        after[label] = (e, {k: v.detach() for k, v in hyper.items()}, m, L)
    (e, h, m, L), (ep, hp, mp, Lp) = after["kernels"], after["plain"]
    with tgp.config_context(use_kernels=False):
        step, init = make()
        (_, _, m64, L64, _), _ = step(init(*nat_start(dev, torch.float64)), xb.double(),
                                      yb.double())
    print(f"natgrad step 1 against the f64 plain path, rel err: kernels m {rel_err(m, m64):.3e}, "
          f"L {rel_err(L, L64):.3e}; plain path m {rel_err(mp, m64):.3e}, L {rel_err(Lp, L64):.3e}")
    errs = {"elbo": abs(e.item() - ep.item()) / abs(ep.item()), "m": rel_err(m, mp),
            "L": rel_err(L, Lp), **{k: rel_err(h[k], hp[k]) for k in h}}
    check(errs["elbo"] <= GRAD_RTOL and max(errs[k] for k in h) <= NAT_HYPER_RTOL
          and max(errs["m"], errs["L"], rel_err(m, m64), rel_err(L, L64)) <= NAT_Q_RTOL,
          "natgrad step 1, kernels vs plain path f32: rel err " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
          f" (elbo <= {GRAD_RTOL:g}, k and z <= {NAT_HYPER_RTOL:g}, m and L, and the kernel "
          f"path's against the f64 plain path, <= {NAT_Q_RTOL:g})")

    # the path, counted: NAT_STEPS steps over fresh minibatches
    step, init = make()
    carry = init(*nat_start(dev, torch.float32))
    launches = {k: 0 for k in COUNTERS}
    elbos, pivots = [], []

    def run():
        nonlocal carry
        for xb, yb in batches(NAT_STEPS):
            carry, e = step(carry, xb, yb)
            elbos.append(e)
            pivots.append(torch.diagonal(carry[3]).min())

    counted(run, launches)
    print(f"natgrad launches over {NAT_STEPS} steps: {nonzero(launches)}")
    check(launches == only(gram_chol_inv=NAT_STEPS, chol_inv=2 * NAT_STEPS),
          f"row 1 once and row 4 twice a natgrad step ({NAT_STEPS} steps)")
    elbos, pivots = torch.stack(elbos), torch.stack(pivots)
    hyper, _, m, L, Linv = carry
    finite = (bool(torch.isfinite(elbos).all()) and bool(torch.isfinite(m).all())
              and bool(torch.isfinite(L).all()) and bool(torch.isfinite(Linv).all())
              and all(bool(torch.isfinite(v).all()) for v in hyper.values()))
    print("natgrad smallest pivot of L by step: " + " ".join(f"{p:.4g}" for p in pivots.tolist()))
    check(finite, f"{NAT_STEPS} natgrad steps: elbo, hyperparameters, m, L and L⁻¹ finite "
          f"(elbo {elbos[0].item():.6g} -> {elbos[-1].item():.6g})")
    for label, use in (("kernels", True), ("plain", False)):
        step, init = make()
        with tgp.config_context(use_kernels=use):
            c = [init(*nat_start(dev, torch.float32))]
            reps = 5

            def steps():
                for xb, yb in batches(reps):
                    c[0] = step(c[0], xb, yb)[0]

            ms = cuda_ms(steps, 2) / reps
        print(f"time natgrad step ({label}): {ms:.3f} ms a step (Adam on k and z, natural "
              f"gradient on q, B={BATCH}, M={M_NAT}, fresh gather from N={N_NAT}; {CARD})")

    # f64 on the card: one step with nat_lr = 1 from an arbitrary q lands on
    # the optimal q of the old hyperparameters (the conjugate case)
    g64 = torch.Generator(device=dev).manual_seed(SEED + 22)
    x64 = torch.randn((NAT_N64, D), generator=g64, device=dev, dtype=torch.float64)
    y64 = torch.sin(x64[:, 0]) + NOISE * torch.randn((NAT_N64,), generator=g64, device=dev,
                                                     dtype=torch.float64)
    z64 = x64[:NAT_M64].cpu().numpy()

    def full(h, m_, L_, xb, yb):  # the full batch: no num_data scaling
        return convert.natgrad_elbo(h, m_, L_, xb, yb, jitter=JITTER, noise=NOISE)

    step, init = tgp.make_natgrad_adam_step(full, learning_rate=LR, nat_lr=1.0)
    hyper0, _, _ = nat_start(dev, torch.float64, NAT_M64, z64)
    h0 = {k: v.clone() for k, v in hyper0.items()}
    m0 = torch.full((NAT_M64,), 0.3, dtype=torch.float64, device=dev)
    L0 = 1.4 * torch.eye(NAT_M64, dtype=torch.float64, device=dev)
    reset_counts()
    (_, _, m1, L1, Li1), _ = step(init(hyper0, m0, L0), x64, y64)
    got = read_counts()
    with torch.no_grad():
        e1 = full(h0, m1, L1, x64, y64)
        f0 = tgp.GP(softplus(h0["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                                 softplus(h0["k"][1])))
        bound = tgp.vfe_elbo(tgp.VFE(f0(h0["z"], JITTER)), f0(x64, NOISE), y64)
    ev = abs(e1.item() - bound.item()) / abs(bound.item())
    eye = torch.eye(NAT_M64, dtype=torch.float64, device=dev)
    check(ev <= 1e-8 and max_abs(Li1 @ L1, eye) <= 1e-8 and got["chol_inv"] == 2,
          f"natgrad f64 N={NAT_N64} M={NAT_M64}, nat_lr 1: elbo at the new q {e1.item():.10g} vs "
          f"vfe_elbo {bound.item():.10g}, rel err {ev:.3e} <= 1e-8, max|L⁻¹L − I| "
          f"{max_abs(Li1 @ L1, eye):.3e} <= 1e-8, row 4 launched {got['chol_inv']} times")
    return launches


def likelihood_checks(dev) -> None:
    """Phase 13 (b): every likelihood's quadratures on the card, f64 and
    f32, at N_LIK points: Gauss–Hermite against the analytic expectation
    where one exists (f64 1e-10, f32 1e-5 relative to the largest), Monte
    Carlo (20 draws) against it, or against Gauss–Hermite, within 5
    standard errors of the points' mean difference; ``log_prob_d1_d2``
    against autograd of ``log_prob`` (f64 1e-12, f32 1e-5; the Gauss–Newton
    wrapper's second derivative against minus the Fisher information)."""
    from approximategps_tpu_torch.core.likelihoods import _autograd_d1_d2

    liks = {"gaussian": tgp.GaussianLikelihood(0.3), "poisson": tgp.PoissonLikelihood(),
            "exponential": tgp.ExponentialLikelihood(), "gamma": tgp.GammaLikelihood(2.5),
            "bernoulli": tgp.BernoulliLikelihood(),
            "bernoulli_probit": tgp.BernoulliLikelihood(link="probit"),
            "poisson_softplus": tgp.PoissonLikelihood(link="softplus"),
            "negbin": tgp.NegativeBinomialLikelihood(2.5),
            "studentt": tgp.StudentTLikelihood(5.0, 0.7),
            "gaussnewton_fisher": tgp.GaussNewtonLikelihood(tgp.StudentTLikelihood(5.0, 0.7),
                                                            mode="fisher")}
    for dtype, tol_gh, tol_d in ((torch.float64, 1e-10, 1e-12), (torch.float32, 1e-5, 1e-5)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        mean = 4.0 * torch.rand((N_LIK,), generator=gen, device=dev, dtype=dtype) - 2.0
        var = 0.01 + 0.49 * torch.rand((N_LIK,), generator=gen, device=dev, dtype=dtype)
        for name, lik in liks.items():
            y = lik.conditional_sample(gen, mean).to(dtype)
            an = lik.expected_log_prob_analytic(mean, var, y)
            gh = tgp.GaussHermite(20).expected_loglik(lik, mean, var, y)
            mc = tgp.MonteCarlo(20, generator=gen).expected_loglik(lik, mean, var, y)
            ref = gh if an is None else an
            d = (mc - ref).double()
            z = abs(d.mean().item()) / (d.std().item() / math.sqrt(N_LIK))
            e_gh = 0.0 if an is None else rel_err(gh, an)
            ll, d1, d2 = lik.log_prob_d1_d2(mean, y)
            all_, a1, a2 = _autograd_d1_d2(lik, mean, y)
            if isinstance(lik, tgp.GaussNewtonLikelihood):  # its curvature is the Fisher's
                a2 = -lik.fisher_information(mean, y)
            e_d = max(rel_err(d1, a1), rel_err(d2, a2), abs(ll.item() - all_.item()) / abs(all_.item()))
            finite = all(bool(torch.isfinite(t).all()) for t in (gh, mc, d1, d2))
            check(finite and e_gh <= tol_gh and z <= 5.0 and e_d <= tol_d,
                  f"likelihood {name} {str(dtype)[6:]} N={N_LIK}: "
                  + ("" if an is None else f"GH vs analytic rel err {e_gh:.3e} <= {tol_gh:g}, ")
                  + f"MC vs {'GH' if an is None else 'analytic'} {z:.2f} standard errors <= 5, "
                  f"log_prob_d1_d2 vs autograd rel err {e_d:.3e} <= {tol_d:g}")


def phase_poisson(dev) -> dict:
    """Phase 13: the Poisson SVGP step (``bench.py::poisson_svgp``), then
    the likelihood checks.  Returns the path run's launches."""
    rng = np.random.default_rng(SEED + 30)
    xh = np.sort(rng.uniform(size=POIS_BATCH)) * 100.0
    x = torch.tensor(xh[:, None], dtype=torch.float32, device=dev)
    y = torch.tensor(rng.poisson(np.exp(np.sin(xh))), device=dev)  # integer counts
    bench = {"k": np.array(RAW_K), "z": np.linspace(0.0, 100.0, POIS_M)[:, None],
             "m": np.zeros(POIS_M), "A": np.eye(POIS_M)}
    nontrivial = {**bench, "m": 0.3 * rng.standard_normal(POIS_M),
                  "A": 0.6 * np.eye(POIS_M) + 0.01 * np.tril(rng.standard_normal((POIS_M, POIS_M)))}

    def loss(p, xb, yb):
        return convert.poisson_svgp_loss(p, xb, yb, num_data=POIS_N, jitter=POIS_JITTER)

    for what, ps in (("bench q", bench), ("non-trivial q", nontrivial)):
        (v, g), got = counted(lambda: value_and_grad(loss, leaf_params(ps, dev, torch.float32),
                                                     x, y), {})
        check(got == only(gram_chol_inv=1),
              f"Poisson step 1 ({what}): row 1 once (launches {nonzero(got)})")
        with tgp.config_context(use_kernels=False):
            vp, gp = value_and_grad(loss, leaf_params(ps, dev, torch.float32), x, y)
            v64, g64 = value_and_grad(loss, leaf_params(ps, dev, torch.float64), x.double(), y)
        # each f32 path against the f64 plain path: the kernel path no further
        # from it than GRAD_RTOL or twice the plain path's own distance
        errs = {k: (rel_err(g[k], g64[k]), rel_err(gp[k], g64[k]), rel_err(g[k], gp[k]))
                for k in g}
        ev = [abs(a.item() - v64.item()) / abs(v64.item()) for a in (v, vp)]
        check(ev[0] <= max(GRAD_RTOL, 2 * ev[1])
              and all(e[0] <= max(GRAD_RTOL, 2 * e[1]) for e in errs.values()),
              f"Poisson step 1 ({what}), rel err against the f64 plain path (kernels, plain; "
              f"kernels vs plain): loss {ev[0]:.3e}, {ev[1]:.3e}; " + "; ".join(
                  f"d{k} {a:.3e}, {b:.3e}; {c:.3e}" for k, (a, b, c) in errs.items())
              + f"; the kernels' <= max({GRAD_RTOL:g}, 2 × the plain path's); dk "
              f"{g['k'].tolist()}, plain {gp['k'].tolist()}, f64 {g64['k'].tolist()}")

    launches = {k: 0 for k in COUNTERS}
    p = {k: t.detach() for k, t in leaf_params(bench, dev, torch.float32).items()}
    (p, losses), _ = counted(lambda: tgp.adam_fit(loss, p, [(x, y)] * POIS_STEPS,
                                                  learning_rate=LR), launches)
    losses = torch.stack(losses)
    print(f"Poisson launches over {POIS_STEPS} steps: {nonzero(launches)}")
    check(launches == only(gram_chol_inv=POIS_STEPS)
          and bool(torch.isfinite(losses).all())
          and all(bool(torch.isfinite(t).all()) for t in p.values()),
          f"row 1 once a Poisson step, {POIS_STEPS} Adam steps finite "
          f"(loss {losses[0].item():.6g} -> {losses[-1].item():.6g})")
    for label, use in (("kernels", True), ("plain", False)):
        with tgp.config_context(use_kernels=use):
            q = {k: t.detach() for k, t in leaf_params(bench, dev, torch.float32).items()}
            reps = 5
            ms = cuda_ms(lambda: tgp.adam_fit(loss, q, [(x, y)] * reps, LR), 2) / reps
        print(f"time Poisson step ({label}): {ms:.3f} ms a step (Adam, B={POIS_BATCH}, "
              f"M={POIS_M}, D=1, analytic expectation; {CARD})")
    likelihood_checks(dev)
    return launches


def bv_lml(theta, x, y, nn):
    return tgp.approx_lml(nn, convert.build_vecchia_fx(theta, x), y)


def bv_value_and_grad(theta0: torch.Tensor, x, y, nn):
    th = theta0.clone().requires_grad_()
    v = bv_lml(th, x, y, nn)
    (g,) = torch.autograd.grad(v, th)
    return v.detach(), g[:2]


def phase_block_vecchia(dev) -> dict:
    """Phase 14: block-Vecchia (``bench.py::block_vecchia_lml`` and
    ``block_vecchia_lml_grad``) and its f64 checks.  Returns the path run's
    launches (none: no hand-written kernel runs here)."""
    nn = tgp.BlockNearestNeighbors(block_size=BV_B, k=BV_K)
    x = torch.linspace(0.0, float(N_BV), N_BV, device=dev)[:, None]
    y = torch.sin(x[:, 0] / 3.0)
    theta = convert.from_jax_params(BV_THETA, device=dev, dtype=torch.float32)
    launches = {k: 0 for k in COUNTERS}
    torch.cuda.reset_peak_memory_stats()
    (v, g), _ = counted(lambda: bv_value_and_grad(theta, x, y, nn), launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(sum(launches.values()) == 0 and bool(torch.isfinite(v)) and bool(torch.isfinite(g).all()),
          f"block-Vecchia N={N_BV} b={BV_B} k={BV_K}: value {v.item():.8g} and θ-gradient "
          f"finite, no kernel launched (peak memory {peak:.2f} GiB)")
    v64, g64 = bv_value_and_grad(theta.double(), x.double(), y.double(), nn)
    ev, eg = abs(v.item() - v64.item()) / abs(v64.item()), rel_err(g, g64)
    check(ev <= BV_VALUE_RTOL32 and eg <= BV_GRAD_RTOL32,
          f"block-Vecchia f32 vs f64, N={N_BV}: rel err value {ev:.3e} <= {BV_VALUE_RTOL32:g}, "
          f"gradient {eg:.3e} <= {BV_GRAD_RTOL32:g} (gradient {g.tolist()} vs {g64.tolist()})")
    ms = cuda_ms(lambda: bv_lml(theta, x, y, nn), 3)
    ms_grad = cuda_ms(lambda: bv_value_and_grad(theta, x, y, nn), 3)
    print(f"time block-Vecchia approx_lml: {ms:.3f} ms, value and θ-gradient {ms_grad:.3f} ms "
          f"(N={N_BV}, b={BV_B}, k={BV_K}, {N_BV // BV_B} blocks, f32; {CARD})")

    # f64 on the card
    f64 = dict(device=dev, dtype=torch.float64)
    th64 = theta.double()
    xs = torch.linspace(0.0, float(N_BV_SCALAR), N_BV_SCALAR, **f64)[:, None]
    fx = convert.build_vecchia_fx(th64, xs)
    ys = torch.sin(xs[:, 0] / 3.0)
    scalar = tgp.approx_lml(tgp.NearestNeighbors(k=BV_SCALAR_K), fx, ys)
    block = tgp.approx_lml(tgp.BlockNearestNeighbors(block_size=1, k=BV_SCALAR_K), fx, ys)
    e = abs(block.item() - scalar.item()) / abs(scalar.item())
    check(e <= 1e-9, f"block-Vecchia b=1 f64 N={N_BV_SCALAR} k={BV_SCALAR_K} vs scalar Vecchia: "
          f"{block.item():.12g} vs {scalar.item():.12g}, rel err {e:.3e} <= 1e-9")

    xe = torch.linspace(0.0, float(N_BV_EXACT), N_BV_EXACT, **f64)[:, None]
    ye = torch.sin(xe[:, 0] / 3.0)
    full = tgp.BlockNearestNeighbors(block_size=BV_B, k=N_BV_EXACT)
    lml = tgp.approx_lml(full, convert.build_vecchia_fx(th64, xe), ye)
    exact = convert.build_vecchia_fx(th64, xe).logpdf(ye)
    post = tgp.posterior(full, convert.build_vecchia_fx(th64, xe), ye)
    gpr = tgp.posterior(convert.build_vecchia_fx(th64, xe).f(xe, 1e-12), ye)
    xt = torch.linspace(-3.0, N_BV_EXACT + 3.0, 33, **f64)[:, None]
    e = abs(lml.item() - exact.item()) / abs(exact.item())
    em, evar = max_abs(post.mean(xt), gpr.mean(xt)), max_abs(post.var(xt), gpr.var(xt))
    check(e <= 1e-7 and em <= 1e-6 and evar <= 1e-6,
          f"block-Vecchia full conditioning f64 N={N_BV_EXACT} b={BV_B}: lml vs exact logpdf rel "
          f"err {e:.3e} <= 1e-7, posterior at 33 points max|d mean| {em:.3e}, max|d var| "
          f"{evar:.3e} <= 1e-6")

    gn = torch.Generator(device=dev).manual_seed(SEED + 40)
    side = math.sqrt(N_BV_NEAREST)  # points about a lengthscale apart
    xn = side * torch.rand((N_BV_NEAREST, 2), generator=gn, **f64)
    yn = torch.sin(xn[:, 0] / 3.0) + torch.cos(xn[:, 1] / 5.0)
    near = tgp.BlockNearestNeighbors(block_size=BV_B, k=BV_K, ordering="maximin",
                                     neighbors="nearest")
    (lml_dev, ms_dev) = timed(lambda: bv_lml(th64, xn, yn, near))
    t0 = time.perf_counter()
    lml_cpu = bv_lml(th64.cpu(), xn.cpu(), yn.cpu(), near)
    ms_cpu = 1e3 * (time.perf_counter() - t0)
    e = abs(lml_dev.item() - lml_cpu.item()) / abs(lml_cpu.item())
    check(bool(torch.isfinite(lml_dev)) and e <= 1e-10,
          f"block-Vecchia maximin + nearest f64 N={N_BV_NEAREST} in 2-D: the card "
          f"{lml_dev.item():.12g} vs the CPU {lml_cpu.item():.12g}, rel err {e:.3e} <= 1e-10 "
          f"({ms_dev:.1f} ms on the card, {ms_cpu:.1f} ms on the CPU, host ordering and search "
          f"included)")
    return launches


# -- phase 15: the Laplace approximation -------------------------------------------------


@contextlib.contextmanager
def row5_by_pass(tally: dict):
    """Inside, add row 5's launches by kernel and width to ``tally``: the
    forward passes as ("narrow" or "wide", R) and the self-Gram pullback as
    ("self pullback", R), the growth of the module's own
    ``launches_by_pass`` (never reset)."""
    before = dict(gram_matvec.launches_by_pass)
    try:
        yield tally
    finally:
        for key, n in gram_matvec.launches_by_pass.items():
            if n > before.get(key, 0):
                tally[key] = tally.get(key, 0) + n - before.get(key, 0)


def by_pass(tally: dict) -> str:
    return ", ".join(f"{k} R={r} {n}" for (k, r), n in sorted(tally.items())) or "none"


def lap_mode(theta, x, y, **kw):
    """(the CG-Newton mode, Newton steps) of the CG rows' model."""
    with torch.no_grad():
        return tgp.newton_inner_loop_cg(tgp.BernoulliLikelihood(), y, convert.laplace_kernel(theta),
                                        x, return_niter=True, **LAP_NEWTON, **kw)


def lap_lml(theta, x, y, probes, grad: bool, **kw):
    """``laplace_lml_cg`` of the CG rows' model, and its θ-gradient with
    ``grad``."""
    th = theta.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        v = tgp.laplace_lml_cg(tgp.BernoulliLikelihood(), y, convert.laplace_kernel(th), x,
                               probes=probes, lanczos_iters=LAP_LANCZOS, **LAP_NEWTON, **kw)
    return (v.detach(), torch.autograd.grad(v, th)[0]) if grad else v


def cg_counts(st: dict) -> str:
    return (f"{st['cg_solves']} CG solves, {st['cg_iterations']} iterations, "
            f"{st['cg_host_syncs']} host syncs; matvecs {st['matvec_fused']} fused, "
            f"{st['matvec_plain']} plain")


def slq_logdet(theta, f, x, probes, **kw) -> tuple[float, float]:
    """(the SLQ estimate of logdet B at ``f``, its standard error over the
    probes): the Bernoulli W at f, block Lanczos over the probes on the
    route ``kw`` names (as ``_LogdetBSLQ`` runs it), each probe's Gauss
    quadrature in f64."""
    with torch.no_grad():
        _, _, d2 = tgp.BernoulliLikelihood().log_prob_d1_d2(f, torch.zeros_like(f))
        kmv = laplace_cg._k_matvec(convert.laplace_kernel(theta), x, kw.get("block_size"), 0.0,
                                   kw.get("storage", "auto"))
        a, b = iterative._lanczos_block(laplace_cg._b_matvec(kmv, torch.sqrt(-d2)), probes.T,
                                        LAP_LANCZOS)
        T = torch.diag_embed(a.T) + torch.diag_embed(b.T, 1) + torch.diag_embed(b.T, -1)
        evals, evecs = torch.linalg.eigh(T.double())
        each = f.shape[0] * torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals.clamp(min=1e-30)),
                                      dim=-1)
    return each.mean().item(), (each.std() / math.sqrt(each.shape[0])).item()


def phase_laplace(dev) -> tuple[dict, dict]:
    """Phase 15: the Laplace approximation, dense and matrix-free.  Returns
    (the path runs' launches, row 5's numbers at the R = 1 self-Gram
    pullback for the kernels line)."""
    launches = {k: 0 for k in COUNTERS}
    lik = tgp.BernoulliLikelihood()
    f32 = dict(device=dev, dtype=torch.float32)

    # (a) laplace_n5k: dense Newton, the value and θ-gradient of −laplace_lml
    x5, y5 = convert.laplace_data(N_LAP5K, 1, seed=SEED + 50, device=dev)

    def n5k(theta0):
        th = theta0.clone().requires_grad_()
        v = convert.laplace_neg_lml(th, x5.to(th.dtype), y5, LAP5K_JITTER, LAP5K_MAXITER)
        return v.detach(), torch.autograd.grad(v, th)[0]

    theta5 = torch.ones(2, **f32)
    (v, g), got = counted(lambda: n5k(theta5), launches)
    check(sum(got.values()) == 0 and bool(torch.isfinite(v) and torch.isfinite(g).all()),
          f"laplace_n5k N={N_LAP5K}: value {v.item():.8g} and θ-gradient finite, no kernel "
          f"launched (row 5 0: the dense path has no matvec)")
    v64, g64 = n5k(theta5.double())
    ev, eg = abs(v.item() - v64.item()) / abs(v64.item()), rel_err(g, g64)
    check(ev <= LAP5K_RTOL32 and eg <= LAP5K_RTOL32,
          f"laplace_n5k f32 vs f64 on the card: rel err value {ev:.3e}, θ-gradient {eg:.3e} "
          f"<= {LAP5K_RTOL32:g} (gradient {g.tolist()} vs {g64.tolist()})")
    K5 = tgp.GP(convert.laplace_kernel(theta5))(x5, LAP5K_JITTER).cov()
    _, n5 = tgp.newton_inner_loop(lik, y5, K5, maxiter=LAP5K_MAXITER, return_niter=True)
    ms = cuda_ms(lambda: n5k(theta5), 3)
    print(f"time laplace_n5k value and θ-gradient: {ms:.3f} ms a step (median of 3; N={N_LAP5K}, "
          f"{n5} Newton steps of at most {LAP5K_MAXITER}; {CARD})")

    # (b) laplace_cg_mode at N = 2·10^4 on three routes, then at 10^5 on the kernel route
    x, y = convert.laplace_data(N_LAP, D_LAP, seed=SEED + 51, device=dev)
    xm, ym = x[:N_LAP_MID], y[:N_LAP_MID]
    theta = torch.tensor(convert.LAPLACE_CG_THETA, **f32)
    mid = dict(precond_rank=LAP_RANK_MID)
    chunked = dict(mid, storage="chunked", block_size=LAP_BLOCK)
    modes, route_ms = {}, {}
    for route, kw, use in (("resident", dict(mid, storage="dense"), True),
                           ("chunked, row 5", chunked, True),
                           ("chunked, plain", chunked, False)):
        tally = {}
        with tgp.config_context(use_kernels=use):
            with row5_by_pass(tally):
                (f, n), got = counted(lambda: lap_mode(theta, xm, ym, **kw), launches)
            st = dict(iterative.stats)
            route_ms[route] = cuda_ms(lambda: lap_mode(theta, xm, ym, **kw), 2)
        modes[route] = f
        # the resident Gram takes no kernel_matvec; the chunked routes every
        # product through row 5 or through Gram blocks
        fused, plain = st["matvec_fused"], st["matvec_plain"]
        kind = {"resident": fused == plain == 0, "chunked, row 5": fused > 0 == plain,
                "chunked, plain": plain > 0 == fused}[route]
        check(got == only(gram_matvec=fused) and kind and bool(torch.isfinite(f).all()),
              f"laplace_cg_mode N={N_LAP_MID} {route}: {n} Newton steps (as many host syncs), "
              f"{cg_counts(st)}; row 5 launches {got['gram_matvec']} (by pass: {by_pass(tally)}), "
              "mode finite")
    # one product K·V at N = 2·10^4 with the resident Gram and through row 5
    # (what storage="auto" takes on the card), at Newton's R = 1 and the
    # probes' R = 16
    with torch.no_grad():
        kd, build_ms = timed(lambda: laplace_cg._k_matvec(convert.laplace_kernel(theta), xm,
                                                          None, 0.0, "dense"))
        kf = laplace_cg._k_matvec(convert.laplace_kernel(theta), xm, LAP_BLOCK, 0.0, "auto")
        for R in (1, LAP_PROBES):
            V = torch.randn((N_LAP_MID, R), generator=torch.Generator(device=dev).manual_seed(R),
                            **f32)
            e = rel_err(kf(V), kd(V))
            check(e <= 1e-5, f"K·V N={N_LAP_MID} R={R}: row 5 (storage=\"auto\") against the "
                  f"resident Gram rel err {e:.3e} <= 1e-5")
            print(f"time K·V N={N_LAP_MID} R={R}: resident Gram {cuda_ms(lambda: kd(V), 5):.4f} "
                  f"ms, row 5 {cuda_ms(lambda: kf(V), 5):.4f} ms (the Gram's build {build_ms:.3f} ms "
                  f"apart; {CARD})")
        del kd
    th64 = theta.double()
    with torch.no_grad():
        K64 = convert.laplace_kernel(th64).gram(xm.double())
        (f64, n64), dense_ms = timed(lambda: tgp.newton_inner_loop(lik, ym, K64, tol=1e-10,
                                                                  return_niter=True))
    errs = {r: rel_err(f, f64) for r, f in modes.items()}
    pair = max(rel_err(modes["chunked, row 5"], modes["resident"]),
               rel_err(modes["chunked, plain"], modes["resident"]))
    check(max(errs.values()) <= LAP_MODE_RTOL32 and pair <= LAP_MODE_RTOL32,
          f"laplace_cg_mode N={N_LAP_MID} f32 modes against the f64 dense mode ({n64} Newton "
          "steps, torch.linalg on the card, " + f"{dense_ms:.1f} ms): rel err "
          + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
          + f"; the chunked routes against the resident {pair:.3e} <= {LAP_MODE_RTOL32:g}")
    big = dict(precond_rank=LAP_RANK, block_size=LAP_BLOCK)
    tally = {}
    with row5_by_pass(tally):
        (f, n), got = counted(lambda: lap_mode(theta, x, y, **big), launches)
    st = dict(iterative.stats)
    # the mode is Newton's fixed point: one more step from it moves it by no
    # more than the f32 floor (f − K∇ll(f) is no measure here: λmax(K)·max W,
    # about 3·10³, multiplies the stopping error in it)
    with torch.no_grad():
        kmv = iterative.kernel_matvec(convert.laplace_kernel(theta), x, 0.0, LAP_BLOCK)
        f_next = laplace_cg._newton_body_cg(lik, y, kmv, f, LAP_NEWTON["cg_tol"],
                                            LAP_NEWTON["cg_maxiter"], 1.0)[0]
    step = rel_err(f_next, f)
    check(got == only(gram_matvec=st["matvec_fused"]) and st["matvec_plain"] == 0
          and step <= LAP_STEP_RTOL32,
          f"laplace_cg_mode N={N_LAP} (kernel route): {n} Newton steps, {cg_counts(st)}; row 5 "
          f"launches {got['gram_matvec']} = the matvecs (by pass: {by_pass(tally)}); one more "
          f"Newton step moves the mode by {step:.3e} of max|f| <= {LAP_STEP_RTOL32:g}")
    big_ms = cuda_ms(lambda: lap_mode(theta, x, y, **big), 2)
    print(f"time laplace_cg_mode (median of 2 after a warm-up): N={N_LAP_MID} resident "
          f"{route_ms['resident']:.3f} ms, chunked through row 5 {route_ms['chunked, row 5']:.3f} "
          f"ms, chunked plain {route_ms['chunked, plain']:.3f} ms; N={N_LAP} (row 5) "
          f"{big_ms:.3f} ms ({CARD})")

    # (c) laplace_cg_lml at 10^5: the value, and the value with its θ-gradient
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    probes = iterative.rademacher_probes(gen, LAP_PROBES, N_LAP, torch.float32, dev)
    tally = {}
    with row5_by_pass(tally):
        lv, got_v = counted(lambda: lap_lml(theta, x, y, probes, False, **big), launches)
        st_v = dict(iterative.stats)
        (gv, gg), got_g = counted(lambda: lap_lml(theta, x, y, probes, True, **big), launches)
    passes = dict(gram_matvec.pullback_passes)
    st = dict(iterative.stats)
    # the IFT pullback at R = 1 (neither the points nor ∇ll carry a gradient) is the
    # lengthscale's r²·g′ pass; the logdet surrogate's (V̄ wanted, the points fixed) that pass
    # and V̄ = K·Ō at R = 16
    need = (("narrow", 1), ("wide", LAP_PROBES))
    check(got_v == only(gram_matvec=st_v["matvec_fused"])
          and got_g == only(gram_matvec=st["matvec_fused"] + passes["passes"])
          and st_v["matvec_plain"] == st["matvec_plain"] == 0
          and all(tally.get(k, 0) > 0 for k in need)
          and bool(torch.isfinite(lv) and torch.isfinite(gg).all())
          and abs(gv - lv).item() <= 1e-6 * abs(lv.item()),
          f"laplace_cg_lml N={N_LAP}: value {lv.item():.8g} ({got_v['gram_matvec']} launches; "
          f"the gradient call's value {gv.item():.8g}), "
          f"value and θ-gradient {gg.tolist()} ({got_g['gram_matvec']} launches = "
          f"{st['matvec_fused']} matvecs + {passes['passes']} pullback passes; {cg_counts(st)}); "
          f"row 5 by pass over both: {by_pass(tally)}, each of {need} at least once")
    lml_ms = cuda_ms(lambda: lap_lml(theta, x, y, probes, False, **big), 2)
    grad_ms = cuda_ms(lambda: lap_lml(theta, x, y, probes, True, **big), 2)
    print(f"time laplace_cg_lml N={N_LAP} (median of 2 after a warm-up): value {lml_ms:.3f} ms, "
          f"value and θ-gradient {grad_ms:.3f} ms ({LAP_PROBES} probes, {LAP_LANCZOS} Lanczos "
          f"steps, rank {LAP_RANK}; {CARD})")
    # the gradient at the cell's own size against the f64 run of the same
    # algorithm (row 5's f64 kernels, the same probes), once
    (_, g64b), big64_ms = timed(lambda: lap_lml(th64, x.double(), y, probes.double(), True, **big))
    eb = rel_err(gg, g64b)
    check(eb <= LAP_GRAD_BIG_RTOL32,
          f"laplace_cg_lml N={N_LAP} f32 θ-gradient (row 5) against the f64 run: rel err {eb:.3e} "
          f"<= {LAP_GRAD_BIG_RTOL32:g} ({gg.tolist()} vs {g64b.tolist()}; the f64 run "
          f"{big64_ms:.1f} ms)")
    pm = probes[:, :N_LAP_MID]
    (vk, gk), mid_ms = timed(lambda: lap_lml(theta, xm, ym, pm, True, **chunked))
    with tgp.config_context(use_kernels=False):
        (vp, gp), mid_plain_ms = timed(lambda: lap_lml(theta, xm, ym, pm, True, **chunked))
    # the gradient: each f32 route against the f64 run of the same algorithm
    # (row 5's f64 kernels), row 5 no further than max(limit, 2 × plain's)
    v64, g64 = lap_lml(th64, xm.double(), ym, pm.double(), True, **chunked)
    ev, ek, ep = abs(vk.item() - vp.item()) / abs(vp.item()), rel_err(gk, g64), rel_err(gp, g64)
    check(ev <= LAP_LML_RTOL32 and ek <= max(LAP_GRAD_RTOL32, 2 * ep),
          f"laplace_cg_lml N={N_LAP_MID} f32: value row 5 vs plain rel err {ev:.3e} <= "
          f"{LAP_LML_RTOL32:g}; θ-gradient against the f64 run rel err row 5 {ek:.3e} <= "
          f"max({LAP_GRAD_RTOL32:g}, 2 × plain's {ep:.3e}) (row 5 vs plain {rel_err(gk, gp):.3e}; "
          f"row 5 {gk.tolist()}, plain {gp.tolist()}, f64 {g64.tolist()}; "
          f"{mid_ms:.3f} ms vs {mid_plain_ms:.3f} ms, once)")
    # logdet B, the part of the lml that the kernel computes (Σ log p at f ≈ 0
    # is most of the value), at one W: row 5's f32 Lanczos (the wide pass)
    # against the plain route's and against the f64 run's
    f_fix = modes["resident"]
    ld = {}
    for route, use, dt in (("row 5", True, torch.float32), ("plain", False, torch.float32),
                           ("f64", True, torch.float64)):
        with tgp.config_context(use_kernels=use):
            ld[route] = slq_logdet(theta.to(dt), f_fix.to(dt), xm.to(dt), pm.to(dt), **chunked)
    e_kp = abs(ld["row 5"][0] - ld["plain"][0]) / abs(ld["plain"][0])
    e_k, e_p = (abs(ld[r][0] - ld["f64"][0]) / abs(ld["f64"][0]) for r in ("row 5", "plain"))
    check(e_kp <= LAP_LOGDET_RTOL32 and e_k <= max(LAP_LOGDET_RTOL32, 2 * e_p),
          f"logdet B N={N_LAP_MID} by SLQ ({LAP_PROBES} probes, {LAP_LANCZOS} Lanczos steps) at "
          f"the resident mode's W: row 5 {ld['row 5'][0]:.10g}, plain {ld['plain'][0]:.10g}, f64 "
          f"{ld['f64'][0]:.10g}; rel err row 5 vs plain {e_kp:.3e} <= {LAP_LOGDET_RTOL32:g}, "
          f"row 5 vs f64 {e_k:.3e} <= max({LAP_LOGDET_RTOL32:g}, 2 × plain's {e_p:.3e})")
    with torch.no_grad():
        dense = tgp.laplace_lml(lik, ym, K64, f_opt=f64).item()
    se = ld["row 5"][1]
    lim = max(0.25, 2.0 * se)  # ½·logdet's error: 4 standard errors of the probe mean
    check(abs(vk.item() - dense) <= lim,
          f"laplace_cg_lml N={N_LAP_MID} (row 5, f32, {LAP_PROBES} probes) against the dense f64 "
          f"laplace_lml, a statistical check of the probes: {vk.item():.8g} vs {dense:.8g}, "
          f"|diff| {abs(vk.item() - dense):.4g} <= {lim:.4g} (max(0.25, 4 × the logdet's probe "
          f"standard error {se:.4g} / 2))")
    del K64

    # (d) the serve and the prior sampler
    la = tgp.LaplaceCG(**LAP_NEWTON, precond_rank=LAP_RANK, block_size=LAP_BLOCK)
    xs = 10.0 * torch.rand((LAP_N_TEST, D_LAP), generator=gen, **f32)
    kern = convert.laplace_kernel(theta)
    lf = tgp.LatentGP(tgp.GP(kern), lik, 1e-8)
    tally = {}
    with row5_by_pass(tally), torch.no_grad():
        ((mu, var), got), serve_ms = timed(lambda: counted(
            lambda: tgp.posterior(la, lf(x), y).mean_and_var(xs), launches))
    check(got == only(gram_matvec=iterative.stats["matvec_fused"])
          and tally.get(("wide", LAP_N_TEST), 0) > 0
          and bool(torch.isfinite(mu).all()) and bool(((var > 0) & (var <= 1.5 + 1e-4)).all()),
          f"posterior(LaplaceCG) N={N_LAP} and mean_and_var at {LAP_N_TEST} points: finite mean, "
          f"variances in (0, 1.5], row 5 launches {got['gram_matvec']} (by pass: {by_pass(tally)}); "
          f"{serve_ms:.3f} ms ({CARD})")
    la_mid = tgp.LaplaceCG(**LAP_NEWTON, precond_rank=LAP_RANK_MID, block_size=LAP_BLOCK,
                           storage="chunked")
    with torch.no_grad():
        mu_k, var_k = tgp.posterior(la_mid, lf(xm), ym).mean_and_var(xs)
        lf64 = tgp.LatentGP(tgp.GP(convert.laplace_kernel(th64)), lik, 1e-8)
        mu64, var64 = tgp.posterior(tgp.LaplaceApproximation(tol=1e-10), lf64(xm.double()),
                                    ym).mean_and_var(xs.double())
    emu, evar = rel_err(mu_k, mu64), max_abs(var_k, var64) / 1.5
    check(emu <= LAP_POST_RTOL32 and evar <= LAP_POST_RTOL32,
          f"posterior(LaplaceCG) N={N_LAP_MID} (row 5, f32) against the dense f64 LaplacePosterior "
          f"at {LAP_N_TEST} points: rel err mean {emu:.3e}, max|d var| / prior variance "
          f"{evar:.3e} <= {LAP_POST_RTOL32:g}")
    samples, got = counted(lambda: tgp.sample_prior_msqrt(gen, kern, x, LAP_SAMPLE_NOISE,
                                                          LAP_SAMPLES, LAP_LANCZOS), launches)
    # the same normals (an int seed) through row 5 and through the plain route
    sk = tgp.sample_prior_msqrt(SEED + 54, kern, xm, LAP_SAMPLE_NOISE, LAP_SAMPLES, LAP_LANCZOS,
                                LAP_BLOCK)
    with tgp.config_context(use_kernels=False):
        sp = tgp.sample_prior_msqrt(SEED + 54, kern, xm, LAP_SAMPLE_NOISE, LAP_SAMPLES,
                                    LAP_LANCZOS, LAP_BLOCK)
    es = rel_err(sk, sp)
    check(es <= LAP_SAMPLE_RTOL32,
          f"sample_prior_msqrt N={N_LAP_MID}, {LAP_SAMPLES} samples, the same normals: row 5 "
          f"against the plain route rel err {es:.3e} <= {LAP_SAMPLE_RTOL32:g}")
    sub = torch.randperm(N_LAP, generator=gen, device=dev)[:LAP_SUBSET]
    C = convert.laplace_kernel(th64).gram(x[sub].double()) + LAP_SAMPLE_NOISE * torch.eye(
        LAP_SUBSET, dtype=torch.float64, device=dev)
    s = samples[:, sub].double()
    emp = s.T @ s / LAP_SAMPLES
    W = torch.sign(torch.randn((LAP_SUBSET, LAP_SUBSET), generator=gen, device=dev)).double()
    W = torch.triu(W) + torch.triu(W, 1).T
    # ⟨W, emp − C⟩ has mean 0 and variance 2·tr(WCWC)/S for Gaussian samples
    stats = {}
    for name, Wt in (("diagonal", torch.eye(LAP_SUBSET, dtype=torch.float64, device=dev)
                      / LAP_SUBSET), ("random signs", W)):
        stats[name] = (torch.sum(Wt * (emp - C)).item(),
                       math.sqrt(2.0 * torch.trace(Wt @ C @ Wt @ C).item() / LAP_SAMPLES))
    check(got == only(gram_matvec=LAP_LANCZOS) and bool(torch.isfinite(samples).all())
          and all(abs(t) <= 5.0 * sd for t, sd in stats.values()),
          f"sample_prior_msqrt N={N_LAP}, {LAP_SAMPLES} samples: one row-5 launch a Lanczos step "
          f"({got['gram_matvec']}); a statistical check: the samples' covariance on "
          f"{LAP_SUBSET} points against K + {LAP_SAMPLE_NOISE}·I within 5 Monte-Carlo standard "
          "deviations of ⟨W, emp − C⟩: "
          + ", ".join(f"{k} {t:.4g} (sd {sd:.4g})" for k, (t, sd) in stats.items()))

    # (e) row 5's self-Gram pullback at R = 1, the Newton IFT's shape where the points carry a
    # gradient
    rng = np.random.default_rng(SEED + 53)
    X = torch.tensor(rng.uniform(0.0, 10.0, (N_LAP, D_LAP)), **f32)
    V, Wb = (torch.tensor(rng.standard_normal((N_LAP, 1)), **f32) for _ in range(2))
    se_map = tk.SqExponentialKernel().kernel_map()
    got = gram_matvec.gram_matvec_self_bwd(X, V, Wb, se_map)
    ref = gram_matvec.gram_matvec_self_bwd_plain(X, V, Wb, se_map)
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    check(max(errs) <= 1e-4, f"gram_matvec self-Gram pullback f32 N={N_LAP} D={D_LAP} R=1 se "
          f"against its plain version: rel err X {errs[0]:.3e}, V {errs[1]:.3e} <= 1e-4")
    ms = cuda_ms(lambda: gram_matvec.gram_matvec_self_bwd(X, V, Wb, se_map), 3)
    plain_ms = cuda_ms(lambda: gram_matvec.gram_matvec_self_bwd_plain(X, V, Wb, se_map), 1)
    flops, nbytes, exps, tc = self_bwd_work(N_LAP, D_LAP, 1)
    b_ms, b_by = bound(flops, nbytes, exps, tc_flops=tc)
    print(f"time gram_matvec self-Gram pullback f32 N={N_LAP} D={D_LAP} R=1: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; {CARD})")
    r1 = {"max_abs_err_bwd_self_r1": max(max_abs(a, b) for a, b in zip(got, ref)),
          "ms_bwd_self_r1": ms, "plain_ms_bwd_self_r1": plain_ms, "bound_ms_bwd_self_r1": b_ms,
          "bound_by_bwd_self_r1": b_by}
    return launches, r1


# -- phase 16: pathwise sampling -------------------------------------------------------------


def scale_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| over the samples' scale max|b|."""
    return max_abs(a, b) / b.double().abs().max().item()


def ps_data(dev, N: int):
    """Phase 16 (a)'s data (phase 7's model), its kernel and query points."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    x = 10.0 * torch.rand((N, D_GP), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((N,), generator=gen, device=dev)
    xq = 10.0 * torch.rand((PS_N_TEST, D_GP), generator=gen, device=dev)
    theta = torch.tensor(convert.LAPLACE_CG_THETA, dtype=torch.float32, device=dev)
    return gen, x, y, xq, theta


def ps_fx(theta, x):
    return tgp.GP(convert.laplace_kernel(theta))(x, PS_NOISE)


def ps_sampler(fx, y, draws):
    return sampling.cg_pathwise(fx, y, *draws, tol=PS_TOL, maxiter=PS_MAXITER,
                                block_size=LAP_BLOCK, precond_rank=PS_RANK)


def phase_sampling_cg(dev) -> dict:
    """Phase 16 (a): Matheron CG samples of the exact GP.  Returns the path
    run's launches."""
    gen, x, y, xq, theta = ps_data(dev, N_PS)
    fx = ps_fx(theta, x)
    draws = sampling.draw_cg(gen, fx, PS_SAMPLES, PS_FEATURES)
    torch.cuda.synchronize()
    reset_counts()
    tally = {}
    with row5_by_pass(tally):
        fs, build_ms = timed(lambda: ps_sampler(fx, y, draws))
        s, eval_ms = timed(lambda: fs(xq))
    launches, st = read_counts(), dict(iterative.stats)
    print(f"pathwise CG launches: {launches}; row 5 by pass: {by_pass(tally)}; {cg_counts(st)}")
    check(st["cg_iterations"] < PS_MAXITER,
          f"the CG sampler's block solve converged to {PS_TOL:g} in {st['cg_iterations']} "
          f"iterations (< {PS_MAXITER})")
    check(launches == only(gram_matvec=st["cg_iterations"] + 1)
          and tally == {("wide", PS_SAMPLES): st["cg_iterations"] + 1},
          f"every product of the CG sampler on row 5's wide pass at R = {PS_SAMPLES}: "
          f"{st['cg_iterations']} CG iterations + the update = {launches['gram_matvec']}")
    check(s.shape == (PS_SAMPLES, PS_N_TEST) and bool(torch.isfinite(s).all()),
          f"{PS_SAMPLES} samples finite at {PS_N_TEST} points (N={N_PS}), range "
          f"[{s.min().item():.4g}, {s.max().item():.4g}]")
    (_, b2), (_, e2) = timed(lambda: ps_sampler(fx, y, draws)), timed(lambda: fs(xq))
    print(f"time pathwise CG (kernels): build {build_ms:.3f} ms (rank-{PS_RANK} factor, "
          f"{st['cg_iterations']} CG iterations), evaluation at {PS_N_TEST} points "
          f"{eval_ms:.3f} ms; again {b2:.3f} + {e2:.3f} ms")
    with tgp.config_context(use_kernels=False):
        iterative.reset_stats()
        fsp, pbuild_ms = timed(lambda: ps_sampler(fx, y, draws))
        sp, peval_ms = timed(lambda: fsp(xq))
    check(iterative.stats["cg_iterations"] < PS_MAXITER, "the plain route's CG converged too")
    e = scale_rel(s, sp)
    print(f"time pathwise CG (plain, once): build {pbuild_ms:.3f} ms "
          f"({iterative.stats['cg_iterations']} CG iterations, Gram blocks of {LAP_BLOCK}), "
          f"evaluation {peval_ms:.3f} ms; samples kernels vs plain at N={N_PS}: {e:.3e} of "
          "their scale")
    check(e <= PS_ROUTE_RTOL32, f"pathwise CG N={N_PS}, kernels vs plain route: {e:.3e} <= "
          f"{PS_ROUTE_RTOL32:g} of the samples' scale")

    # at 2·10^4: the same draws on row 5, on the plain route and in f64
    xm, ym = x[:N_PS_MID], y[:N_PS_MID]
    fxm = ps_fx(theta, xm)
    dm = sampling.draw_cg(gen, fxm, PS_SAMPLES, PS_FEATURES)
    sk = ps_sampler(fxm, ym, dm)(xq)
    sp = _plain(lambda: ps_sampler(fxm, ym, dm)(xq))
    d64 = (sampling.RFFDraws(*(t.double() for t in dm[0])), dm[1].double(), dm[2].double())
    s64 = ps_sampler(ps_fx(theta.double(), xm.double()), ym.double(), d64)(xq.double())
    ekp, ek64, ep64 = scale_rel(sk, sp), scale_rel(sk, s64), scale_rel(sp, s64)
    check(ekp <= PS_ROUTE_RTOL32 and max(ek64, ep64) <= PS_F64_RTOL32,
          f"pathwise CG N={N_PS_MID}, the same draws, of the samples' scale: row 5 vs plain "
          f"{ekp:.3e} <= {PS_ROUTE_RTOL32:g}; vs f64: row 5 {ek64:.3e}, plain {ep64:.3e} <= "
          f"{PS_F64_RTOL32:g}")
    with torch.no_grad():
        xs = xq[:PS_N_MOMENT].double()
        mu, var = tgp.posterior_cg(ps_fx(theta.double(), xm.double()), ym.double(), tol=1e-8,
                                   block_size=LAP_BLOCK, precond_rank=PS_RANK).mean_and_var(xs)
    z = (sk[:, :PS_N_MOMENT].double().mean(0) - mu) / var.clamp(min=1e-30).sqrt()
    rms, zmax = z.pow(2).mean().sqrt().item(), z.abs().max().item()
    check(rms <= PS_MEAN_Z_RMS,
          f"pathwise CG N={N_PS_MID}: the {PS_SAMPLES}-sample mean against posterior_cg's (f64) "
          f"at {PS_N_MOMENT} points: RMS {rms:.3f} posterior s.d. (max {zmax:.3f}; "
          f"1/sqrt({PS_SAMPLES}) = {1 / math.sqrt(PS_SAMPLES):.3f} expected) <= {PS_MEAN_Z_RMS:g}")
    return launches


def phase_sampling_svgp(dev) -> dict:
    """Phase 16 (b): SVGP pathwise samples over 10^6 points.  Returns the
    path run's launches (the posterior build and the sweep under
    ``gram_mode="fused"``)."""
    tparams = convert.from_jax_params(slice_params(), device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    xs = torch.randn((N_TEST, D), generator=gen, device=dev)
    n_blocks = -(-N_TEST // BLOCK)

    def sweep(fs):
        with torch.no_grad():
            return [fs(xs[i:i + BLOCK]) for i in range(0, N_TEST, BLOCK)]

    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad(), tgp.config_context(gram_mode="fused"):
        post = build_posterior(tparams)
        fs = tgp.sample_svgp_functions(gen, post, PS_SAMPLES, SVGP_PS_FEATURES)
        out = sweep(fs)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"pathwise SVGP launches (fused Gram): {launches}")
    check(launches == only(gram_chol_inv=1, stationary_gram=n_blocks),
          f"row 1 once for the posterior build, row 11 once a block ({n_blocks})")
    check(all(bool(torch.isfinite(o).all()) and o.shape[0] == PS_SAMPLES for o in out),
          f"{PS_SAMPLES} samples finite at {N_TEST} points")
    with torch.no_grad():
        ref = fs(xs[:BLOCK])
        with tgp.config_context(gram_mode="fused"):
            got = fs(xs[:BLOCK])
    e = scale_rel(got, ref)
    check(e <= SVGP_PS_ROUTE_RTOL32, f"pathwise SVGP, one block, the fused Gram vs the default "
          f"route: {e:.3e} <= {SVGP_PS_ROUTE_RTOL32:g} of the samples' scale")
    for mode in ("auto", "fused"):
        with tgp.config_context(gram_mode=mode):
            ms = cuda_ms(lambda: sweep(fs), 3)
        print(f"time pathwise SVGP sweep (gram_mode={mode}): {ms:.3f} ms ({PS_SAMPLES} samples, "
              f"{SVGP_PS_FEATURES} features, {N_TEST} points in blocks of {BLOCK}, M={M})")
    with tgp.config_context(use_kernels=False):
        pp = build_posterior(tparams)
        fsp = tgp.sample_svgp_functions(torch.Generator(device=dev).manual_seed(SEED + 41), pp,
                                        PS_SAMPLES, SVGP_PS_FEATURES)
        ms = cuda_ms(lambda: sweep(fsp), 3)
    print(f"time pathwise SVGP sweep (plain path): {ms:.3f} ms")

    # moments: 256 samples at 2048 points against mean_and_var
    with torch.no_grad():
        xm = xs[:SVGP_PS_MOMENT_N]
        s = tgp.sample_svgp_functions(gen, post, SVGP_PS_MOMENT_S, SVGP_PS_FEATURES)(xm).double()
        mu, var = (t.double() for t in post.mean_and_var(xm))
    n = SVGP_PS_MOMENT_S
    zm = ((s.mean(0) - mu) / (var / n).sqrt()).abs().max().item()
    zv = ((s.var(0) - var) / (var * math.sqrt(2.0 / (n - 1)))).abs().max().item()
    check(max(zm, zv) <= SVGP_PS_Z,
          f"pathwise SVGP, {n} samples at {SVGP_PS_MOMENT_N} points against mean_and_var: "
          f"largest distance of the mean {zm:.3f} and of the variance {zv:.3f} standard errors "
          f"<= {SVGP_PS_Z:g}")
    return launches


# -- phase 17: the multi-latent step ----------------------------------------------------------


def ml_params(dev, dtype) -> dict:
    """Both latents' raw parameters as one flat dict of leaves ("mean.k",
    ...): k = (0.5, 0.5), z ~ N(0, 1), phase 4's kind of non-trivial q."""
    rng = np.random.default_rng(SEED + 50)
    flat = {}
    for tag, m0 in (("mean", 0.0), ("logvar", -2.0)):
        p = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)),
             "m": m0 / 10 + 0.3 * rng.standard_normal(M),
             "A": 0.6 * np.eye(M) + 0.01 * np.tril(rng.standard_normal((M, M)))}
        for k, v in convert.from_jax_params(p, device=dev, dtype=dtype).items():
            flat[f"{tag}.{k}"] = v.requires_grad_()
    return flat


def ml_loss(p: dict, xb, yb):
    nested = {"mean": {}, "logvar": {}}
    for key, v in p.items():
        tag, k = key.split(".")
        nested[tag][k] = v
    return convert.heteroscedastic_loss(nested, xb, yb, num_data=N_DATA, n_gh=ML_GH,
                                        jitter=JITTER)


def phase_multi_latent(dev) -> dict:
    """Phase 17: the heteroscedastic two-latent SVGP step.  Returns the path
    run's launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn((N_DATA, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.exp(0.3 * x[:, 1]) * torch.randn(
        (N_DATA,), generator=gen, device=dev)

    def batches(n):
        for _ in range(n):
            idx = torch.randint(0, N_DATA, (BATCH,), generator=gen, device=dev)
            yield x[idx], y[idx]

    xb, yb = next(batches(1))
    reset_counts()
    v, g = value_and_grad(ml_loss, ml_params(dev, torch.float32), xb, yb)
    torch.cuda.synchronize()
    one = read_counts()
    check(one == only(gram_chol_inv=2), f"one value and gradient: row 1 once a latent ({one})")
    with tgp.config_context(use_kernels=False):
        vp, gp = value_and_grad(ml_loss, ml_params(dev, torch.float32), xb, yb)
        v64, g64 = value_and_grad(ml_loss, ml_params(dev, torch.float64), xb.double(),
                                  yb.double())
    check_grads("multi-latent step 1, kernels vs plain path f32", v, g, vp, gp, GRAD_RTOL)
    check_grads("multi-latent step 1, kernels vs f64 plain path", v, g, v64, g64, ML_F64_RTOL32)
    print("multi-latent step 1, plain path f32 vs f64: "
          + ", ".join(f"d{k} {rel_err(gp[k], g64[k]):.3e}" for k in gp))

    p = {k: t.detach() for k, t in ml_params(dev, torch.float32).items()}
    reset_counts()
    p, losses = tgp.adam_fit(ml_loss, p, batches(ML_STEPS), learning_rate=LR)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"multi-latent launches over {ML_STEPS} steps: {launches}")
    check(launches == only(gram_chol_inv=2 * ML_STEPS),
          f"row 1 twice a step ({ML_STEPS} steps), nothing else")
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all())
                                                     for t in p.values()),
          f"{ML_STEPS} Adam steps: no NaN (loss {losses[0].item():.6g} -> "
          f"{losses[-1].item():.6g})")
    for label, use in (("kernels", True), ("plain", False)):
        with tgp.config_context(use_kernels=use):
            q = {k: t.detach() for k, t in ml_params(dev, torch.float32).items()}
            ms = cuda_ms(lambda: tgp.adam_fit(ml_loss, q, batches(10), LR), 3) / 10
        print(f"time multi-latent step ({label}): {ms:.3f} ms a step (Adam, B={BATCH}, M={M} a "
              f"latent, {ML_GH ** 2} Gauss-Hermite nodes)")
    return launches


# -- phase 18: online SVGP --------------------------------------------------------------------


def online_prior(dev, dtype):
    """Phase 4's kernel and inducing points: (f, fz)."""
    tp = convert.from_jax_params(slice_params(), device=dev, dtype=dtype)
    _, f = bench_sva(tp)
    return f, f(tp["z"], JITTER)


def site_stream(f, fz, x, y):
    st = tgp.site_state(fz)
    for i in range(0, x.shape[0], BLOCK):
        st = tgp.site_update(st, f(x[i:i + BLOCK], NOISE), y[i:i + BLOCK])
    return tgp.site_posterior_q(st)


def phase_online(dev) -> dict:
    """Phase 18: the fixed-site stream, its agreement with the batch
    optimum, and one online_elbo value and gradient.  Returns the launches of
    the stream and the bound's run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((N_STREAM, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + math.sqrt(NOISE) * torch.randn((N_STREAM,), generator=gen,
                                                            device=dev)
    f, fz = online_prior(dev, torch.float32)
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        q, stream_ms = timed(lambda: site_stream(f, fz, x, y))
    stream = read_counts()
    check(stream == only() and bool(torch.isfinite(q.mean).all()
                                    and torch.isfinite(q.scale_tril).all()),
          f"site stream over {N_STREAM} points in {N_STREAM // BLOCK} blocks: q finite, "
          "no kernel")
    with torch.no_grad():
        ms = cuda_ms(lambda: site_stream(f, fz, x, y), 2)
    print(f"time online site stream: {stream_ms:.3f} ms (first), {ms:.3f} ms (median of 2; "
          f"{N_STREAM} points, {N_STREAM // BLOCK} blocks of {BLOCK}, M={M}, then "
          "site_posterior_q)")

    # the stream against the batch optimum at 2^16 points
    n = N_ONLINE_CHECK
    with torch.no_grad():
        qs = site_stream(f, fz, x[:n], y[:n])
        qb = tgp.optimal_variational_posterior(fz, f(x[:n], NOISE), y[:n])
        f64, fz64 = online_prior(dev, torch.float64)
        q64 = tgp.optimal_variational_posterior(fz64, f64(x[:n].double(), NOISE), y[:n].double())
    em, ec = rel_err(qs.mean, qb.mean), rel_err(qs.cov(), qb.cov())
    print(f"online stream vs batch optimum (f32) at {n} points: mean {em:.3e}, cov {ec:.3e}; "
          f"against the f64 batch optimum: stream mean {rel_err(qs.mean, q64.mean):.3e}, cov "
          f"{rel_err(qs.cov(), q64.cov()):.3e}; batch mean {rel_err(qb.mean, q64.mean):.3e}, cov "
          f"{rel_err(qb.cov(), q64.cov()):.3e}")
    check(max(em, ec) <= ONLINE_Q_RTOL32,
          f"online stream vs batch optimum f32: {max(em, ec):.3e} <= {ONLINE_Q_RTOL32:g}")

    # online_elbo after the first round: a NonCentered approximation at new points
    state = tgp.OnlineSVGPState(fz, qs)
    rng = np.random.default_rng(SEED + 60)
    params = slice_params()
    params["z"] = params["z"] + 0.1 * rng.standard_normal((M, D))
    xb, yb = x[n:n + BATCH], y[n:n + BATCH]

    def loss_fn(p):
        sva, ff = bench_sva(p)
        return -tgp.online_elbo(sva, state, ff(xb, NOISE), yb, num_data=N_STREAM)

    reset_counts()
    v, g = value_and_grad(loss_fn, leaf_params(params, dev, torch.float32))
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == only(gram_chol_inv=1), f"online_elbo value and gradient: row 1 once "
          f"({launches})")
    check(bool(torch.isfinite(v)) and all(bool(torch.isfinite(t).all()) for t in g.values()),
          "online_elbo value and gradients finite")
    with tgp.config_context(use_kernels=False):
        vp, gp = value_and_grad(loss_fn, leaf_params(params, dev, torch.float32))
    check_grads("online_elbo, kernels vs plain path f32", v, g, vp, gp, GRAD_RTOL)
    for label, use in (("kernels", True), ("plain", False)):
        with tgp.config_context(use_kernels=use):
            q_ = leaf_params(params, dev, torch.float32)
            ms = cuda_ms(lambda: value_and_grad(loss_fn, q_), 5)
        print(f"time online_elbo value and gradient ({label}): {ms:.3f} ms (B={BATCH}, M={M}, "
              f"old sites M={M})")
    return {k: stream[k] + launches[k] for k in launches}


# -- phase 19: leave-one-out ------------------------------------------------------------------


def phase_loo(dev) -> dict:
    """Phase 19: loo_logpdf's value and θ-gradient, f32 against f64.  No
    kernel; returns the (zero) launches of the run."""
    rng = np.random.default_rng(SEED + 70)
    xn = np.sort(10.0 * rng.uniform(size=N_LOO))
    yn = np.sin(xn) + 0.1 * rng.standard_normal(N_LOO)

    def run(dtype, grad=True):
        th = torch.ones(2, dtype=dtype, device=dev, requires_grad=grad)
        x, yy = torch.tensor(xn, dtype=dtype, device=dev), torch.tensor(yn, dtype=dtype, device=dev)
        with torch.set_grad_enabled(grad):
            v = tgp.loo_logpdf(tgp.GP(convert.laplace_kernel(th))(x, LOO_NOISE), yy)
        return (v.detach(), torch.autograd.grad(v, th)[0]) if grad else v

    reset_counts()
    v, g = run(torch.float32)
    torch.cuda.synchronize()
    launches = read_counts()
    v64, g64 = run(torch.float64)
    ev, eg = abs(v.double().item() - v64.item()) / abs(v64.item()), rel_err(g, g64)
    check(launches == only() and ev <= LOO_VALUE_RTOL32 and eg <= LOO_GRAD_RTOL32,
          f"loo_logpdf N={N_LOO}, f32 vs f64: value {v.item():.8g} vs {v64.item():.8g}, rel err "
          f"{ev:.3e} <= {LOO_VALUE_RTOL32:g}; dθ {eg:.3e} <= {LOO_GRAD_RTOL32:g}; no kernel")
    for dtype in (torch.float32, torch.float64):
        ms_v = cuda_ms(lambda: run(dtype, grad=False), 5)
        ms_g = cuda_ms(lambda: run(dtype), 5)
        print(f"time loo_logpdf ({str(dtype)[6:]}): value {ms_v:.3f} ms, value and gradient "
              f"{ms_g:.3f} ms (N={N_LOO})")
    return launches


def same(a: torch.Tensor, b: torch.Tensor) -> str:
    """"bitwise equal" or the relative error, for the prints."""
    return "bitwise equal" if torch.equal(a, b) else f"rel err {rel_err(a, b):.3e}"


def phase_dp(dev) -> dict:
    """Phase 20: the data-parallel layer over an NCCL world of one; returns
    each path run's launches."""
    by_path = {}
    with world_of_one(dev) as mesh:
        print(f"data mesh: rank {mesh.rank} of {mesh.size} on {mesh.device}, backend "
              f"{torch.distributed.get_backend(mesh.group)}")
        by_path["dp_serving"] = dp_serving(dev, mesh)
        by_path["dp_minibatch"] = dp_minibatch(dev, mesh)
        by_path["dp_streaming"] = dp_streaming(dev, mesh)
        by_path["dp_matrix_free"] = dp_matrix_free(dev, mesh)
    return by_path


def dp_serving(dev, mesh) -> dict:
    """(a) ``dp_predict_blocks`` over phase 4's 10^6 points."""
    tparams = convert.from_jax_params(slice_params(), device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn((N_TEST, D), generator=gen, device=dev, dtype=torch.float32)
    with torch.no_grad():
        reset_counts()
        post = build_posterior(tparams)
        mu, var = tgp.parallel.dp_predict_blocks(post, xs, mesh, block_size=BLOCK)
        torch.cuda.synchronize()
        launches = read_counts()
        n_blocks = -(-N_TEST // BLOCK)
        mu0, var0 = post.predict_blocks(xs, block_size=BLOCK)
        e = max(rel_err(mu, mu0), rel_err(var, var0))
        check(launches == only(gram_chol_inv=1, svgp_data_epilogue=n_blocks)
              and mu.shape == var.shape == (N_TEST,) and e <= DP_RTOL32,
              f"dp_predict_blocks over {N_TEST} points: row 1 once, row 2 {n_blocks} times "
              f"({launches}); against predict_blocks: mean {same(mu, mu0)}, variance "
              f"{same(var, var0)} (<= {DP_RTOL32:g})")
        dp_ms = cuda_ms(lambda: tgp.parallel.dp_predict_blocks(post, xs, mesh, BLOCK), 3)
        one_ms = cuda_ms(lambda: post.predict_blocks(xs, block_size=BLOCK), 3)
    print(f"time dp_predict_blocks {dp_ms:.3f} ms, predict_blocks {one_ms:.3f} ms over {N_TEST} "
          f"points (the layer at a world of one: {dp_ms - one_ms:.3f} ms; {CARD})")
    return launches


def dp_minibatch(dev, mesh) -> dict:
    """(b) ``make_dp_train_step`` on phase 5's cell against ``adam_fit``
    over the same batches from the same start."""
    rng = np.random.default_rng(SEED + 2)
    params = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)), "m": np.zeros(M),
              "A": np.eye(M)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((N_DATA, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + NOISE * torch.randn((N_DATA,), generator=gen, device=dev)
    idx = [torch.randint(0, N_DATA, (BATCH,), generator=gen, device=dev) for _ in range(STEPS)]
    batches = [(x[i], y[i]) for i in idx]

    def start():
        return {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}

    p = start()
    reset_counts()
    step = tgp.parallel.make_dp_train_step(
        minibatch_loss, lambda ls: torch.optim.Adam(ls, lr=LR), mesh)
    losses = [step(p, xb, yb)[1] for xb, yb in batches]
    torch.cuda.synchronize()
    launches = read_counts()
    q, losses0 = tgp.adam_fit(minibatch_loss, start(), batches, learning_rate=LR)
    el = rel_err(torch.stack(losses), torch.stack(losses0))
    ep = {k: rel_err(p[k], q[k]) for k in p}
    check(launches == only(gram_chol_inv=STEPS) and el <= DP_RTOL32
          and max(ep.values()) <= DP_RTOL32,
          f"make_dp_train_step, {STEPS} Adam steps: row 1 once a step "
          f"({launches['gram_chol_inv']}); against adam_fit on the same batches: losses "
          f"{same(torch.stack(losses), torch.stack(losses0))}, parameters "
          + ", ".join(f"{k} {same(p[k], q[k])}" for k in p)
          + f" (<= {DP_RTOL32:g})")
    reps = 10
    dp_ms = cuda_ms(lambda: [step(p, xb, yb) for xb, yb in batches[:reps]], 3) / reps
    one_ms = cuda_ms(lambda: tgp.adam_fit(minibatch_loss, q, batches[:reps], LR), 3) / reps
    print(f"time minibatch step: make_dp_train_step {dp_ms:.3f} ms, adam_fit {one_ms:.3f} ms a "
          f"step (the layer: {dp_ms - one_ms:.3f} ms; {CARD})")
    return launches


def dp_streaming(dev, mesh) -> dict:
    """(c) ``dp_streaming_elbo`` at phase 6's 2^20 points."""
    params = slice_params()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((N_STREAM, D), generator=gen, device=dev)
    y = torch.sin(x[:, 0])
    lik = tgp.GaussianLikelihood(NOISE)

    def loss_dp(p):
        sva, _ = bench_sva(p)
        return -tgp.dp_streaming_elbo(sva, lik, x, y, mesh, block_size=BLOCK)

    def loss_one(p):
        sva, _ = bench_sva(p)
        return -tgp.streaming_elbo(sva, lik, x, y, block_size=BLOCK)

    calls = stream_calls(dev)
    reset_counts()
    v, g = value_and_grad(loss_dp, leaf_params(params, dev, torch.float32))
    torch.cuda.synchronize()
    launches = read_counts()
    v0, g0 = value_and_grad(loss_one, leaf_params(params, dev, torch.float32))
    e = max([rel_err(v, v0)] + [rel_err(g[k], g0[k]) for k in g])
    check(launches == only(svgp_data_epilogue=calls, svgp_data_epilogue_bwd=calls,
                           chol_inv=1) and e <= DP_RTOL32,
          f"dp_streaming_elbo N={N_STREAM}: row 4 once, rows 2 and 3 {calls} times each "
          f"({launches}); against streaming_elbo: value {same(v, v0)}, gradients "
          + ", ".join(f"d{k} {same(g[k], g0[k])}" for k in g) + f" (<= {DP_RTOL32:g})")
    q = leaf_params(params, dev, torch.float32)
    dp_ms = cuda_ms(lambda: value_and_grad(loss_dp, q), 3)
    one_ms = cuda_ms(lambda: value_and_grad(loss_one, q), 3)
    print(f"time streaming value and gradient: dp_streaming_elbo {dp_ms:.3f} ms, streaming_elbo "
          f"{one_ms:.3f} ms (the layer: {dp_ms - one_ms:.3f} ms; {CARD})")
    return launches


def dp_matrix_free(dev, mesh) -> dict:
    """(d) the matrix-free tier on row bands against the single-card
    routes."""
    launches = {k: 0 for k in COUNTERS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = 10.0 * torch.rand((N_GP, D_GP), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((N_GP,), generator=gen, device=dev)
    xs = 10.0 * torch.rand((GP_N_TEST, D_GP), generator=gen, device=dev)
    probes = iterative.rademacher_probes(gen, GP_PROBES, N_GP, torch.float32, dev)
    theta0 = convert.from_jax_params(GP_THETA, device=dev, dtype=torch.float32)
    Lk = iterative.pivoted_cholesky(convert.build_exact_fx(theta0, x).f.kernel, x, GP_RANK)

    def slq(m):
        th = theta0.clone().requires_grad_()
        v = -tgp.logpdf_slq(convert.build_exact_fx(th, x), y, probes=probes, precond_Lk=Lk,
                            mesh=m, **GP_SLQ)
        return v.detach(), torch.autograd.grad(v, th)[0]

    def serve(m):
        with torch.no_grad():
            post = tgp.posterior_cg(convert.build_exact_fx(theta0, x), y, tol=GP_SLQ["cg_tol"],
                                    precond_rank=GP_RANK, block_size=GP_SLQ["block_size"], mesh=m)
            return post.mean_and_var(xs)

    tally = {}
    with row5_by_pass(tally):
        (v, g), got = counted(lambda: slq(mesh), launches)
    st, passes = dict(iterative.stats), dict(gram_matvec.pullback_passes)
    v0, g0 = slq(None)
    check(got == only(gram_matvec=st["matvec_fused"] + passes["passes"])
          and st["matvec_plain"] == 0 and rel_err(v, v0) <= DP_RTOL32
          and rel_err(g, g0) <= DP_RTOL32,
          f"logpdf_slq(mesh) N={N_GP}: {got['gram_matvec']} row-5 launches = {st['matvec_fused']} "
          f"band matvecs + {passes['passes']} pullback passes ({by_pass(tally)}), none plain; "
          f"against the single card: value {same(v, v0)}, θ-gradient {same(g, g0)} "
          f"(<= {DP_RTOL32:g})")
    slq_ms, slq0_ms = cuda_ms(lambda: slq(mesh), 2), cuda_ms(lambda: slq(None), 2)
    tally = {}
    with row5_by_pass(tally):
        (mu, var), got = counted(lambda: serve(mesh), launches)
    mu0, var0 = serve(None)
    check(got["gram_matvec"] > 0 and rel_err(mu, mu0) <= DP_RTOL32
          and rel_err(var, var0) <= DP_RTOL32,
          f"posterior_cg(mesh) at {GP_N_TEST} points: {got['gram_matvec']} row-5 launches "
          f"({by_pass(tally)}); against the single card: mean {same(mu, mu0)}, variance "
          f"{same(var, var0)} (<= {DP_RTOL32:g})")
    serve_ms, serve0_ms = cuda_ms(lambda: serve(mesh), 2), cuda_ms(lambda: serve(None), 2)
    print(f"time exact GP on the band route (medians of 2 after a warm-up): logpdf_slq value and "
          f"θ-gradient {slq_ms:.3f} ms (single card {slq0_ms:.3f}), posterior_cg serve "
          f"{serve_ms:.3f} ms (single card {serve0_ms:.3f}) ({CARD})")

    # CG-Newton at 10^5 (chunked: the cross pass) and 2·10^4 (the stored band)
    xl, yl = convert.laplace_data(N_LAP, D_LAP, seed=SEED + 51, device=dev)
    theta = torch.tensor(convert.LAPLACE_CG_THETA, dtype=torch.float32, device=dev)
    big = dict(precond_rank=LAP_RANK, block_size=LAP_BLOCK)
    tally = {}
    with row5_by_pass(tally):
        (f, n), got = counted(lambda: lap_mode(theta, xl, yl, mesh=mesh, **big), launches)
    st = dict(iterative.stats)
    f0, n0 = lap_mode(theta, xl, yl, **big)
    check(got == only(gram_matvec=st["matvec_fused"]) and st["matvec_plain"] == 0
          and n == n0 and rel_err(f, f0) <= DP_RTOL32,
          f"newton_inner_loop_cg(mesh) N={N_LAP} chunked: {n} Newton steps (single card {n0}), "
          f"{got['gram_matvec']} row-5 launches ({by_pass(tally)}); the mode against the single "
          f"card {same(f, f0)} (<= {DP_RTOL32:g})")
    mode_ms = cuda_ms(lambda: lap_mode(theta, xl, yl, mesh=mesh, **big), 2)
    mode0_ms = cuda_ms(lambda: lap_mode(theta, xl, yl, **big), 2)
    xm, ym = xl[:N_LAP_MID], yl[:N_LAP_MID]
    dense = dict(precond_rank=LAP_RANK_MID, storage="dense")
    torch.cuda.reset_peak_memory_stats()
    (fd, nd), got = counted(lambda: lap_mode(theta, xm, ym, mesh=mesh, **dense), launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fd0, nd0 = lap_mode(theta, xm, ym, **dense)
    ed = rel_err(fd, fd0)
    check(got == only() and ed <= DP_DENSE_RTOL32,
          f"newton_inner_loop_cg(mesh) N={N_LAP_MID} dense: {nd} Newton steps (single card "
          f"{nd0}), no kernel launched, peak {peak:.2f} GiB (the band {N_LAP_MID}² f32 "
          f"{4 * N_LAP_MID ** 2 / 2**30:.2f} GiB); the mode against the single card's resident "
          f"Gram rel err {ed:.3e} <= {DP_DENSE_RTOL32:g}")
    dense_ms = cuda_ms(lambda: lap_mode(theta, xm, ym, mesh=mesh, **dense), 2)
    dense0_ms = cuda_ms(lambda: lap_mode(theta, xm, ym, **dense), 2)
    # the lml's θ-gradient at 2·10^4 on the band route (the general pullback's
    # transposed pass, the lengthscale's r²·g′ pass) against the f64 run
    pm = iterative.rademacher_probes(torch.Generator(device=dev).manual_seed(SEED + 52),
                                     LAP_PROBES, N_LAP, torch.float32, dev)[:, :N_LAP_MID]
    chunked = dict(precond_rank=LAP_RANK_MID, storage="chunked", block_size=LAP_BLOCK)
    tally = {}
    with row5_by_pass(tally):
        (vb, gb), got = counted(lambda: lap_lml(theta, xm, ym, pm, True, mesh=mesh, **chunked),
                                launches)
    vs, gs = lap_lml(theta, xm, ym, pm, True, **chunked)
    _, g64 = lap_lml(theta.double(), xm.double(), ym, pm.double(), True, **chunked)
    eb, es = rel_err(gb, g64), rel_err(gs, g64)
    check(got["gram_matvec"] > 0 and rel_err(vb, vs) <= DP_RTOL32
          and eb <= max(LAP_GRAD_RTOL32, 2 * es),
          f"laplace_cg_lml(mesh) N={N_LAP_MID}: {got['gram_matvec']} row-5 launches "
          f"({by_pass(tally)}); value against the single card {same(vb, vs)}; θ-gradient against "
          f"the f64 run: band route {eb:.3e}, single card {es:.3e}, <= max({LAP_GRAD_RTOL32:g}, "
          f"2 × the single card's) (band {gb.tolist()}, f64 {g64.tolist()})")
    lml_ms = cuda_ms(lambda: lap_lml(theta, xm, ym, pm, True, mesh=mesh, **chunked), 2)
    lml0_ms = cuda_ms(lambda: lap_lml(theta, xm, ym, pm, True, **chunked), 2)
    print(f"time Laplace on the band route (medians of 2 after a warm-up): newton_inner_loop_cg "
          f"N={N_LAP} {mode_ms:.3f} ms (single card {mode0_ms:.3f}), N={N_LAP_MID} dense "
          f"{dense_ms:.3f} ms (single card {dense0_ms:.3f}), laplace_cg_lml with θ-gradient "
          f"N={N_LAP_MID} {lml_ms:.3f} ms (single card {lml0_ms:.3f}) ({CARD})")
    return launches


def storage_errors(v, g, v_ref, g_ref) -> tuple[float, dict, bool]:
    """(value's relative error, each gradient's relative error, every
    gradient finite) of a bf16-storage step against the f32 one."""
    ev = abs(v.double().item() - v_ref.double().item()) / abs(v_ref.double().item())
    eg = {k: rel_err(g[k], g_ref[k]) for k in g}
    return ev, eg, all(bool(torch.isfinite(t).all()) for t in g.values())


def phase_bf16(dev) -> dict:
    """Phase 21: phase 5's minibatch cell under ``compute_dtype="bfloat16"``
    (``bench.py``'s bf16 headline row)."""
    rng = np.random.default_rng(SEED + 2)
    params = {"k": np.array(RAW_K), "z": rng.standard_normal((M, D)), "m": np.zeros(M),
              "A": np.eye(M)}  # bench.py::_svgp_params
    batches = headline_batches(dev, SEED + 3)
    xb, yb = next(batches(1))
    # the S-correction's route (the cell's), and the route above s_corr_max_m (A = Lk⁻¹Kuf and
    # BᵀA stored in bf16, no S̄), which tells the S-correction's share of the gradients' gap
    for what, ps, cfg, limit in (
            ("bench q", params, {}, BF16_GRAD_RTOL),
            ("non-trivial q", slice_params(), {}, BF16_GRAD_RTOL),
            ("non-trivial q, no S-correction", slice_params(), {"s_corr_max_m": M // 2},
             BF16_NO_S_GRAD_RTOL)):
        with tgp.config_context(compute_dtype="float32", **cfg):
            v, g = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb)
        with tgp.config_context(compute_dtype="bfloat16", **cfg):
            vb, gb = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32), xb, yb)
        ev, eg, finite = storage_errors(vb, gb, v, g)
        check(ev <= BF16_VALUE_RTOL and max(eg.values()) <= limit and finite,
              f"bf16 minibatch step 1 ({what}) vs f32: rel err loss {ev:.3e} <= "
              f"{BF16_VALUE_RTOL:g}, " + ", ".join(f"d{k} {e:.3e}" for k, e in eg.items())
              + f" <= {limit:g}, all finite")

    p = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
    with tgp.config_context(compute_dtype="bfloat16"):
        reset_counts()
        p, losses = tgp.adam_fit(minibatch_loss, p, batches(STEPS), learning_rate=LR)
        torch.cuda.synchronize()
        launches = read_counts()
    print(f"bf16 minibatch launches over {STEPS} steps: {launches}")
    check(launches == only(gram_chol_inv=STEPS), f"row 1 launched once a step ({STEPS} steps)")
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all())
                                                     for t in p.values()),
          f"{STEPS} bf16 Adam steps: losses and parameters finite "
          f"(loss {losses[0].item():.6g} -> {losses[-1].item():.6g})")

    ms = {}
    for mode in ("float32", "bfloat16", "float32", "bfloat16"):
        with tgp.config_context(compute_dtype=mode):
            q = {k: t.detach() for k, t in leaf_params(params, dev, torch.float32).items()}
            reps = 10
            ms.setdefault(mode, []).append(
                cuda_ms(lambda: tgp.adam_fit(minibatch_loss, q, batches(reps), LR), 3) / reps)
    print(f"time minibatch step M={M}: f32 (phase 5's cell) "
          + ", ".join(f"{t:.3f}" for t in ms["float32"]) + " ms, bf16 storage "
          + ", ".join(f"{t:.3f}" for t in ms["bfloat16"]) + f" ms a step ({CARD})")
    return launches


# phase 22's three settings of the M = 8192 step: the defaults on the card (bf16 storage and
# the triangular products), f32, and f32 with the dense products
LARGE_SETTINGS = (("a: defaults (bf16, triangular)", {}),
                  ("b: compute_dtype=float32", {"compute_dtype": "float32"}),
                  ("c: float32, dense products", {"compute_dtype": "float32",
                                                  "tri_matmul_min_m": 2 * M_LARGE}))


def large_params(nontrivial: bool) -> dict:
    """``bench.py::_svgp_params`` at M = 8192 (k = (0.5, 0.5), z ~ N(0, 1),
    m = 0, A = I), or with phase 4's kind of non-trivial q, which reaches
    every term of the pullbacks."""
    rng = np.random.default_rng(SEED + 22)
    p = {"k": np.array(RAW_K), "z": rng.standard_normal((M_LARGE, D)), "m": np.zeros(M_LARGE),
         "A": np.eye(M_LARGE)}
    if nontrivial:
        p["m"] = 0.3 * rng.standard_normal(M_LARGE)
        p["A"] = 0.6 * np.eye(M_LARGE) + 0.01 * np.tril(rng.standard_normal((M_LARGE, M_LARGE)))
    return p


def phase_large_m(dev) -> dict:
    """Phase 22: the minibatch step at M = 8192 (``bench.py --M 8192``).
    Above s_corr_max_m the posterior build takes ``chol_with_inv``, so row 4
    runs once a step; returns each setting's launches."""
    batches = headline_batches(dev, SEED + 23)
    xb, yb = next(batches(1))
    ps = large_params(True)
    step1 = {}
    for label, cfg in LARGE_SETTINGS + (("plain: float32, chol_mode=plain",
                                         {"compute_dtype": "float32", "chol_mode": "plain"}),):
        with tgp.config_context(**cfg):
            reset_counts()
            step1[label[0]] = value_and_grad(minibatch_loss, leaf_params(ps, dev, torch.float32),
                                             xb, yb)
            torch.cuda.synchronize()
            n = read_counts()["chol_inv"]
        check(n == (0 if label.startswith("plain") else 1),
              f"M={M_LARGE} step 1 ({label}): row 4 launched {n} times")
    check_grads(f"M={M_LARGE} step 1 (b) vs (c), triangular vs dense products", *step1["b"],
                *step1["c"], LARGE_DENSE_RTOL32)
    check_grads(f"M={M_LARGE} step 1 (b) vs chol_mode=plain (cuSOLVER)", *step1["b"],
                *step1["p"], LARGE_PLAIN_RTOL32)
    ev, eg, finite = storage_errors(*step1["a"], *step1["b"])
    check(ev <= BF16_VALUE_RTOL and max(eg.values()) <= LARGE_BF16_GRAD_RTOL and finite,
          f"M={M_LARGE} step 1 (a) bf16 storage vs (b) f32: rel err loss {ev:.3e} <= "
          f"{BF16_VALUE_RTOL:g}, " + ", ".join(f"d{k} {e:.3e}" for k, e in eg.items())
          + f" <= {LARGE_BF16_GRAD_RTOL:g}, all finite")
    del step1

    launches = {}
    for label, cfg in LARGE_SETTINGS:
        with tgp.config_context(**cfg):
            p = {k: t.detach() for k, t in leaf_params(large_params(False), dev,
                                                       torch.float32).items()}
            tgp.adam_fit(minibatch_loss, p, batches(1), learning_rate=LR)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            (p, losses), ms = timed(lambda: tgp.adam_fit(minibatch_loss, p, batches(LARGE_STEPS),
                                                         learning_rate=LR))
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches[f"m8192_{label[0]}"] = counts
        losses = torch.stack(losses)
        check(counts == only(chol_inv=LARGE_STEPS)
              and bool(torch.isfinite(losses).all())
              and all(bool(torch.isfinite(t).all()) for t in p.values()),
              f"M={M_LARGE} ({label}): row 4 launched once a step, {LARGE_STEPS} steps finite "
              f"(loss {losses[0].item():.6g} -> {losses[-1].item():.6g})")
        print(f"time M={M_LARGE} step ({label}): {ms / LARGE_STEPS:.3f} ms a step (Adam, "
              f"B={BATCH}, {LARGE_STEPS} steps), peak memory {peak:.2f} GiB ({CARD})")
        del p
    return launches


# the row of the kernels table each counter stands for (PERF.md §6)
ROWS = {"gram_chol_inv": "1", "svgp_data_epilogue": "2", "svgp_data_epilogue_bwd": "3",
        "chol_inv": "4", "gram_matvec": "5", "batched_chol_solve_band": "6",
        "vecchia_band": "7/8/10", "vecchia_band_bwd": "9", "stationary_gram": "11"}


def phase_examples(dev, full: bool = False) -> dict:
    """Phase 23: each twin of ``examples/`` (``examples/torch/``) on the card,
    its own asserts live, at ``scripts/run_examples.py``'s reduced sizes
    (``full``: at its own defaults), each run with the counts set to 0 just
    before it; prints each one's seconds and its launches by row.  With
    ``full`` every twin runs and the failures are reported together."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "examples" / "torch"))
    import run_twins

    by_path, failed = {}, []
    for name, (mod_name, _) in run_twins.RUNS.items():
        reset_counts()
        try:
            sec = run_twins.run(name, full=full, device=dev, sync=torch.cuda.synchronize)
        except AssertionError as e:
            if not full:
                check(False, f"example {name} ({mod_name}) failed its assert: {e!r}")
            failed.append(name)
            print(f"FAIL example {name} ({mod_name}){' full size' if full else ''}: {e!r}")
            continue
        counts = read_counts()
        by_path[f"example_{name}"] = counts
        rows = ", ".join(f"row {ROWS[k]} {n}" for k, n in counts.items() if n) or "none"
        print(f"example {name} ({mod_name}){' full size' if full else ''}: {sec:.1f} s, "
              f"launches: {rows} ({CARD})")
    check(not failed, f"every example twin passed its asserts (failed: {failed})")
    return by_path


@contextlib.contextmanager
def world_of_one(dev):
    """A ``torch.distributed`` world of this one process on a free port of
    127.0.0.1 (NCCL on the card, gloo for a rehearsal on the CPU), and its
    data mesh; the group is destroyed on the way out."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    try:
        yield tgp.parallel.data_mesh(device=dev)
    finally:
        dist.destroy_process_group()


def _plain(fn, *args):
    with tgp.config_context(use_kernels=False):
        return fn(*args)


def main() -> None:
    if "--examples-full" in sys.argv[1:]:
        return examples_full()
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    numbers = phase_parity(dev)
    by_path = {
        "serving": phase_slice(dev),
        "minibatch": phase_minibatch(dev),
        "streaming": phase_streaming(dev),
        "exact_gp": phase_exact_gp(dev),
    }
    by_path["vecchia"], numbers["vecchia_band"] = phase_vecchia(dev)
    by_path["vecchia_train"], numbers["vecchia_band_bwd"] = phase_vecchia_train(dev)
    by_path["vecchia_rows"], numbers["batched_chol_solve_band"] = phase_band_rows(dev)
    by_path["fused_gram"], numbers["stationary_gram"] = phase_fused_gram(dev)
    by_path["natgrad"] = phase_natgrad(dev)
    by_path["poisson"] = phase_poisson(dev)
    by_path["block_vecchia"] = phase_block_vecchia(dev)
    by_path["laplace"], r1 = phase_laplace(dev)
    numbers["gram_matvec"].update(r1)
    by_path["pathwise_cg"] = phase_sampling_cg(dev)
    by_path["pathwise_svgp"] = phase_sampling_svgp(dev)
    by_path["multi_latent"] = phase_multi_latent(dev)
    by_path["online"] = phase_online(dev)
    by_path["loo"] = phase_loo(dev)
    by_path.update(phase_dp(dev))
    by_path["bf16"] = phase_bf16(dev)
    by_path.update(phase_large_m(dev))
    by_path.update(phase_examples(dev))
    meta = {
        "gram_chol_inv": ("approximategps_tpu_torch/csrc/gram_chol_inv_mma.cu",
                          "approximategps_tpu/ops/panel_chol.py:405"),
        "svgp_data_epilogue": ("approximategps_tpu_torch/csrc/svgp_epilogue_mma.cu",
                               "approximategps_tpu/ops/svgp_epilogue.py:201"),
        "svgp_data_epilogue_bwd": ("approximategps_tpu_torch/csrc/svgp_epilogue_bwd_mma.cu",
                                   "approximategps_tpu/ops/svgp_epilogue.py:271"),
        "chol_inv": ("approximategps_tpu_torch/csrc/gram_chol_inv_mma.cu",
                     "approximategps_tpu/ops/panel_chol.py:338"),
        "gram_matvec": ("approximategps_tpu_torch/csrc/gram_matvec.cu",
                        "approximategps_tpu/ops/gram_matvec.py:151"),
        "vecchia_band": ("approximategps_tpu_torch/csrc/vecchia_band.cu",
                         "approximategps_tpu/ops/batched_chol.py:747"),
        "vecchia_band_bwd": ("approximategps_tpu_torch/csrc/vecchia_band_bwd.cu",
                             "approximategps_tpu/ops/batched_chol.py:1029"),
        "batched_chol_solve_band": ("approximategps_tpu_torch/csrc/band_rows.cu",
                                    "approximategps_tpu/ops/batched_chol.py:324"),
        "stationary_gram": ("approximategps_tpu_torch/csrc/stationary_gram.cu",
                            "approximategps_tpu/ops/gram.py:94"),
    }
    # the one band kernel takes the place of rows 7, 8 and 10 of the table
    # (the warp-per-window machinery of rows 8, 9 and 6 is one shared header)
    window = ["approximategps_tpu_torch/csrc/vecchia_window.cuh"]
    also = {"vecchia_band": {"rows": [7, 8, 10], "replaces_also": [
        "approximategps_tpu/ops/batched_chol.py:485",
        "approximategps_tpu/ops/batched_chol.py:1134"], "sources_also": window},
            "vecchia_band_bwd": {"sources_also": window},
            "batched_chol_solve_band": {"sources_also": window},
            # row 5 is three kernels: the narrow pass, the wide pass and the
            # self-Gram's one-pass pullback, all counted on one counter
            # rows 2 and 3: the f32 tensor-core kernel (the path's) and the
            # SIMT kernel (f64, and f32 at D > 8), each on one counter
            "svgp_data_epilogue": {"sources_also": [
                "approximategps_tpu_torch/csrc/svgp_epilogue.cu",
                "approximategps_tpu_torch/csrc/svgp_epilogue_mma.cuh"]},
            "svgp_data_epilogue_bwd": {"sources_also": [
                "approximategps_tpu_torch/csrc/svgp_epilogue_bwd.cu",
                "approximategps_tpu_torch/csrc/svgp_epilogue_mma.cuh"]},
            # rows 1 and 4: the f32 panel steps (the paths') and the host loop
            # (f64), each row on one counter
            "gram_chol_inv": {"sources_also": [
                "approximategps_tpu_torch/csrc/gram_chol_inv.cu"]},
            "chol_inv": {"sources_also": [
                "approximategps_tpu_torch/csrc/gram_chol_inv.cu"]},
            "gram_matvec": {"sources_also": [
                "approximategps_tpu_torch/csrc/gram_matvec_mma.cu",
                "approximategps_tpu_torch/csrc/gram_matvec_self_bwd.cu"]}}
    kernels = []
    for k, (src, rep) in meta.items():
        per_path = {path: counts[k] for path, counts in by_path.items()}
        # no single PyTorch call computes any of the nine functions
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        **also.get(k, {}), "launches": sum(per_path.values()),
                        "launches_by_path": per_path, "library_ms": None,
                        **numbers[k]})
    # row 4 again at phase 22's M = 8192 (phase 3's numbers there; its launches in phase 22)
    large = {path: counts["chol_inv"] for path, counts in by_path.items()
             if path.startswith("m8192_")}
    src, rep = meta["chol_inv"]
    kernels.append({"name": "chol_inv@M=8192", "route": "cuda", "source": src, "replaces": rep,
                    **also["chol_inv"], "launches": sum(large.values()),
                    "launches_by_path": large, "library_ms": None,
                    **numbers["chol_inv@M=8192"]})
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched by a path run")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def examples_full() -> int:
    """``--examples-full``: phases 1 and 2, then phase 23 with every twin at
    its own default sizes; the last line as in the default run."""
    name = phase_device()
    phase_build()
    phase_examples(torch.device("cuda", 0), full=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
