#!/usr/bin/env python3
"""Where the time of the PyTorch port's SVGP serving sweep, streaming step
and minibatch training step goes, on one CUDA GPU.

    python3 scripts/profile_svgp_torch.py [sweep] [streaming] [minibatch] [fused] [row1]
        [row4] [row11] [natgrad]

Builds ``chip_smoke.py``'s phase-4 posterior (M = 2048, D = 8, SE, a
non-trivial q), phase-6 streaming loss (N = 2^20 points, blocks of 16384)
and phase-5 minibatch step (Adam on −``elbo`` over 8192 points gathered
from 10^6, the bench's parameters), runs each once to warm up, then
profiles with ``torch.profiler`` one ``predict_blocks`` sweep over 10^6
points, one value and gradient of −``streaming_elbo``, one Adam step
(``minibatch``), one Adam step under ``gram_mode="fused"`` (``fused``),
one call of row 1 (``gram_chol_inv`` at M = 2048, D = 8, f32), one of
row 4 (``chol_inv`` of phase 3's f32 matrix at M = 2048) and 20 of row 11
(``stationary_gram_pass`` at the step's Kuf, (2048, 8192, 8) SE f32):
the device time by kernel name, the device's busy share of the wall time
and, for the steps and rows 1 and 4, the longest idle gaps between device
events and each panel step's time in order; for row 11 also the median
CUDA-event window of one call beside the median device time of its
kernel and the host time a call of the wrapper and of the autograd
Function around it; and one step of phase 12's natural-gradient hybrid
step (``natgrad``): the device time by kernel with rows 1 and 4 (the f32
panel steps ``step_kernel<false>`` and ``step_kernel<true>``) listed apart,
the idle share, the idle time by the host operation begun inside each gap
and the longest idle gaps with theirs (what the host was doing while the
card waited).
The arguments pick the parts
(all without any).  Prints the card's name and power limit first.  Needs
a CUDA device (it exits non-zero without one).  To measure an older tree
of the package, copy this script, ``profile_exact_gp_torch.py`` and
``chip_smoke.py`` into that tree and run it there.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.core import kernels as tk  # noqa: E402
from approximategps_tpu_torch.ops import gram, panel_chol  # noqa: E402
from profile_exact_gp_torch import idle_by_host_op, profile  # noqa: E402

PARTS = ("sweep", "streaming", "minibatch", "fused", "row1", "row4", "row11", "natgrad")


def main(parts) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if "sweep" in parts or "streaming" in parts:
        sweep_and_streaming(dev, parts)
    for mode, part in (("auto", "minibatch"), ("fused", "fused")):
        if part in parts:
            minibatch(dev, mode)
    if "row1" in parts or "row4" in parts:
        rows_1_4(dev, parts)
    if "row11" in parts:
        row11(dev)
    if "natgrad" in parts:
        natgrad(dev)


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


def minibatch(dev, mode: str) -> None:
    """One Adam step of phase 5 (``bench.py::headline``) under
    ``gram_mode`` ``mode``: "auto" (the default), or "fused" (phase 11's:
    the step's cross-Gram Kuf through row 11)."""
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
        with tgp.config_context(gram_mode=mode):
            tgp.adam_fit(cs.minibatch_loss, p, batches(1), learning_rate=cs.LR)

    step()
    profile(f"one minibatch Adam step, B={cs.BATCH}, M={cs.M}, gram_mode {mode}", step,
            top=16, gaps=8)


def rows_1_4(dev, parts) -> None:
    """Rows 1 and 4 alone at phase 3's f32 inputs (M = 2048, D = 8, SE):
    row 1 from the points, row 4 from their Gram plus the jitter and a
    small asymmetry (the kernel factors the symmetric part)."""
    rng = np.random.default_rng(cs.SEED + 1)
    rng.standard_normal((520, cs.D))  # phase 3's f64 inputs come first
    Z = torch.tensor(rng.standard_normal((cs.M, cs.D)), dtype=torch.float32, device=dev)
    sig2 = torch.tensor(1.3, device=dev)  # on the card, as the training step's
    se = tk.SqExponentialKernel().kernel_map()
    if "row1" in parts:
        def call1():
            panel_chol.gram_chol_inv(Z, sig2, cs.JITTER, se)

        call1()
        profile(f"row 1, gram_chol_inv M={cs.M} D={cs.D} f32", call1, top=12, gaps=8,
                sequence="step_kernel")
    if "row4" in parts:
        r2 = tk.pairwise_sq_dist(Z, Z, mode="broadcast")
        A = 1.3 * se.k_of_r2(r2) + cs.JITTER * torch.eye(cs.M, device=dev)
        A = A + 1e-7 * torch.triu(torch.ones_like(A), 1)

        def call4():
            panel_chol.chol_inv(A)

        call4()
        profile(f"row 4, chol_inv M={cs.M} f32", call4, top=12, gaps=8, sequence="step_kernel")


def row11(dev, calls: int = 20) -> None:
    """Row 11 at the minibatch step's Kuf ((2048, 8192, 8), SE, f32): the
    median CUDA-event window of one call (as ``chip_smoke.py`` times it)
    and the profile of ``calls`` calls, whose kernel's device time a call
    is the device-only time."""
    X = torch.randn((cs.M, cs.D), device=dev)
    Z = torch.randn((cs.BATCH, cs.D), device=dev)
    se = tk.SqExponentialKernel().kernel_map()

    def call():
        gram.stationary_gram_pass(X, Z, se)

    def host_ms(fn, n=200):
        """The host's side of a call alone: ``n`` calls, no sync until the last."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = 1e3 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return host

    event = cs.cuda_ms(call, 50)
    print(f"row 11, stationary_gram f32 N={cs.M} M={cs.BATCH} D={cs.D} se: CUDA-event window "
          f"{event:.4f} ms a call (median of 50); on the host (mean of 200 enqueued without a "
          f"sync) the wrapper {host_ms(call):.4f} ms a call, the autograd Function "
          f"{host_ms(lambda: gram.stationary_gram(X, Z, se)):.4f} ms")

    def many():
        for _ in range(calls):
            call()

    many()
    profile(f"row 11, {calls} calls of stationary_gram_pass", many, top=4, gaps=4)
    print(f"  device-only, a call: {cs.device_ms(call, 'stationary_gram', calls):.4f} ms "
          f"(median of {calls} kernel events)")


def natgrad(dev, gaps: int = 10) -> None:
    """One step of phase 12 (``bench.py::natgrad_hybrid``: Adam on k and z,
    the natural gradient on q, B = 8192 gathered from 10^6, M = 2048,
    D = 8) after two to warm up: device time by kernel, rows 1 and 4
    apart, and the idle gaps by the host operations begun inside them."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    x = torch.randn((cs.N_NAT, cs.D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + cs.NOISE * torch.randn((cs.N_NAT,), generator=gen, device=dev)
    step, init = tgp.make_natgrad_adam_step(cs.nat_elbo, learning_rate=cs.LR, nat_lr=cs.NAT_LR)
    carry = [init(*cs.nat_start(dev, torch.float32))]

    def one():
        idx = torch.randint(0, cs.N_NAT, (cs.BATCH,), generator=gen, device=dev)
        carry[0] = step(carry[0], x[idx], y[idx])[0]

    one()
    one()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    dev_ev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    rows = {"step_kernel<false>": "row 1 (gram_chol_inv)", "step_kernel<true>": "row 4 (chol_inv)"}
    by_name: dict[str, list] = {}
    for e in dev_ev:
        label = next((r for k, r in rows.items() if k in e.name), e.name)
        row = by_name.setdefault(label, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    span = (dev_ev[-1].time_range.end - dev_ev[0].time_range.start) / 1e3
    print(f"one natural-gradient hybrid step, B={cs.BATCH}, M={cs.M_NAT}: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %, idle "
          f"{100 * (1 - busy / wall):.1f} %), first to last device event {span:.3f} ms")
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:18]:
        print(f"  {ms:10.3f} ms  {calls:6d} calls  {name[:90]}")
    idle_by_host_op(prof, gaps)


if __name__ == "__main__":
    asked = [a for a in sys.argv[1:] if a in PARTS]
    if len(asked) != len(sys.argv[1:]):
        sys.exit(f"usage: {sys.argv[0]} [{'] ['.join(PARTS)}]")
    main(asked or PARTS)
