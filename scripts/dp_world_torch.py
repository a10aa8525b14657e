#!/usr/bin/env python3
"""The PyTorch port's data-parallel layer across the cards of one host.

    torchrun --nproc_per_node=4 scripts/dp_world_torch.py          # one rank a card (NCCL)
    torchrun --nproc_per_node=4 scripts/dp_world_torch.py --cpu    # a rehearsal: gloo, small sizes

Each rank takes ``parallel.data_mesh()`` (its card ``cuda:<LOCAL_RANK>``).
At ``chip_smoke.py`` phase 20's widths, in f32: (a) ``dp_predict_blocks``
over 10^6 points (each rank a quarter); (b) 10 ``make_dp_train_step``
steps on the minibatch cell (each rank a quarter of the 8192 points) from
the same start and on the same batches as ``adam_fit``; (c)
``dp_streaming_elbo``'s value and gradient at 2^20 points; (d)
``logpdf_slq``'s value and θ-gradient and a ``posterior_cg`` serve at
phase 7's exact GP (N = 10^5), every product on row bands of N / 4 rows.
Each result is held against rank 0's single-card run of the same call on
the same inputs (the other ranks wait at a barrier meanwhile), and every
rank's result is all-gathered and must be the same bits.  Each check's
limit is a few times its reading on four H100s (the constants below).
Times are CUDA-event medians on rank 0 (host clock with ``--cpu``), the
world's call beside the single card's.  Rank 0 prints, the card's name and power limit
first; a failed check exits non-zero.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.models import iterative  # noqa: E402
from approximategps_tpu_torch.ops import _build  # noqa: E402

CPU = "--cpu" in sys.argv[1:]
STEPS = 10
# Limits at four ranks in f32, relative to the largest entry, each a few times the largest
# reading of the first run of this script on four NVIDIA H100 80GB HBM3 cards at 700 W:
# (a) the ranks' shards end in other blocks than the single card's sweep (read 2.3e-6 on the
# mean, 7.3e-6 on the variance)
SERVE_RTOL32 = 3e-5
# (b), (c) values and losses, the batch or the stream summed in another order (read 7.3e-8 on
# the first batch's loss, 1.5e-7 on the 10 losses, 8.6e-8 on the stream's value)
VALUE_RTOL32 = 5e-7
# (b), (c) gradients (read at most 4.0e-5, dA of the first batch; the stream's dA 2.9e-5)
GRAD_RTOL32 = 2e-4
# (b) the parameters after the steps: Adam's normalisation moves entries whose gradient is
# near 0 (m = 0, A = I at the start) by O(lr) on rounding alone (read 1.2e-7 on k, 4.3e-4 on
# z, 1.9e-3 on m, 2.4e-3 on A)
PARAM_RTOL32 = 1e-2
# (d) the band route against the single card: the value, mean and variance the same bits, the
# θ-gradient through the general pullback in place of the self-Gram's (read 5.8e-8)
MF_RTOL32 = 3e-7
FAILS = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILS.append(what)


def ms(fn, reps: int) -> float:
    if not CPU:
        return cs.cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def alone(mesh, fn):
    """``fn()`` on rank 0 while the other ranks wait; None elsewhere."""
    out = fn() if mesh.rank == 0 else None
    dist.barrier(group=mesh.group)
    return out


def same_on_every_rank(mesh, t: torch.Tensor) -> bool:
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return all(torch.equal(p, parts[0]) for p in parts)


def timed_pair(mesh, label: str, world_fn, one_fn, reps: int, per: int = 1) -> None:
    """Each call's median over ``reps``, divided by the ``per`` steps it runs."""
    world_ms = ms(world_fn, reps) / per
    one_ms = alone(mesh, lambda: ms(one_fn, reps) / per)
    if mesh.rank == 0:
        print(f"time {label}: world of {mesh.size} {world_ms:.3f} ms, single card {one_ms:.3f} ms "
              f"(×{one_ms / world_ms:.2f}; medians of {reps} after a warm-up; {cs.CARD})",
              flush=True)


def serving(mesh, dev) -> None:
    tparams = convert.from_jax_params(cs.slice_params(), device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    xs = torch.randn((cs.N_TEST, cs.D), generator=gen, device=dev, dtype=torch.float32)
    with torch.no_grad():
        post = cs.build_posterior(tparams)
        mu, var = tgp.parallel.dp_predict_blocks(post, xs, mesh, block_size=cs.BLOCK)
        ref = alone(mesh, lambda: post.predict_blocks(xs, block_size=cs.BLOCK))
        agree = same_on_every_rank(mesh, mu) and same_on_every_rank(mesh, var)
        if mesh.rank == 0:
            e = max(cs.rel_err(mu, ref[0]), cs.rel_err(var, ref[1]))
            check(agree and e <= SERVE_RTOL32,
                  f"(a) dp_predict_blocks over {cs.N_TEST} points: the same bits on every rank "
                  f"{agree}; against the single card: mean {cs.same(mu, ref[0])}, variance "
                  f"{cs.same(var, ref[1])} (<= {SERVE_RTOL32:g})")
        timed_pair(mesh, f"(a) serving sweep of {cs.N_TEST} points",
                   lambda: tgp.parallel.dp_predict_blocks(post, xs, mesh, cs.BLOCK),
                   lambda: post.predict_blocks(xs, block_size=cs.BLOCK), 3)


def minibatch(mesh, dev) -> None:
    import numpy as np

    rng = np.random.default_rng(cs.SEED + 2)
    params = {"k": np.array(cs.RAW_K), "z": rng.standard_normal((cs.M, cs.D)),
              "m": np.zeros(cs.M), "A": np.eye(cs.M)}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    x = torch.randn((cs.N_DATA, cs.D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + cs.NOISE * torch.randn((cs.N_DATA,), generator=gen, device=dev)
    idx = [torch.randint(0, cs.N_DATA, (cs.BATCH,), generator=gen, device=dev)
           for _ in range(STEPS)]
    batches = [(x[i], y[i]) for i in idx]

    def start():
        return {k: t.detach() for k, t in cs.leaf_params(params, dev, torch.float32).items()}

    dp_loss = tgp.parallel.make_dp_elbo(cs.minibatch_loss, mesh)
    v, g = cs.value_and_grad(dp_loss, cs.leaf_params(params, dev, torch.float32), *batches[0])
    ref1 = alone(mesh, lambda: cs.value_and_grad(
        cs.minibatch_loss, cs.leaf_params(params, dev, torch.float32), *batches[0]))
    p = start()
    step = tgp.parallel.make_dp_train_step(
        cs.minibatch_loss, lambda ls: torch.optim.Adam(ls, lr=cs.LR), mesh)
    losses = torch.stack([step(p, xb, yb)[1] for xb, yb in batches])
    ref = alone(mesh, lambda: tgp.adam_fit(cs.minibatch_loss, start(), batches,
                                           learning_rate=cs.LR))
    agree = all(same_on_every_rank(mesh, t.detach()) for t in [*p.values(), *g.values()])
    if mesh.rank == 0:
        (v0, g0), (q, losses0) = ref1, ref
        eg = {k: cs.rel_err(g[k], g0[k]) for k in g}
        el = cs.rel_err(losses, torch.stack(losses0))
        ep = {k: cs.rel_err(p[k], q[k]) for k in p}
        ev = cs.rel_err(v, v0)
        check(agree and max(ev, el) <= VALUE_RTOL32 and max(eg.values()) <= GRAD_RTOL32
              and max(ep.values()) <= PARAM_RTOL32,
              f"(b) make_dp_train_step, {STEPS} Adam steps, {cs.BATCH // mesh.size} points a rank: "
              f"gradients and parameters the same bits on every rank {agree}; against the single "
              f"card: the first batch's loss rel err {ev:.3e} and the {STEPS} losses {el:.3e} "
              f"(<= {VALUE_RTOL32:g}), its gradients "
              + ", ".join(f"d{k} {e:.3e}" for k, e in eg.items())
              + f" (<= {GRAD_RTOL32:g}), the parameters after the steps "
              + ", ".join(f"{k} {e:.3e}" for k, e in ep.items()) + f" (<= {PARAM_RTOL32:g})")
    reps = 5
    q = start()
    timed_pair(mesh, "(b) minibatch step (a step)",
               lambda: [step(p, xb, yb) for xb, yb in batches[:reps]],
               lambda: tgp.adam_fit(cs.minibatch_loss, q, batches[:reps], cs.LR), 3, per=reps)


def streaming(mesh, dev) -> None:
    params = cs.slice_params()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
    x = torch.randn((cs.N_STREAM, cs.D), generator=gen, device=dev)
    y = torch.sin(x[:, 0])
    lik = tgp.GaussianLikelihood(cs.NOISE)

    def loss_dp(p):
        sva, _ = cs.bench_sva(p)
        return -tgp.dp_streaming_elbo(sva, lik, x, y, mesh, block_size=cs.BLOCK)

    def loss_one(p):
        sva, _ = cs.bench_sva(p)
        return -tgp.streaming_elbo(sva, lik, x, y, block_size=cs.BLOCK)

    v, g = cs.value_and_grad(loss_dp, cs.leaf_params(params, dev, torch.float32))
    ref = alone(mesh, lambda: cs.value_and_grad(loss_one,
                                                cs.leaf_params(params, dev, torch.float32)))
    agree = same_on_every_rank(mesh, v) and all(same_on_every_rank(mesh, t) for t in g.values())
    if mesh.rank == 0:
        v0, g0 = ref
        e = {k: cs.rel_err(g[k], g0[k]) for k in g}
        check(agree and cs.rel_err(v, v0) <= VALUE_RTOL32 and max(e.values()) <= GRAD_RTOL32,
              f"(c) dp_streaming_elbo N={cs.N_STREAM}, {cs.N_STREAM // mesh.size} points a rank: "
              f"value and gradients the same bits on every rank {agree}; against streaming_elbo: "
              f"value rel err {cs.rel_err(v, v0):.3e} (<= {VALUE_RTOL32:g}), gradients "
              + ", ".join(f"d{k} {x:.3e}" for k, x in e.items()) + f" (<= {GRAD_RTOL32:g})")
    q = cs.leaf_params(params, dev, torch.float32)
    timed_pair(mesh, f"(c) streaming value and gradient, N={cs.N_STREAM}",
               lambda: cs.value_and_grad(loss_dp, q), lambda: cs.value_and_grad(loss_one, q), 3)


def matrix_free(mesh, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    x = 10.0 * torch.rand((cs.N_GP, cs.D_GP), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((cs.N_GP,), generator=gen, device=dev)
    xs = 10.0 * torch.rand((cs.GP_N_TEST, cs.D_GP), generator=gen, device=dev)
    probes = iterative.rademacher_probes(gen, cs.GP_PROBES, cs.N_GP, torch.float32, dev)
    theta0 = convert.from_jax_params(cs.GP_THETA, device=dev, dtype=torch.float32)
    Lk = iterative.pivoted_cholesky(convert.build_exact_fx(theta0, x).f.kernel, x, cs.GP_RANK)

    def slq(m):
        th = theta0.clone().requires_grad_()
        v = -tgp.logpdf_slq(convert.build_exact_fx(th, x), y, probes=probes, precond_Lk=Lk,
                            mesh=m, **cs.GP_SLQ)
        return v.detach(), torch.autograd.grad(v, th)[0]

    def serve(m):
        with torch.no_grad():
            post = tgp.posterior_cg(convert.build_exact_fx(theta0, x), y, tol=cs.GP_SLQ["cg_tol"],
                                    precond_rank=cs.GP_RANK, block_size=cs.GP_SLQ["block_size"],
                                    mesh=m)
            return post.mean_and_var(xs)

    iterative.reset_stats()
    v, g = slq(mesh)
    iters = torch.tensor(float(iterative.stats["cg_iterations"]), device=dev)
    mu, var = serve(mesh)
    ref = alone(mesh, lambda: (slq(None), serve(None)))
    agree = all(same_on_every_rank(mesh, t) for t in (v, g, mu, var, iters))
    if mesh.rank == 0:
        (v0, g0), (mu0, var0) = ref
        ev, eg = cs.rel_err(v, v0), cs.rel_err(g, g0)
        emu, evar = cs.rel_err(mu, mu0), cs.rel_err(var, var0)
        check(agree and max(ev, eg, emu, evar) <= MF_RTOL32,
              f"(d) logpdf_slq and posterior_cg on bands of {-(-cs.N_GP // mesh.size)} rows, "
              f"N={cs.N_GP}: value, θ-gradient, mean, variance and the CG iteration count "
              f"({int(iters.item())}) the same on every rank {agree}; against the single card: "
              f"value {ev:.3e}, θ-gradient {eg:.3e}, mean {emu:.3e}, variance {evar:.3e} "
              f"(<= {MF_RTOL32:g})")
    timed_pair(mesh, f"(d) logpdf_slq value and θ-gradient, N={cs.N_GP}", lambda: slq(mesh),
               lambda: slq(None), 2)
    timed_pair(mesh, f"(d) posterior_cg serve at {cs.GP_N_TEST} points, N={cs.N_GP}",
               lambda: serve(mesh), lambda: serve(None), 2)


def main() -> int:
    if CPU:
        cs.cuda_ms, cs.CARD = None, "the CPU"
        torch.cuda.synchronize = lambda *a, **k: None
        cs.M, cs.N_TEST, cs.BLOCK, cs.N_DATA, cs.BATCH = 64, 3000, 512, 5000, 256
        cs.N_STREAM, cs.N_GP, cs.GP_RANK = 4096, 1200, 30
        cs.GP_SLQ = dict(cs.GP_SLQ, block_size=256)
        torch.set_num_threads(1)
    if int(os.environ.get("RANK", "0")) != 0:
        sys.stdout = open(os.devnull, "w")
    if CPU:
        dev = torch.device("cpu")
    else:
        cs.phase_device()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    mesh = tgp.parallel.data_mesh(device=dev)
    print(f"world of {mesh.size} ranks, backend {dist.get_backend(mesh.group)}", flush=True)
    if not CPU:
        # rank 0 builds the kernels; the others load its library
        t0 = time.perf_counter()
        if mesh.rank == 0:
            _build.load_library()
        dist.barrier(group=mesh.group)
        _build.load_library()
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    ctx = (tgp.config_context(solve_mode="inv_matmul", matvec_mode="fused") if CPU
           else tgp.config_context())
    try:
        with ctx:
            for part in (serving, minibatch, streaming, matrix_free):
                part(mesh, dev)
    finally:
        dist.destroy_process_group()
    print(f"{len(FAILS)} checks failed", flush=True)
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main())
