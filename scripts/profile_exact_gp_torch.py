#!/usr/bin/env python3
"""Where the time of the PyTorch port's matrix-free exact GP and
matrix-free Laplace lml goes, on one CUDA GPU.

    python3 scripts/profile_exact_gp_torch.py [gp] [laplace] [lengthscale]

``gp`` (the default runs both parts) builds ``chip_smoke.py``'s phase-7
configuration (N = 10^5 points in
[0, 10]², SE kernel from raw θ = softplus⁻¹(1.5, 1.2, 0.1), 16 probes, 30
Lanczos iterations, CG tol 1e-5, a rank-512 pivoted-Cholesky preconditioner,
blocks of 8192), times the rank-512 factor twice, runs one hyperparameter
step to warm up, then profiles one step and one ``posterior_cg`` serve at 32
points with ``torch.profiler``: the device time by kernel name and the
device's busy share of the wall time.  ``laplace`` builds phase 15's
``laplace_cg_lml`` (N = 10^5 Bernoulli labels in 2-D, 1.5·SE(ℓ = 1.2), 16
probes, 30 Lanczos steps, rank 512, blocks of 8192), times the rank-512
factor apart, runs one value-and-gradient call to warm up and profiles the
next: the device time by kernel, the pivoted Cholesky's share (the kernels
launched inside its span), the CG and Newton host syncs, and the idle time by the host operation begun
inside each gap.  ``lengthscale`` (not in the default) measures row 5's
θ-cotangent of s = Σ a∘(K b) (K the Laplace rows' 1.5·SE(ℓ = 1.2) Gram,
the points of phase 15 at N = 2·10⁴ and 10⁵, a and b fixed normals of R = 1
and 16 columns) on three routes, the self-Gram Function with its one-pass
pullback, the band route of a data mesh of one rank (the cross pass and
the general pullback) and the plain Gram blocks, in f32 and in f64, each
f32 entry against the f64 run of its route; beside them the lengthscale's
cancellation C = Σᵢ|x̄ᵢ·xᵢ| / |Σᵢ x̄ᵢ·xᵢ| (x̄ the points' cotangent, f64),
the f32 error of x̄ itself, and the f32 error of the lengthscale's term
Σᵢⱼ aᵢ g′(r²ᵢⱼ) r²ᵢⱼ bⱼ formed directly from exact differences; then the
θ-gradient of ``laplace_lml_cg`` at 2·10⁴ (phase 15's) on the three routes
against the f64 run.  Prints the card's name and power limit first.  Needs
a CUDA device (it exits non-zero without one).
"""

from __future__ import annotations

import bisect
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import approximategps_tpu_torch as tgp  # noqa: E402
import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch import convert  # noqa: E402
from approximategps_tpu_torch.core.kernels import unwrap_stationary  # noqa: E402
from approximategps_tpu_torch.models import iterative  # noqa: E402
from approximategps_tpu_torch.ops import gram_matvec  # noqa: E402
from approximategps_tpu_torch.utils import profiling  # noqa: E402

PARTS = ("gp", "laplace", "lengthscale")
DEFAULT_PARTS = ("gp", "laplace")


def profile(label: str, fn, top: int = 10, gaps: int = 0, sequence: str | None = None) -> None:
    """Device time of ``fn`` by kernel name, from the profiler's device-side
    events (one stream, so they do not overlap), beside its wall time; the
    ``top`` names by time, and with ``gaps`` the device's idle time between
    its first and last event and the ``gaps`` longest idle gaps, each with
    the names of the events around it; with ``sequence`` the time of each
    event whose name holds it, in the order they ran."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
            spans.append((e.time_range.start, e.time_range.end, e.name))
    busy = sum(ms for ms, _ in by_name.values())
    print(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} %)")
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:10.3f} ms  {calls:6d} calls  {name[:90]}")
    if gaps and spans:
        spans.sort()
        holes = [(b[0] - a[1], a[2], b[2]) for a, b in zip(spans, spans[1:])]
        first_to_last = (spans[-1][1] - spans[0][0]) / 1e3
        idle = sum(max(h, 0.0) for h, _, _ in holes) / 1e3
        print(f"  first to last device event {first_to_last:.3f} ms, idle between events "
              f"{idle:.3f} ms over {len(holes)} gaps")
        for h, before, after in sorted(holes, reverse=True)[:gaps]:
            print(f"    gap {h / 1e3:8.3f} ms  after {before[:45]}  before {after[:45]}")
    if sequence:
        each = [(b - a) / 1e3 for a, b, name in sorted(spans) if sequence in name]
        print(f"  {sequence} in order (ms): " + " ".join(f"{t:.3f}" for t in each))


def main(parts) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if "gp" in parts:
        exact_gp(dev)
    if "laplace" in parts:
        laplace(dev)
    if "lengthscale" in parts:
        lengthscale(dev)


def exact_gp(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    x = 10.0 * torch.rand((cs.N_GP, cs.D_GP), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((cs.N_GP,), generator=gen, device=dev)
    xs = 10.0 * torch.rand((cs.GP_N_TEST, cs.D_GP), generator=gen, device=dev)
    probes = iterative.rademacher_probes(gen, cs.GP_PROBES, cs.N_GP, torch.float32, dev)
    theta0 = convert.from_jax_params(cs.GP_THETA, device=dev, dtype=torch.float32)
    fx = convert.build_exact_fx(theta0, x)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterative.pivoted_cholesky(fx.f.kernel, x, cs.GP_RANK)
        torch.cuda.synchronize()
        print(f"pivoted_cholesky rank {cs.GP_RANK}, N = {cs.N_GP}, call {i + 1}: "
              f"{1e3 * (time.perf_counter() - t0):.3f} ms")

    step, init = tgp.make_slq_hyperopt_step(
        lambda th: convert.build_exact_fx(th, x), y, None, learning_rate=cs.GP_LR,
        precond_rank=cs.GP_RANK, refresh_every=cs.GP_REFRESH, probes=probes, **cs.GP_SLQ)
    carry = [init(theta0.clone())]
    carry[0], _ = step(carry[0])

    def one_step():
        carry[0], _ = step(carry[0])

    iterative.reset_stats()
    profile("one hyperparameter step (kernels)", one_step)
    print(f"  CG: {iterative.stats}")

    def serve():
        with torch.no_grad():
            post = tgp.posterior_cg(convert.build_exact_fx(carry[0][0].detach(), x), y,
                                    tol=cs.GP_SLQ["cg_tol"], precond_rank=cs.GP_RANK,
                                    block_size=cs.GP_SLQ["block_size"])
            post.mean_and_var(xs)

    iterative.reset_stats()
    profile(f"one posterior_cg serve at {cs.GP_N_TEST} points (kernels)", serve)
    print(f"  CG: {iterative.stats}")


def device_events(prof) -> list:
    """The profile's device events, less the device-side copies of
    ``record_function`` ranges (they span the kernels inside them)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def idle_by_host_op(prof, gaps: int = 10) -> None:
    """The device's idle time between its events, summed by the host
    operation begun inside each gap (what the host was doing while the card
    waited), and the ``gaps`` longest gaps with theirs (calls, host ms)."""
    dev_ev = sorted(device_events(prof), key=lambda e: e.time_range.start)
    host_ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_ev]
    holes = [(b.time_range.start - a.time_range.end, a.time_range.end, b.time_range.start)
             for a, b in zip(dev_ev, dev_ev[1:])]
    total: dict[str, list] = {}
    rows = []
    for h, lo, hi in holes:
        if h <= 0:
            continue
        inside: dict[str, list] = {}
        for e in host_ev[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]:
            r = inside.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += e.time_range.elapsed_us() / 1e3
        for name in inside:
            t = total.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += h / 1e3
        rows.append((h, inside))
    idle = sum(h for h, _ in rows) / 1e3
    print(f"  idle between device events {idle:.3f} ms over {len(rows)} gaps; idle ms by the host "
          "operation begun inside the gap (gaps, idle ms; a gap counts for each of its ops):")
    for name, (n, ms) in sorted(total.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"    {ms:10.3f} ms  {n:6d} gaps  {name[:70]}")
    print("  the longest gaps, with the host operations begun inside each (calls, host ms):")
    for h, inside in sorted(rows, key=lambda r: -r[0])[:gaps]:
        top = sorted(inside.items(), key=lambda kv: -kv[1][1])[:4]
        print(f"    gap {h / 1e3:8.3f} ms: " + "; ".join(
            f"{name[:40]} ({n}, {ms:.3f})" for name, (n, ms) in top))


def laplace(dev) -> None:
    """One ``laplace_cg_lml`` value-and-gradient call of phase 15 (c)."""
    x, y = convert.laplace_data(cs.N_LAP, cs.D_LAP, seed=cs.SEED + 51, device=dev)
    theta = torch.tensor(convert.LAPLACE_CG_THETA, dtype=torch.float32, device=dev)
    probes = iterative.rademacher_probes(torch.Generator(device=dev).manual_seed(cs.SEED + 52),
                                         cs.LAP_PROBES, cs.N_LAP, torch.float32, dev)
    kw = dict(precond_rank=cs.LAP_RANK, block_size=cs.LAP_BLOCK)
    kern = convert.laplace_kernel(theta)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterative.pivoted_cholesky(kern, x, cs.LAP_RANK)
        torch.cuda.synchronize()
        print(f"pivoted_cholesky rank {cs.LAP_RANK}, N = {cs.N_LAP}, call {i + 1}: "
              f"{1e3 * (time.perf_counter() - t0):.3f} ms")
    cs.lap_lml(theta, x, y, probes, True, **kw)
    iterative.reset_stats()
    profiling.reset_spans()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cs.lap_lml(theta, x, y, probes, True, **kw)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev_ev = device_events(prof)
    # the factor's "pivoted_cholesky" span (iterative.pivoted_cholesky): its
    # calls on the host, and on the device the operations whose runtime
    # call (the same correlation id) began inside a span, from first to last
    host_ns = [(s, e) for name, _, s, e in profiling.spans() if name == "pivoted_cholesky"]
    cuda = torch.autograd.DeviceType.CUDA
    kineto = list(prof.profiler.kineto_results.events())
    launched = {ev.correlation_id() for ev in kineto if ev.device_type() != cuda
                and ev.name().startswith("cuda")
                and any(s <= ev.start_ns() < e for s, e in host_ns)}
    in_factor_ev = [ev for ev in kineto if ev.device_type() == cuda
                    and not ev.is_user_annotation() and ev.correlation_id() in launched]
    in_factor = sum(ev.duration_ns() for ev in in_factor_ev) / 1e6
    host = [(s / 1e3, e / 1e3) for s, e in host_ns]
    ranges = ([(min(ev.start_ns() for ev in in_factor_ev) / 1e3,
                max(ev.end_ns() for ev in in_factor_ev) / 1e3)] if in_factor_ev else [])
    by_name: dict[str, list] = {}
    for e in dev_ev:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    print(f"one laplace_cg_lml value and θ-gradient, N = {cs.N_LAP}: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} %)")
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"  {ms:10.3f} ms  {calls:6d} calls  {name[:90]}")
    print(f"  pivoted Cholesky (rank {cs.LAP_RANK}): {len(host)} calls, host "
          + ", ".join(f"{(hi - lo) / 1e3:.3f}" for lo, hi in host) + " ms, device "
          + ", ".join(f"{(hi - lo) / 1e3:.3f}" for lo, hi in ranges) + " ms from first to last, "
          f"device busy {in_factor:.3f} ms in its operations")
    st = iterative.stats
    print(f"  CG: {st['cg_solves']} solves, {st['cg_iterations']} iterations, "
          f"{st['cg_host_syncs']} host syncs (one an iteration; Newton adds one a step); matvecs "
          f"{st['matvec_fused']} on row 5, {st['matvec_plain']} plain")
    idle_by_host_op(prof)


LS_SIZES, LS_WIDTHS, LS_BLOCK = (20_000, 100_000), (1, 16), 4096
ROUTES = ("self", "band", "plain")


def ls_cotangent(route: str, x, a, b, mesh) -> torch.Tensor:
    """∂/∂θ of Σ a∘(K b) on ``route``, θ the raw (variance, lengthscale)."""
    th = torch.tensor(convert.LAPLACE_CG_THETA, dtype=x.dtype, device=x.device,
                      requires_grad=True)
    with tgp.config_context(matvec_mode="plain" if route == "plain" else "fused"):
        mv = iterative.kernel_matvec(convert.laplace_kernel(th), x, 0.0, block_size=LS_BLOCK,
                                     mesh=mesh if route == "band" else None)
        return torch.autograd.grad(torch.sum(a * mv(b)), th)[0].detach()


def ls_points(x, a, b, general: bool = False):
    """(x̄, the scaled points' cotangent: of the self-Gram Function, or with
    ``general`` x̄q + z̄k of the general one; the scale; the map)."""
    kmap, scale, _ = unwrap_stationary(convert.laplace_kernel(
        torch.tensor(convert.LAPLACE_CG_THETA, dtype=x.dtype, device=x.device)))
    sc = scale.detach().to(x.dtype)
    xs = (x * sc).requires_grad_()
    if general:
        xk = (x * sc).requires_grad_()
        out = gram_matvec.gram_matvec(xs, xk, b, kmap)
        gq, gk = torch.autograd.grad(torch.sum(a * out), (xs, xk))
        return gq + gk, sc, kmap
    out = gram_matvec.gram_matvec_self(xs, b, kmap)
    return torch.autograd.grad(torch.sum(a * out), xs)[0], sc, kmap


def ls_direct(x, a, b, sc, kmap, rows: int = 1024) -> float:
    """Σᵢⱼ aᵢ·g′(r²ᵢⱼ) r²ᵢⱼ·bⱼ (summed over the columns) from exact
    differences of the scaled points, in x's type."""
    xs = x * sc
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for i0 in range(0, x.shape[0], rows):
        d = xs[i0:i0 + rows, None, :] - xs[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        total = total + torch.sum(a[i0:i0 + rows] * ((kmap.dk_of_r2(r2) * r2) @ b))
    return total.item()


def lengthscale(dev) -> None:
    """Row 5's lengthscale cotangent in f32 on each route (see the module
    note)."""
    f32, f64 = torch.float32, torch.float64
    with cs.world_of_one(dev) as mesh:
        for N in LS_SIZES:
            x, _ = convert.laplace_data(N, cs.D_LAP, seed=cs.SEED + 51, device=dev, dtype=f64)
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 60)
            for R in LS_WIDTHS:
                a, b = torch.randn((2, N, R), generator=gen, device=dev, dtype=f64)
                got = {(r, dt): ls_cotangent(r, x.to(dt), a.to(dt), b.to(dt), mesh)
                       for dt in (f64, f32) for r in ROUTES}
                ref = got["self", f64]
                f64_spread = max(cs.rel_err(got[r, f64], ref) for r in ROUTES)
                print(f"N = {N}, R = {R}: θ-cotangent (f64, self route) {ref.tolist()}; the f64 "
                      f"routes agree to {f64_spread:.3e}")
                for r in ROUTES:
                    e = (got[r, f32].double() - got[r, f64]).abs() / got[r, f64].abs()
                    print(f"  {r:5s} route f32 against its f64 run: variance entry {e[0]:.3e}, "
                          f"lengthscale entry {e[1]:.3e}")
                xb64, sc, kmap = ls_points(x, a, b)
                xb32, _, _ = ls_points(x.float(), a.float(), b.float())
                xsum = torch.sum(xb64 * x, dim=1)
                cancel = (xsum.abs().sum() / xsum.sum().abs()).item()
                xc = x - x.mean(dim=0)
                xsum_c = torch.sum(xb64 * xc, dim=1)
                cancel_c = (xsum_c.abs().sum() / xsum_c.sum().abs()).item()
                ex = cs.rel_err(xb32, xb64)
                # the lengthscale's term as the points' cotangents give it (before the
                # repair: Σᵢ x̄ᵢ·xᵢ, summed in f32), on the self and the general pullback
                old = {}
                for general in (False, True):
                    xg32 = xb32 if not general else ls_points(x.float(), a.float(), b.float(),
                                                              True)[0]
                    xg64 = xb64 if not general else ls_points(x, a, b, True)[0]
                    s32 = torch.sum(xg32 * x.float()).item()
                    s64 = torch.sum(xg64 * x).item()
                    old["general" if general else "self"] = abs(s32 - s64) / abs(s64)
                t64 = ls_direct(x, a, b, sc, kmap)
                t32 = ls_direct(x.float(), a.float(), b.float(), sc.float(), kmap)
                print(f"  the lengthscale's cancellation C = Σ|x̄ᵢ·xᵢ| / |Σ x̄ᵢ·xᵢ| = {cancel:.4g} "
                      f"(about the centroid {cancel_c:.4g}); x̄ f32 (self pullback) against f64 "
                      f"{ex:.3e} of its largest entry; eps·C = {6e-8 * cancel:.3e}; f32 against "
                      f"f64 of Σ x̄ᵢ·xᵢ (the term before the repair): self pullback "
                      f"{old['self']:.3e}, general pullback {old['general']:.3e}; of the direct "
                      f"term Σ a g′ r² b {abs(t32 - t64) / abs(t64):.3e}")
        # the lml's θ-gradient at phase 15's 2·10^4 on the three routes
        N = cs.N_LAP_MID
        x, y = convert.laplace_data(cs.N_LAP, cs.D_LAP, seed=cs.SEED + 51, device=dev)
        x, y = x[:N], y[:N]
        probes = iterative.rademacher_probes(torch.Generator(device=dev).manual_seed(cs.SEED + 52),
                                             cs.LAP_PROBES, cs.N_LAP, f32, dev)[:, :N]
        theta = torch.tensor(convert.LAPLACE_CG_THETA, dtype=f32, device=dev)
        kw = dict(precond_rank=cs.LAP_RANK_MID, storage="chunked", block_size=cs.LAP_BLOCK)
        res = {}
        for r in ROUTES:
            for dt in (f64, f32):
                mode = "plain" if r == "plain" else "fused"
                with tgp.config_context(matvec_mode=mode):
                    res[r, dt] = cs.lap_lml(theta.to(dt), x.to(dt), y, probes.to(dt), True,
                                            mesh=mesh if r == "band" else None, **kw)[1]
        ref = res["self", f64]
        print(f"laplace_cg_lml N = {N} θ-gradient (f64, self route) {ref.tolist()}; the f64 routes "
              f"agree to {max(cs.rel_err(res[r, f64], ref) for r in ROUTES):.3e}")
        for r in ROUTES:
            e = (res[r, f32].double() - ref).abs() / ref.abs()
            print(f"  {r:5s} route f32 against f64: variance entry {e[0]:.3e}, lengthscale entry "
                  f"{e[1]:.3e} (rel err of the vector {cs.rel_err(res[r, f32], ref):.3e})")


if __name__ == "__main__":
    asked = [a for a in sys.argv[1:] if a in PARTS]
    if len(asked) != len(sys.argv[1:]):
        sys.exit(f"usage: {sys.argv[0]} [{'] ['.join(PARTS)}]")
    main(asked or DEFAULT_PARTS)
