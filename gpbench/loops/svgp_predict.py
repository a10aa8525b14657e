"""SVGP prediction requests from one closed-loop client: each request is a
test set of n points, served by the program's ``posterior`` (built once at
set-up) through ``SVGPPosterior.predict_blocks``; the next is sent once the
last one's means and variances are ready on the card.

Request sizes are log-uniform on [min_points, max_points]: each cycle of
``cycle`` requests holds the same stratified sizes
2^(a + (b − a)(k + ½)/cycle), in an order drawn from the seed, so every seed
sends the same work in another order.  A request's points are rows of a
pool of standardized test points made at set-up, at an offset drawn from
the seed.  A request's latency runs from the call to its results ready,
read by CUDA events on an idle card (the client waits for each reply).

For the comparison, the results of every ``sample_every``-th request (the
phase drawn from the seed) and of each cycle's largest are copied, once
ready, into buffers made at set-up, up to ``sample_points`` points."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import approximategps_tpu_torch as tgp
from gpbench.counts import flops
from gpbench.harness import data, judge
from gpbench.loops.svgp_train import build_sva


def sizes(mix: dict) -> list[int]:
    lo, hi, k = math.log2(mix["min_points"]), math.log2(mix["max_points"]), mix["cycle"]
    return [int(round(2.0 ** (lo + (hi - lo) * (i + 0.5) / k))) for i in range(k)]


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        self.cfg, self.mix, self.dev = cfg, mix, dev
        x, _ = data.regression(cfg, seed, dev)
        self.p0 = data.svgp_params(cfg, x, seed)
        del x
        g = data.generator(seed, 4, dev)
        self.pool = torch.randn((mix["pool_points"], cfg["input_dim"]), generator=g, device=dev,
                                dtype=data.DTYPES[cfg["dtype"]])
        self.rng = data.host_rng(seed, 5)
        self.marks = [("data", time.perf_counter())]
        self.phase = int(self.rng.integers(mix["sample_every"]))
        self.sizes = sizes(mix)
        cap = mix["sample_points"]
        self.mu_buf = torch.empty((cap,), dtype=self.pool.dtype, device=dev)
        self.var_buf = torch.empty_like(self.mu_buf)
        with torch.no_grad():
            sva, _ = build_sva(cfg, self.p0)
            self.post = tgp.posterior(sva)
        self.marks.append(("posterior", time.perf_counter()))
        self.plan: list = []
        # warm-up: the largest request first (its buffers serve every later
        # one), then the smallest and a ragged one
        bs = mix["block_size"]
        for n in (mix["max_points"], mix["min_points"], 3 * bs + bs // 3):
            self.post.predict_blocks(self.pool[:n], block_size=bs)
        self.marks.append(("warm-up", time.perf_counter()))
        self.served, self.kept, self.fill = [], [], 0

    def _extend_plan(self) -> None:
        order = self.rng.permutation(len(self.sizes))
        top = max(self.sizes)
        for k in order:
            n = self.sizes[k]
            off = int(self.rng.integers(self.mix["pool_points"] - n + 1))
            sampled = (len(self.plan) % self.mix["sample_every"] == self.phase) or n == top
            self.plan.append((n, off, sampled))

    def window(self, deadline: float) -> None:
        bs = self.mix["block_size"]
        cuda = self.dev.type == "cuda"
        stream = torch.cuda.current_stream(self.dev) if cuda else None
        i = 0
        while time.perf_counter() < deadline:
            if i == len(self.plan):
                self._extend_plan()
            n, off, sampled = self.plan[i]
            xs = self.pool[off:off + n]
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(stream)
            else:
                t = time.perf_counter()
            mu, var = self.post.predict_blocks(xs, block_size=bs)
            if cuda:
                end.record(stream)
            else:
                t = 1e3 * (time.perf_counter() - t)
            if sampled and self.fill + n <= self.mu_buf.shape[0]:
                self.mu_buf[self.fill:self.fill + n].copy_(mu)
                self.var_buf[self.fill:self.fill + n].copy_(var)
                self.kept.append((off, n))
                self.fill += n
            ok = torch.isfinite(mu).all() & torch.isfinite(var).all()
            if cuda:
                stream.synchronize()
            self.served.append((n, (start, end) if cuda else t, ok))
            i += 1

    def finish(self, window_s: float) -> dict:
        lat = [tm[0].elapsed_time(tm[1]) if isinstance(tm, tuple) else tm
               for _, tm, _ in self.served]
        points = sum(n for n, _, _ in self.served)
        failed = sum(1 for _, _, ok in self.served if not bool(ok))
        M, D, bs = self.cfg["num_inducing"], self.cfg["input_dim"], self.mix["block_size"]
        shapes = []
        for n, _, _ in self.served:
            shapes += [(M, bs, D)] * (n // bs) + ([(M, n % bs, D)] if n % bs else [])
        return {"attempted": len(self.served), "failed": failed, "requests": len(self.served),
                "e2e": {"predict_points_per_s": points / window_s,
                        "predict_p95_ms": float(np.percentile(lat, 95)) if lat else float("nan")},
                "flops": sum(flops.svgp_predict(M, n, D) for n, _, _ in self.served),
                "launches": {"svgp_data_epilogue": shapes}}

    def inputs(self) -> dict:
        xs = torch.cat([self.pool[off:off + n] for off, n in self.kept]) if self.kept else \
            self.pool[:0]
        return {"p0": self.p0, "xs": xs}

    def outputs(self) -> dict:
        return {"mu": self.mu_buf[:self.fill], "var": self.var_buf[:self.fill]}

    def free(self) -> None:
        del self.post, self.served, self.pool


def reference(ref, cfg: dict, mix: dict, inputs: dict, arith) -> dict:
    mu, var, prior_var = ref.predict(cfg, inputs["p0"], inputs["xs"], arith)
    return {"mu": mu, "var": var, "prior_var": prior_var}


def compare(ref, cfg: dict, mix: dict, inputs: dict, outputs: dict) -> dict:
    r = reference(ref, cfg, mix, inputs, ref.TRUTH)
    if outputs["mu"].shape[0] == 0:
        return {}
    return judge.answer_numbers(outputs["mu"], outputs["var"], r["mu"], r["var"],
                                r["prior_var"])
