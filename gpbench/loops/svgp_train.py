"""SVGP training, a closed loop of Adam steps on −ELBO as the program's
``adam_fit`` runs them: on a fresh minibatch of ``batch`` rows gathered on
the card each step (``elbo``, num_data = N), or, with ``batch`` "all", on
every point (``streaming_elbo`` in blocks of ``block_size``).  No host read
of a loss inside the window.

Set-up builds the one training state (the leaves and their Adam state) and
drives it through ``setup_steps`` steps through the window's own call, on
rows that all differ; the window goes on with the same state.  The first
three steps are the ones compared with the reference."""

from __future__ import annotations

import time

import torch

import approximategps_tpu_torch as tgp
from gpbench.counts import flops
from gpbench.harness import data, judge

COMPARED = 3


def build_sva(cfg: dict, p: dict):
    """The NonCentered SVGP of the configuration from its leaves: raw k holds
    the variance, then one lengthscale (or one a coordinate, ARD)."""
    kernel = data.softplus(p["k"][0]) * tgp.with_lengthscale(tgp.SqExponentialKernel(),
                                                             data.softplus(p["k"][1:]))
    f = tgp.GP(kernel)
    q = tgp.MultivariateNormal(p["m"], torch.tril(p["A"]))
    return tgp.SparseVariationalApproximation(f(p["z"], cfg["jitter"]), q), f


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        self.cfg, self.mix = cfg, mix
        self.n = cfg["num_data"]
        self.full = mix["batch"] == "all"
        self.batch = self.n if self.full else int(mix["batch"])
        self.x, self.y = data.regression(cfg, seed, dev)
        self.p0 = data.svgp_params(cfg, self.x, seed)
        self.params = {k: v.clone() for k, v in self.p0.items()}
        self.gen = data.generator(seed, 2, dev)
        self.marks = [("data", time.perf_counter())]
        steps = mix["setup_steps"]
        if self.full:
            self.rows = [None] * steps
        else:
            perm = torch.randperm(self.n, generator=self.gen, device=dev)
            self.rows = list(perm[:steps * self.batch].view(steps, self.batch))
        self.opt = None
        self.losses = []
        for t, rows in enumerate(self.rows):
            _, losses = tgp.adam_fit(self.loss, self.params, [self._batch(rows)],
                                     mix["learning_rate"], optimizer=self._optimizer)
            self.losses += losses
            self.marks.append((f"step {t + 1}", time.perf_counter()))
            if t == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {k: self.opt.state[v]["exp_avg"] / (1.0 - beta1)
                              for k, v in self.params.items()}
            if t == COMPARED - 1:
                self.delta = {k: v.detach() - self.p0[k] for k, v in self.params.items()}
        self.window_losses = []

    def _optimizer(self, leaves):
        # one Adam state for the whole run: adam_fit's own default, made once
        if self.opt is None:
            self.opt = torch.optim.Adam(leaves, lr=self.mix["learning_rate"])
        return self.opt

    def _batch(self, rows):
        return () if rows is None else (self.x[rows], self.y[rows])

    def loss(self, p: dict, *batch):
        sva, f = build_sva(self.cfg, p)
        noise = self.cfg["noise_variance"]
        if self.full:
            return -tgp.streaming_elbo(sva, tgp.GaussianLikelihood(noise), self.x, self.y,
                                       block_size=self.mix["block_size"])
        xb, yb = batch
        return -tgp.elbo(sva, f(xb, noise), yb, num_data=self.n)

    def window(self, deadline: float) -> None:
        def feed():
            while time.perf_counter() < deadline:
                rows = None if self.full else torch.randint(
                    0, self.n, (self.batch,), generator=self.gen, device=self.x.device)
                yield self._batch(rows)

        _, self.window_losses = tgp.adam_fit(self.loss, self.params, feed(),
                                             self.mix["learning_rate"],
                                             optimizer=self._optimizer)

    def finish(self, window_s: float) -> dict:
        steps = len(self.window_losses)
        failed = int((~torch.isfinite(torch.stack(self.window_losses))).sum()) if steps else 0
        M, D = self.cfg["num_inducing"], self.cfg["input_dim"]
        if self.full:
            bs = self.mix["block_size"]
            blocks = -(-self.n // bs)
            shapes = {"svgp_data_epilogue": [(M, bs, D)] * (blocks * steps),
                      "svgp_data_epilogue_bwd": [(M, bs, D)] * (blocks * steps)}
        else:
            shapes = {"gram_chol_inv": [(M, D)] * steps}
        return {"attempted": steps, "failed": failed, "steps": steps,
                "e2e": {"train_points_per_s": steps * self.batch / window_s},
                "flops": steps * flops.svgp_train_step(M, self.batch, D), "launches": shapes}

    def inputs(self) -> dict:
        return {"x": self.x, "y": self.y, "p0": self.p0, "rows": self.rows[:COMPARED]}

    def outputs(self) -> dict:
        return {"losses": [float(v) for v in self.losses[:COMPARED]], "grad1": self.grad1,
                "delta": self.delta}

    def free(self) -> None:
        del self.params, self.opt, self.window_losses, self.gen


def reference(ref, cfg: dict, mix: dict, inputs: dict, arith) -> dict:
    return ref.train_steps(cfg, mix, inputs, COMPARED, arith)


def compare(ref, cfg: dict, mix: dict, inputs: dict, outputs: dict) -> dict:
    return judge.train_numbers(outputs, reference(ref, cfg, mix, inputs, ref.TRUTH))
