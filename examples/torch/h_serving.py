#!/usr/bin/env python
"""Serving a trained SVGP at scale on the PyTorch port (the twin of
``examples/h_serving.py``): a small SVGP trained by minibatch Adam, then
``predict_blocks`` over a large test set (on the card, each block through
the fused epilogue kernel where the S-correction cache exists), then
``dp_predict_blocks``, the same sweep split over the ranks of a data mesh
and checked against the single-device answer.

The JAX example spreads the sweep over a mesh of virtual CPU devices; here
the mesh is a ``torch.distributed`` world: under ``torchrun`` the one it
starts, otherwise a world of this one process (NCCL on the card, gloo on
the CPU), which the example starts and destroys.  A process group that
was running before is used and left running.  f32 on the card, f64 on the
CPU.  Runs on the card unless ``main(device="cpu")`` asks for the CPU."""

import contextlib
import os
import socket
import time
from datetime import timedelta

import _common
import numpy as np
import torch
import torch.distributed as dist

import approximategps_tpu_torch as tgp
from approximategps_tpu_torch.parallel import data_mesh, dp_predict_blocks
from approximategps_tpu_torch.utils.training import build_svgp, init_svgp_params


@contextlib.contextmanager
def mesh_for(dev):
    """The data mesh of the running process group, or of a world of one
    started here (and destroyed on the way out)."""
    started = not dist.is_initialized() and "WORLD_SIZE" not in os.environ
    if started:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                                timeout=timedelta(seconds=300))
    try:
        yield data_mesh(device=dev)
    finally:
        if started:
            dist.destroy_process_group()


def truth(x):
    return torch.sin(x) + 0.3 * torch.cos(4 * x)


def main(N=50_000, M=256, Ntest=200_000, seed=0, batch=4096, device=None):
    dev = _common.resolve_device(device)
    like = dict(dtype=_common.working_dtype(dev), device=dev)
    print(f"device: {dev}")
    gen = _common.cpu_generator(seed)

    # train a small SVGP (Adam on the minibatch ELBO)
    x64 = torch.sort(20.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values
    y64 = truth(x64) + 0.1 * torch.randn(N, generator=gen, dtype=torch.float64)
    x, y = x64.to(**like), y64.to(**like)
    params = init_svgp_params(torch.linspace(0.0, 20.0, M, **like), variance=1.0,
                              lengthscale=0.5)

    def loss(p, xb, yb):
        sva, f = build_svgp(p, jitter=1e-3)  # f32: densely spaced z (the Poisson bench's recipe)
        return -tgp.elbo(sva, f(xb, 0.1), yb, num_data=N)

    B = min(batch, N)
    steps = N // B

    def batches():
        for _ in range(30):
            perm = torch.randperm(N, generator=gen)[:steps * B].to(dev)
            for idx in perm.reshape(steps, B):
                yield x[idx], y[idx]

    t0 = time.time()
    params, losses = tgp.adam_fit(loss, params, batches(), learning_rate=3e-2)
    print(f"[train]   30 epochs in {time.time() - t0:.1f}s, "
          f"final -elbo/N = {float(losses[-1]) / N:.4f}")

    with torch.no_grad():
        sva, f = build_svgp(params, jitter=1e-3)
        post = tgp.posterior(sva)

        # 1. single-device blocked sweep
        xs = torch.linspace(-1.0, 21.0, Ntest, **like)
        t0 = time.time()
        mu, var = post.predict_blocks(xs, block_size=16384)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.time() - t0
        inner = slice(1000, -1000)
        rmse = float(torch.sqrt(torch.mean((mu[inner] - truth(xs[inner])) ** 2)))
        print(f"[serve-1] predict_blocks: {Ntest} points in {t1:.2f}s (interior rmse {rmse:.3f})")
        assert rmse < 0.2, rmse

        # 2. the sweep split over the ranks of a data mesh
        with mesh_for(dev) as mesh:
            t0 = time.time()
            mu_dp, var_dp = dp_predict_blocks(post, xs, mesh, block_size=16384)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.time() - t0
            print(f"[serve-N] dp_predict_blocks over {mesh.size} rank(s): {Ntest} points in "
                  f"{t2:.2f}s")
    atol = 1e-5 if mu.dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(mu_dp.cpu().numpy(), mu.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(var_dp.cpu().numpy(), var.cpu().numpy(), atol=atol)
    print("[serve-N] sharded sweep matches the single-device sweep")


if __name__ == "__main__":
    main()
