"""Inputs made from ``--seed`` on the device, in a few large calls: the
regression data, the SVGP's starting parameters and minibatch rows.  The
same seed gives the same inputs; both the program and the reference are
handed them."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's seed."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, stream))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def target(x: torch.Tensor) -> torch.Tensor:
    """The smooth regression function of the configurations' ``data``:
    sin(x₀) + ½·cos(x₁ + x₂) over standardized inputs (D ≥ 3)."""
    return torch.sin(x[:, 0]) + 0.5 * torch.cos(x[:, 1] + x[:, 2])


def regression(cfg: dict, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y): one fixed data set of N standardized points N(0, I_D) and
    y = target(x) + noise, as a real data set is fixed, with its rows in an
    order drawn from the seed: every seed trains on the same points."""
    fixed = generator(0, 0, dev)
    dtype = DTYPES[cfg["dtype"]]
    n, d = cfg["num_data"], cfg["input_dim"]
    x = torch.randn((n, d), generator=fixed, device=dev, dtype=dtype)
    y = target(x) + cfg["data"]["noise_std"] * torch.randn((n,), generator=fixed, device=dev,
                                                          dtype=dtype)
    order = row_order(seed, n, dev)
    return x[order], y[order]


def row_order(seed: int, n: int, dev) -> torch.Tensor:
    return torch.randperm(n, generator=generator(seed, 0, dev), device=dev)


def svgp_params(cfg: dict, x: torch.Tensor, seed: int) -> dict:
    """The SVGP's leaves: raw kernel parameters k, inducing points z (a
    seeded subset of x) and a non-trivial q (m = a·N(0, 1),
    A = b·I + c·tril(N(0, 1))): at m = 0, A = I the loss ignores z."""
    g = generator(seed, 1, x.device)
    n = x.shape[0]
    M = cfg["num_inducing"]
    q = cfg["q_init"]
    idx = torch.randperm(n, generator=g, device=x.device)[:M]
    eye = torch.eye(M, dtype=x.dtype, device=x.device)
    return {
        "k": torch.tensor(cfg["raw_kernel"], dtype=x.dtype, device=x.device),
        "z": x[idx].clone(),
        "m": q["mean_scale"] * torch.randn((M,), generator=g, device=x.device, dtype=x.dtype),
        "A": q["diag"] * eye + q["tril_scale"] * torch.tril(
            torch.randn((M, M), generator=g, device=x.device, dtype=x.dtype)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ), as the program's bijector computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))
