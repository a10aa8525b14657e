"""What the PyTorch twins of the examples share: the repository root on the
import path (so a twin runs as ``python3 examples/torch/<name>.py`` from
anywhere) and the device a twin runs on."""

import os
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                                    os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device (the tests ask
    for the CPU); raises where no card is there and none other was asked
    for, rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card unless "
                           "main(device='cpu') asks for the CPU")
    return dev


def working_dtype(dev: torch.device) -> torch.dtype:
    """f32 on the card, f64 on the CPU: the JAX examples' "f32 on the
    accelerator, f64 off it"."""
    return torch.float32 if dev.type == "cuda" else torch.float64


def cpu_generator(seed: int) -> torch.Generator:
    """The data's generator: on the CPU, so the card and the CPU see the
    same data; the tensors are moved to the device after."""
    return torch.Generator().manual_seed(seed)


def split_generators(seed: int, n: int) -> list[torch.Generator]:
    """``n`` independent CPU generators from one seed, one a random stream,
    as the JAX examples split one key (``jax.random.split(key, n)``)."""
    root = torch.Generator().manual_seed(seed)
    return [torch.Generator().manual_seed(int(s))
            for s in torch.randint(0, 2 ** 62, (n,), generator=root)]


def latent_gp_labels(gen: torch.Generator, x: torch.Tensor, var_true: float,
                     ls_true: float) -> torch.Tensor:
    """Bernoulli labels of a latent SE-GP draw through the logistic, drawn
    on the host in f64 (the classification examples' data)."""
    K = var_true * torch.exp(-0.5 * ((x[:, None] - x[None, :]) / ls_true) ** 2)
    L = torch.linalg.cholesky(K + 1e-10 * torch.eye(x.shape[0], dtype=x.dtype))
    f = L @ torch.randn(x.shape[0], generator=gen, dtype=x.dtype)
    return torch.bernoulli(torch.sigmoid(f), generator=gen)
