"""Plain reference of the whitened (NonCentered) SVGP with a σ²·SE kernel
(ARD: a lengthscale a coordinate) and a Gaussian likelihood, after
Hensman, Fusi & Lawrence (UAI 2013) and Hensman, Matthews & Ghahramani
(AISTATS 2015):

    Kuu = σ²·exp(−½Σ_d (z_id − z_jd)²/ℓ_d²) + jitter·I = Lk Lkᵀ,
    A = Lk⁻¹ Kuf,
    q(f_i) = N(aᵢᵀm, σ² − |aᵢ|² + |Lᵀaᵢ|²),  L = tril(A_q),
    ELBO = (N/B)·Σᵢ E_q[log N(yᵢ | fᵢ, s²)] − ½(|L|²_F + mᵀm − M − log det LLᵀ),

σ² = softplus(k₀), ℓ = softplus(k₁…) (one value, or one a coordinate).
Squared distances are taken as differences, never by the |x|² identity.  It imports nothing of the program
under test: it takes the inputs the harness made (data, starting leaves,
minibatch rows) and works out the cache, the ELBO, its gradients by
autograd and Adam's steps again.  ``Arith`` sets its precision: float64 for
the truth; float32 with every product's operands rounded to TF32's 10-bit
mantissa for the control, the step below the configuration's float32."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Arith:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


TRUTH = Arith()
CONTROL = Arith(torch.float32, True)
LOG2PI = math.log(2.0 * math.pi)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values with the low 13 mantissa bits cleared: what a TF32 tensor
    core reads of an f32 operand."""
    return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    """a @ b with the operands of the product and of both products of its
    pullback rounded to TF32, accumulated in f32, as cuBLAS's TF32 route."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32(a), tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32(g)
        return rg @ rb.T, ra.T @ rg


def mm(a: torch.Tensor, b: torch.Tensor, ar: Arith) -> torch.Tensor:
    return _MatmulTF32.apply(a, b) if ar.tf32 else a @ b


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def se(a: torch.Tensor, b: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """σ²·exp(−½Σ_d (a_id − b_jd)²/ℓ_d²), distances by differences;
    ``lengthscale`` one value or one a coordinate."""
    ls = lengthscale.expand(a.shape[1])
    r2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for d in range(a.shape[1]):
        r2 = r2 + ((a[:, d, None] - b[None, :, d]) / ls[d]) ** 2
    return variance * torch.exp(-0.5 * r2)


def _cache(cfg: dict, p: dict, ar: Arith):
    variance, lengthscale = softplus(p["k"][0]), softplus(p["k"][1:])
    z = p["z"]
    M = z.shape[0]
    eye = torch.eye(M, dtype=ar.dtype, device=z.device)
    Lk = torch.linalg.cholesky(se(z, z, variance, lengthscale) + cfg["jitter"] * eye)
    J = torch.linalg.solve_triangular(Lk, eye, upper=False)
    return variance, lengthscale, J, torch.tril(p["A"])


def _moments(x, p, variance, lengthscale, J, L, ar: Arith):
    Am = mm(J, se(p["z"], x, variance, lengthscale), ar)
    mu = mm(Am.T, p["m"][:, None], ar)[:, 0]
    fvar = variance - torch.sum(Am * Am, dim=0) + torch.sum(mm(L.T, Am, ar) ** 2, dim=0)
    return mu, fvar


def loss_and_grad(cfg: dict, p0: dict, x, y, num_data: int, block: int, ar: Arith):
    """(−ELBO, leaf → gradient) over the points (x, y), summed in blocks of
    ``block`` (each block's graph is freed after its backward)."""
    p = {k: v.detach().to(ar.dtype).requires_grad_() for k, v in p0.items()}
    variance, lengthscale, J, L = _cache(cfg, p, ar)
    s2 = cfg["noise_variance"]
    n = x.shape[0]
    total = 0.0
    for i in range(0, n, block):
        xb, yb = x[i:i + block].to(ar.dtype), y[i:i + block].to(ar.dtype)
        mu, fvar = _moments(xb, p, variance, lengthscale, J, L, ar)
        ell = -0.5 * (LOG2PI + math.log(s2) + ((yb - mu) ** 2 + fvar) / s2)
        part = -torch.sum(ell) * (num_data / n)
        part.backward(retain_graph=True)
        total += float(part.detach())
    M = p["m"].shape[0]
    kl = 0.5 * (torch.sum(L * L) + p["m"] @ p["m"] - M
                - 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L)))))
    kl.backward()
    return total + float(kl.detach()), {k: v.grad.detach() for k, v in p.items()}


def adam(p: dict, g: dict, state: dict, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """One Adam step in place (Kingma & Ba 2015, bias-corrected)."""
    for k in p:
        m, v = state.setdefault(k, (torch.zeros_like(p[k]), torch.zeros_like(p[k])))
        m = b1 * m + (1 - b1) * g[k]
        v = b2 * v + (1 - b2) * g[k] * g[k]
        state[k] = (m, v)
        p[k] = p[k] - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def train_steps(cfg: dict, mix: dict, inputs: dict, steps: int, ar: Arith) -> dict:
    """The first ``steps`` Adam steps on −ELBO from ``inputs["p0"]``: on the
    rows ``inputs["rows"][t]`` of (x, y) (minibatch, ELBO scaled by
    N / B), or on all points in blocks of the mix's ``block_size``."""
    x, y = inputs["x"], inputs["y"]
    n = cfg["num_data"]
    p = {k: v.detach().to(ar.dtype) for k, v in inputs["p0"].items()}
    state: dict = {}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        rows = inputs["rows"][t - 1]
        if rows is None:
            loss, g = loss_and_grad(cfg, p, x, y, n, mix["block_size"], ar)
        else:
            loss, g = loss_and_grad(cfg, p, x[rows], y[rows], n, rows.shape[0], ar)
        losses.append(loss)
        grad1 = g if grad1 is None else grad1
        adam(p, g, state, t, mix["learning_rate"])
    return {"losses": losses, "grad1": grad1,
            "delta": {k: p[k] - inputs["p0"][k].to(ar.dtype) for k in p}}


@torch.no_grad()
def predict(cfg: dict, p0: dict, xs: torch.Tensor, ar: Arith, block: int = 65536):
    """(mean, variance) of q(f) at the points ``xs``."""
    p = {k: v.to(ar.dtype) for k, v in p0.items()}
    variance, lengthscale, J, L = _cache(cfg, p, ar)
    mus, fvars = [], []
    for i in range(0, xs.shape[0], block):
        mu, fvar = _moments(xs[i:i + block].to(ar.dtype), p, variance, lengthscale, J, L, ar)
        mus.append(mu)
        fvars.append(fvar)
    return torch.cat(mus), torch.cat(fvars), float(variance)
