"""Dense linear-algebra helpers (port of the parts of
``approximategps_tpu/core/linalg.py`` the SVGP serving path reads)."""

from __future__ import annotations

import torch

from ..config import config, kernels_take

__all__ = [
    "symmetrize",
    "safe_cholesky",
    "diag_quad_sym",
    "chol_with_inv",
    "chol_with_inv_plain",
]


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.transpose(-1, -2))


def safe_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized A (add jitter before)."""
    return torch.linalg.cholesky(symmetrize(A))


def diag_quad_sym(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """diag(Kᵀ S K) for symmetric S: one (M, M)·(M, B) product and a
    column reduce."""
    if S.dtype != K.dtype:
        raise ValueError(
            f"diag_quad_sym requires S.dtype == K.dtype, got {S.dtype} vs {K.dtype}"
        )
    return torch.sum(K * (S @ K), dim=0)


def chol_with_inv_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) = (chol(sym(A)), tril_inv(L)) through torch.linalg, with
    exact zeros above both diagonals."""
    L = safe_cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    J = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, torch.tril(J)


def chol_with_inv(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of an SPD matrix (add jitter before calling).

    Where the JAX package would take its Pallas ``pallas_chol_inv`` kernel
    (kernels allowed, ``chol_mode="auto"``, the kernel device), the port
    has no Hopper kernel yet and raises rather than quietly using cuSOLVER.
    On the CPU, or under ``chol_mode="plain"``, it is the plain route."""
    if A.is_cuda and config.chol_mode != "plain" and kernels_take(A):
        raise NotImplementedError(
            "chol_with_inv on CUDA needs the Hopper port of "
            "ops/panel_chol.py::pallas_chol_inv (ROADMAP.md §2, row 4); "
            "use a stationary kernel with the NonCentered parametrization, "
            "or set chol_mode='plain'"
        )
    return chol_with_inv_plain(A)
