"""Dense linear-algebra helpers (port of
``approximategps_tpu/core/linalg.py``): triangular solves,
log-determinants, the AbstractGPs helpers (``At_A``, ``diag_At_A``,
``Xt_invA_X``, ``diag_Xt_invA_X``), ``diag_quad_sym``, ``blocked_tril_inv``,
``blocked_cholesky``, ``chol_with_inv`` and ``tri_project``, the last five
as ``torch.autograd.Function``s with the JAX package's closed-form
pullbacks."""

from __future__ import annotations

import torch

from ..config import config, kernels_take

__all__ = [
    "symmetrize",
    "add_jitter",
    "safe_cholesky",
    "cholesky_or_nan",
    "solve_lower_triangular",
    "solve_upper_triangular",
    "cholesky_solve",
    "tril_logdet",
    "chol_logdet",
    "At_A",
    "diag_At_A",
    "Xt_invA_X",
    "diag_Xt_invA_X",
    "diag_quad_sym",
    "blocked_tril_inv",
    "blocked_cholesky",
    "chol_with_inv",
    "chol_with_inv_plain",
    "tri_project",
]


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.transpose(-1, -2))


def add_jitter(A: torch.Tensor, jitter) -> torch.Tensor:
    return A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def safe_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized A (add jitter before)."""
    return torch.linalg.cholesky(symmetrize(A))


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of A (batched too; its lower triangle is
    read), NaN where a factorization fails, as ``jnp.linalg.cholesky``
    returns them: unlike :func:`safe_cholesky` it neither raises nor makes
    the host wait for the device to check."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _solve_triangular(T: torch.Tensor, B: torch.Tensor, upper: bool) -> torch.Tensor:
    vec = B.ndim == T.ndim - 1
    X = torch.linalg.solve_triangular(T, B[..., None] if vec else B, upper=upper)
    return X[..., 0] if vec else X


def solve_lower_triangular(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B for lower-triangular L (a vector B too)."""
    return _solve_triangular(L, B, upper=False)


def solve_upper_triangular(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B for upper-triangular U (a vector B too)."""
    return _solve_triangular(U, B, upper=True)


def cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B given the lower Cholesky factor L."""
    return solve_upper_triangular(L.transpose(-1, -2), solve_lower_triangular(L, B))


def tril_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|det L| for a triangular factor L."""
    return torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))), dim=-1)


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """logdet of A = L Lᵀ given its Cholesky factor."""
    return 2.0 * tril_logdet(L)


def At_A(A: torch.Tensor) -> torch.Tensor:
    """AᵀA (AbstractGPs.At_A)."""
    return A.transpose(-1, -2) @ A


def diag_At_A(A: torch.Tensor) -> torch.Tensor:
    """diag(AᵀA) without forming the product (AbstractGPs.diag_At_A),
    accumulated in at least f32 and returned in that type."""
    acc = torch.promote_types(A.dtype, torch.float32)
    A = A.to(acc)
    return torch.sum(A * A, dim=-2)


def Xt_invA_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """XᵀA⁻¹X given A's lower Cholesky factor L."""
    return At_A(solve_lower_triangular(L, X))


def diag_Xt_invA_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """diag(XᵀA⁻¹X) given A's lower Cholesky factor L."""
    return diag_At_A(solve_lower_triangular(L, X))


def _phi(X: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal: the Cholesky-differential projector."""
    return torch.tril(X) - 0.5 * torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))


class _DiagQuadSym(torch.autograd.Function):
    """diag(Kᵀ S K) with the pullback, for symmetric S and w = the output's
    cotangent, K̄ = 2 (S K)∘w and S̄ = sym((K∘w) Kᵀ): the backward reuses the
    forward's S K, so it pays one matmul where autograd would keep S K and
    form it again."""

    @staticmethod
    def forward(ctx, S, K):
        SK = S @ K
        ctx.save_for_backward(K, SK)
        return torch.sum(K * SK, dim=0)

    @staticmethod
    def backward(ctx, w):
        K, SK = ctx.saved_tensors
        S_bar = symmetrize((K * w) @ K.T) if ctx.needs_input_grad[0] else None
        K_bar = 2.0 * SK * w if ctx.needs_input_grad[1] else None
        return S_bar, K_bar


def diag_quad_sym(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """diag(Kᵀ S K) for symmetric S: one (M, M)·(M, B) product and a
    column reduce, with a closed-form pullback."""
    if S.dtype != K.dtype:
        raise ValueError(
            f"diag_quad_sym requires S.dtype == K.dtype, got {S.dtype} vs {K.dtype}"
        )
    return _DiagQuadSym.apply(S, K)


class _BlockedTrilInv(torch.autograd.Function):
    """L⁻¹ of a lower-triangular L, with the pullback
    L̄ = tril(−L⁻ᵀ L̄ᵢₙᵥ L⁻ᵀ) from the saved inverse: two matmuls."""

    @staticmethod
    def forward(ctx, L):
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        ctx.save_for_backward(Linv)
        return Linv

    @staticmethod
    def backward(ctx, Linv_bar):
        (Linv,) = ctx.saved_tensors
        LiT = Linv.transpose(-1, -2)
        return torch.tril(-(LiT @ (Linv_bar @ LiT)))


def blocked_tril_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular matrix, with a matmul-only pullback.

    The JAX package inverts by recursive 2×2 blocking so that the TPU's
    matrix unit does the work; here one ``torch.linalg.solve_triangular``
    against the identity does (cuBLAS's triangular solve on the card)."""
    return _BlockedTrilInv.apply(L)


def _blocked_cholesky_impl(A: torch.Tensor, base: int) -> torch.Tensor:
    n = A.shape[-1]
    if n <= base:
        return torch.linalg.cholesky(A)
    half = n // 2
    if half % base:
        half = max(base, (half // base) * base)
    L11 = _blocked_cholesky_impl(A[..., :half, :half], base)
    eye = torch.eye(half, dtype=A.dtype, device=A.device)
    L11_inv = torch.linalg.solve_triangular(L11, eye, upper=False)
    L21 = A[..., half:, :half] @ L11_inv.transpose(-1, -2)
    L22 = _blocked_cholesky_impl(A[..., half:, half:] - L21 @ L21.transpose(-1, -2), base)
    top = torch.cat([L11, torch.zeros_like(A[..., :half, half:])], dim=-1)
    return torch.cat([top, torch.cat([L21, L22], dim=-1)], dim=-2)


class _BlockedCholesky(torch.autograd.Function):
    """L = chol(A) by recursive 2×2 blocking, with the Cholesky pullback
    Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹) by two triangular solves (not autograd
    through the recursion)."""

    @staticmethod
    def forward(ctx, A, base):
        L = _blocked_cholesky_impl(A, base)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        P = _phi(L.transpose(-1, -2) @ torch.tril(L_bar))
        X = torch.linalg.solve_triangular(L.transpose(-1, -2), P, upper=True)  # L⁻ᵀ P
        A_bar = torch.linalg.solve_triangular(L, X, upper=False, left=False)  # X L⁻¹
        return symmetrize(A_bar), None


def blocked_cholesky(A: torch.Tensor, base: int = 256) -> torch.Tensor:
    """Lower Cholesky factor by recursive 2×2 blocking (right-looking):
    L11 = chol(A11), L21 = A21 L11⁻ᵀ, L22 = chol(A22 − L21 L21ᵀ), diagonal
    blocks of at most ``base`` by ``torch.linalg.cholesky``; the pullback is
    the closed form by two triangular solves."""
    return _BlockedCholesky.apply(A, int(base))


class _TriProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, X, transpose_t):
        T = torch.tril(T)
        ctx.transpose_t = transpose_t
        ctx.save_for_backward(T, X)
        return (T.transpose(-1, -2) if transpose_t else T) @ X

    @staticmethod
    def backward(ctx, Y_bar):
        T, X = ctx.saved_tensors
        if ctx.transpose_t:  # Y = Tᵀ X: T̄ = tril(X Ȳᵀ), X̄ = T Ȳ
            return torch.tril(X @ Y_bar.transpose(-1, -2)), T @ Y_bar, None
        # Y = T X: T̄ = tril(Ȳ Xᵀ), X̄ = Tᵀ Ȳ
        return torch.tril(Y_bar @ X.transpose(-1, -2)), T.transpose(-1, -2) @ Y_bar, None


def tri_project(T: torch.Tensor, X: torch.Tensor, transpose_t: bool = False) -> torch.Tensor:
    """Y = T X (Tᵀ X with ``transpose_t``) for a lower-triangular (M, M) T,
    whose strictly upper entries are not read, and an (M, B) X; the T
    cotangent is lower triangular (T̄ = tril(Ȳ Xᵀ), or tril(X Ȳᵀ)).  The
    JAX package skips T's zero blocks for the TPU's matrix unit; here one
    product of tril(T) does the work."""
    return _TriProject.apply(T, X, bool(transpose_t))


def _chol_bwd_from_inv(L, Linv, L_bar):
    """Ā from L̄ for L = chol(A), using L⁻¹ (Murray 2016, eq. 8 rearranged):
    Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹), three matmuls and no triangular solve."""
    P = _phi(L.transpose(-1, -2) @ torch.tril(L_bar))
    return symmetrize(Linv.transpose(-1, -2) @ (P @ Linv))


def _inv_chol_bwd_fused(L, J, L_bar, J_bar):
    """Ā for (L, J = L⁻¹) = chol_with_inv(A) in one Φ-sandwich,

        Ā = sym(Jᵀ Φ(Lᵀ tril(L̄) − J̄ Jᵀ) J),

    3 matmuls with only J̄, 4 with both.  None stands for an absent
    cotangent.  Plain ``torch.matmul``: the JAX package leaves it to XLA."""
    inner = None
    if L_bar is not None:
        inner = L.transpose(-1, -2) @ torch.tril(L_bar)
    if J_bar is not None:
        t = J_bar @ J.transpose(-1, -2)
        inner = -t if inner is None else inner - t
    if inner is None:
        return torch.zeros_like(L)
    return symmetrize(J.transpose(-1, -2) @ (_phi(inner) @ J))


def chol_with_inv_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) = (chol(sym(A)), tril_inv(L)) through torch.linalg, with
    exact zeros above both diagonals."""
    L = safe_cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    J = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, torch.tril(J)


def _chol_with_inv_impl(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward of :func:`chol_with_inv`: the (L, L⁻¹) kernel
    (``ops.panel_chol.chol_inv``, its plain version on the CPU) where kernels
    serve, else torch.linalg."""
    if config.chol_mode == "plain" or A.ndim != 2 or not kernels_take(A):
        return chol_with_inv_plain(A)
    from ..ops.panel_chol import chol_inv

    return chol_inv(A)


class _CholWithInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        L, J = _chol_with_inv_impl(A)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(L, J)
        return L, J

    @staticmethod
    def backward(ctx, L_bar, J_bar):
        L, J = ctx.saved_tensors
        return _inv_chol_bwd_fused(L, J, L_bar, J_bar)


def chol_with_inv(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of an SPD matrix (add jitter before calling), with a
    matmul-only pullback (:func:`_inv_chol_bwd_fused`).

    Where kernels serve (kernels allowed, ``chol_mode="auto"``) a CUDA
    tensor in f32 or f64 goes through the hand-written (L, L⁻¹) kernel and a
    CPU tensor through its plain version; ``chol_mode="plain"`` takes
    torch.linalg everywhere."""
    return _CholWithInv.apply(A)
