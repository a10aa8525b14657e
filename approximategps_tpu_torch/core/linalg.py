"""Dense linear-algebra helpers (port of
``approximategps_tpu/core/linalg.py``): triangular solves,
log-determinants, the AbstractGPs helpers (``At_A``, ``diag_At_A``,
``Xt_invA_X``, ``diag_Xt_invA_X``), ``diag_quad_sym``, ``blocked_tril_inv``,
``blocked_cholesky``, ``chol_with_inv`` and ``tri_project``, the last five
as ``torch.autograd.Function``s with the JAX package's closed-form
pullbacks, and the triangular-aware block products (``matmul_left_lower``
and the rest) that the large-M pullbacks and projections take."""

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
    form it again.  S K is stored in K's dtype (bf16 under bf16 storage,
    the product accumulating in f32) and the column sums are taken in at
    least f32, the result's dtype; the cotangents come back in K's dtype."""

    @staticmethod
    def forward(ctx, S, K):
        SK = S @ K
        ctx.save_for_backward(K, SK)
        acc = torch.promote_types(K.dtype, torch.float32)
        return torch.sum(K.to(acc) * SK.to(acc), dim=0)

    @staticmethod
    def backward(ctx, w):
        K, SK = ctx.saved_tensors
        w = w.to(K.dtype)
        S_bar = symmetrize((K * w) @ K.T) if ctx.needs_input_grad[0] else None
        K_bar = 2.0 * SK * w if ctx.needs_input_grad[1] else None
        return S_bar, K_bar


def diag_quad_sym(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """diag(Kᵀ S K) for symmetric S: one (M, M)·(M, B) product and a
    column reduce in at least f32, with a closed-form pullback.  S and K
    share a dtype (bf16 under bf16 storage: an f32 result)."""
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


# -- triangular-aware products -----------------------------------------------
# A dense product cannot skip a triangular factor's zero half; split the
# triangular side into nb column (row) blocks and C = A·L becomes nb
# narrowing dense products that do: (nb + 1)/(2 nb) of the flops, 0.56 at
# nb = 8.  The same sums as the dense product in another order.  Used at
# M >= config.tri_matmul_min_m by the chol/inv pullback, the whitened
# cache's pullback and the SVGP projections (tri_project).


def _tri_blocks(M: int, target: int = 1024) -> int:
    """The largest power of two nb <= 16 that divides M with blocks of at
    least ``target``; 1 means the dense product."""
    nb = 1
    while M % (2 * nb) == 0 and M // (2 * nb) >= target and 2 * nb <= 16:
        nb *= 2
    return nb


def matmul_right_lower(A: torch.Tensor, L: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """A @ L with L lower triangular, its zero upper blocks skipped."""
    M = L.shape[-1]
    nb = _tri_blocks(M) if nb is None else nb
    if nb == 1:
        return A @ L
    b = M // nb
    return torch.cat([A[..., :, j * b:] @ L[j * b:, j * b:(j + 1) * b] for j in range(nb)],
                     dim=-1)


def matmul_right_upper(A: torch.Tensor, U: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """A @ U with U upper triangular, its zero lower blocks skipped."""
    M = U.shape[-1]
    nb = _tri_blocks(M) if nb is None else nb
    if nb == 1:
        return A @ U
    b = M // nb
    return torch.cat([A[..., :, :(j + 1) * b] @ U[:(j + 1) * b, j * b:(j + 1) * b]
                      for j in range(nb)], dim=-1)


def matmul_left_upper(U: torch.Tensor, A: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """U @ A with U upper triangular, its zero lower blocks skipped."""
    M = U.shape[-2]
    nb = _tri_blocks(M) if nb is None else nb
    if nb == 1:
        return U @ A
    b = M // nb
    return torch.cat([U[i * b:(i + 1) * b, i * b:] @ A[i * b:, ...] for i in range(nb)],
                     dim=-2)


def matmul_left_lower(L: torch.Tensor, A: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """L @ A with L lower triangular, its zero upper blocks skipped."""
    M = L.shape[-2]
    nb = _tri_blocks(M) if nb is None else nb
    if nb == 1:
        return L @ A
    b = M // nb
    return torch.cat([L[i * b:(i + 1) * b, :(i + 1) * b] @ A[:(i + 1) * b, ...]
                      for i in range(nb)], dim=-2)


def matmul_tril_out(A: torch.Tensor, B: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """tril(A @ B) for a square (M, M) product, only its lower block
    triangle computed: row block i contracts against B's first (i + 1)·b
    columns, the strictly upper blocks are zeros, the diagonal blocks are
    masked exactly."""
    M = A.shape[-2]
    nb = _tri_blocks(M) if nb is None else nb
    if nb == 1:
        return torch.tril(A @ B)
    b = M // nb
    out = A.new_zeros((M, M))
    for i in range(nb):
        out[i * b:(i + 1) * b, :(i + 1) * b] = A[i * b:(i + 1) * b, :] @ B[..., :, :(i + 1) * b]
    return torch.tril(out)


class _TriProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, X, transpose_t):
        T = torch.tril(T)
        ctx.transpose_t = transpose_t
        ctx.save_for_backward(T, X)
        if transpose_t:
            return matmul_left_upper(T.transpose(-1, -2), X)
        return matmul_left_lower(T, X)

    @staticmethod
    def backward(ctx, Y_bar):
        T, X = ctx.saved_tensors
        if ctx.transpose_t:  # Y = Tᵀ X: T̄ = tril(X Ȳᵀ), X̄ = T Ȳ
            return (matmul_tril_out(X, Y_bar.transpose(-1, -2)),
                    matmul_left_lower(T, Y_bar), None)
        # Y = T X: T̄ = tril(Ȳ Xᵀ), X̄ = Tᵀ Ȳ
        return (matmul_tril_out(Y_bar, X.transpose(-1, -2)),
                matmul_left_upper(T.transpose(-1, -2), Y_bar), None)


def tri_project(T: torch.Tensor, X: torch.Tensor, transpose_t: bool = False) -> torch.Tensor:
    """Y = T X (Tᵀ X with ``transpose_t``) for a lower-triangular (M, M) T,
    whose strictly upper entries are not read, and an (M, B) X, in their
    common dtype (bf16 under bf16 storage); the T cotangent is lower
    triangular (T̄ = tril(Ȳ Xᵀ), or tril(X Ȳᵀ)).  Both directions take the
    triangular-aware block products (:func:`matmul_left_lower` and the
    rest), dense where :func:`_tri_blocks` gives one block (M < 2048)."""
    return _TriProject.apply(T, X, bool(transpose_t))


def _chol_bwd_from_inv(L, Linv, L_bar):
    """Ā from L̄ for L = chol(A), using L⁻¹ (Murray 2016, eq. 8 rearranged):
    Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹), three matmuls and no triangular solve."""
    P = _phi(L.transpose(-1, -2) @ torch.tril(L_bar))
    return symmetrize(Linv.transpose(-1, -2) @ (P @ Linv))


def _tri_gate(T: torch.Tensor) -> bool:
    """Whether products with the (M, M) triangular factor T take the
    triangular-aware blocks: unbatched, M >= ``config.tri_matmul_min_m``."""
    return T.ndim == 2 and T.shape[-1] >= config.tri_matmul_min_m


def _phi_sandwich(J: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """sym(Jᵀ P J) for lower-triangular J and P: the last two products of
    the chol/inv pullbacks, triangular-aware at M >= tri_matmul_min_m."""
    if _tri_gate(J):
        return symmetrize(matmul_left_upper(J.T, matmul_right_lower(P, J)))
    return symmetrize(J.transpose(-1, -2) @ (P @ J))


def _inv_chol_bwd_fused(L, J, L_bar, J_bar):
    """Ā for (L, J = L⁻¹) = chol_with_inv(A) in one Φ-sandwich,

        Ā = sym(Jᵀ Φ(Lᵀ tril(L̄) − J̄ Jᵀ) J),

    3 matmuls with only J̄, 4 with both.  None stands for an absent
    cotangent.  Every factor is triangular (Lᵀ and Jᵀ upper, J and Φ(·)
    lower), so at M >= ``config.tri_matmul_min_m`` the products skip their
    zero blocks (:func:`matmul_left_upper` and the rest)."""
    tri = _tri_gate(L)
    inner = None
    if L_bar is not None:
        Lt, tl = L.transpose(-1, -2), torch.tril(L_bar)
        inner = matmul_left_upper(Lt, tl) if tri else Lt @ tl
    if J_bar is not None:
        Jt = J.transpose(-1, -2)
        t = matmul_right_upper(J_bar, Jt) if tri else J_bar @ Jt
        inner = -t if inner is None else inner - t
    if inner is None:
        return torch.zeros_like(L)
    return _phi_sandwich(J, _phi(inner))


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
