"""Kernel library and Gram construction (PyTorch port of
``approximategps_tpu/core/kernels.py``: the stationary maps, the rational
quadratic and periodic kernels, the white, constant, linear and polynomial
kernels, scaling, sums, products and the unwrappers the fused kernels read).

Kernels are plain dataclasses whose hyperparameters are tensors or floats.
Gram matrices come from pairwise squared distances, computed by exact
broadcasting or by the ``|x|² + |z|² − 2·x zᵀ`` matmul identity on centred
inputs, or (``gram_mode="fused"``) by the fused Gram kernel of
``ops/gram.py``.

A CUDA kernel cannot call a Python function, so where the JAX package
identifies a stationary map by its ``staticmethod``, the port gives each map
a :class:`KernelMap`: an integer id the CUDA side switches on, beside the
PyTorch function the plain versions use.  Kernels whose map closes over a
parameter (rational quadratic, periodic) have none, and leave the fused
tiers, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple

import torch

from ..config import config

__all__ = [
    "Kernel",
    "StationaryKernel",
    "SqExponentialKernel",
    "SEKernel",
    "RBFKernel",
    "Matern12Kernel",
    "ExponentialKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "PeriodicKernel",
    "WhiteKernel",
    "ConstantKernel",
    "LinearKernel",
    "PolynomialKernel",
    "ScaledKernel",
    "InputScaledKernel",
    "SumKernel",
    "ProductKernel",
    "with_lengthscale",
    "ScaleTransform",
    "pairwise_sq_dist",
    "as_points",
    "KernelMapId",
    "KernelMap",
    "dk_from_k_for",
    "unwrap_stationary",
    "unwrap_stationary_nugget",
    "SPECTRAL_DF",
    "unwrap_spectral",
]


def as_points(X) -> torch.Tensor:
    """Canonicalize inputs to shape (N, D)."""
    X = torch.as_tensor(X)
    if X.ndim == 0:
        return X.reshape(1, 1)
    if X.ndim == 1:
        return X[:, None]
    if X.ndim == 2:
        return X
    raise ValueError(f"kernel inputs must be (N,) or (N, D); got shape {tuple(X.shape)}")


def _resolve_gram_mode(n: int, m: int, d: int) -> str:
    mode = config.gram_mode
    if mode == "auto":
        return "matmul" if n * m * d >= config.gram_auto_threshold else "broadcast"
    return mode


def pairwise_sq_dist(X, Z, mode: str | None = None) -> torch.Tensor:
    """Pairwise squared Euclidean distances, shape (N, M).

    ``broadcast`` is exact (differences squared); ``matmul`` uses the
    |x|²-identity on inputs centred on the joint mean, whose error scales
    with eps·max|x−c|² rather than eps·max|x|²; ``fused``, which names a
    Gram kernel and not a distance, takes ``matmul`` here, as the JAX
    package's ``"pallas"`` does."""
    X = as_points(X)
    Z = as_points(Z)
    if mode is None:
        mode = _resolve_gram_mode(X.shape[0], Z.shape[0], X.shape[1])
    if mode == "broadcast":
        diff = X[:, None, :] - Z[None, :, :]
        return torch.sum(diff * diff, dim=-1)
    if mode not in ("matmul", "fused"):
        raise ValueError(f"unknown distance mode {mode!r}")
    center = 0.5 * (X.mean(dim=0) + Z.mean(dim=0))
    X = X - center
    Z = Z - center
    xz = X @ Z.T
    x2 = torch.sum(X * X, dim=-1)
    z2 = torch.sum(Z * Z, dim=-1)
    r2 = x2[:, None] + z2[None, :] - 2.0 * xz
    return torch.clamp(r2, min=0.0)


class KernelMapId(enum.IntEnum):
    """Ids of the stationary maps the CUDA kernels implement; the values
    must match ``csrc/kernel_maps.cuh``."""

    SE = 0
    MATERN12 = 1
    MATERN32 = 2
    MATERN52 = 3


class KernelMap(NamedTuple):
    """A parameter-free stationary map g(r²): the id the CUDA side switches
    on, the PyTorch function the plain versions use, and its derivative
    g′(r²) for the hand-written pullbacks (``kernel_map_dr2`` in
    ``csrc/kernel_maps.cuh``)."""

    id: KernelMapId
    k_of_r2: Callable[[torch.Tensor], torch.Tensor]
    dk_of_r2: Callable[[torch.Tensor], torch.Tensor]


class Kernel:
    """Base class: ``gram(X, Z)`` (cross-covariance) and ``diag(X)``."""

    def gram(self, X, Z=None) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, X) -> torch.Tensor:
        raise NotImplementedError

    def __add__(self, other):
        if isinstance(other, Kernel):
            return SumKernel(self, other)
        return SumKernel(self, ConstantKernel(other))

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return ProductKernel(self, other)
        return ScaledKernel(self, other)

    __rmul__ = __mul__


class StationaryKernel(Kernel):
    """Kernels of the form k(x, z) = g(||x - z||²).  Parameter-free maps
    define ``k_of_r2`` as a staticmethod and name their map in ``map_id``;
    a map that closes over a parameter is a method and has ``map_id`` None."""

    map_id: KernelMapId | None = None

    @staticmethod
    def k_of_r2(r2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def dk_of_r2(r2: torch.Tensor) -> torch.Tensor:
        """g′(r²), with the value at r² = 0 that the JAX package's autodiff
        gives there (its double-where sqrt has a zero gradient at 0)."""
        raise NotImplementedError

    def kernel_map(self) -> KernelMap | None:
        """The map the CUDA kernels implement, or None for a map that closes
        over a parameter."""
        if self.map_id is None:
            return None
        return KernelMap(self.map_id, type(self).k_of_r2, type(self).dk_of_r2)

    def gram(self, X, Z=None) -> torch.Tensor:
        X = as_points(X)
        symmetric = Z is None
        Z = X if symmetric else as_points(Z)
        mode = _resolve_gram_mode(X.shape[0], Z.shape[0], X.shape[1])
        if symmetric:
            # symmetric Grams feed Cholesky factorizations: the matmul
            # identity's eps·max|x−c|² error breaks PSD-ness for data spans
            # ≫ √jitter, so they always take exact broadcast distances
            mode = "broadcast"
        if mode == "fused":
            kmap = self.kernel_map()
            if kmap is not None:
                from ..ops.gram import stationary_gram

                return stationary_gram(X, Z, kmap)
            # a map with a parameter has no kernel: the matmul distances,
            # as the JAX package's "pallas" mode takes its MXU route there
            mode = "matmul"
        return self.k_of_r2(pairwise_sq_dist(X, Z, mode))

    def diag(self, X) -> torch.Tensor:
        X = as_points(X)
        z = torch.zeros((), dtype=X.dtype, device=X.device)
        return self.k_of_r2(z).expand(X.shape[0]).clone()


def _safe_r(r2: torch.Tensor) -> torch.Tensor:
    """sqrt(r2), exactly 0 at r2 = 0, with a zero (not NaN) gradient there:
    the double-where of the JAX package's ``_safe_r``."""
    pos = r2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, r2, torch.ones_like(r2))),
                       torch.zeros_like(r2))


@dataclasses.dataclass(frozen=True, eq=False)
class SqExponentialKernel(StationaryKernel):
    """k(x,z) = exp(-||x-z||² / 2)."""

    map_id = KernelMapId.SE

    @staticmethod
    def k_of_r2(r2):
        return torch.exp(-0.5 * r2)

    @staticmethod
    def dk_of_r2(r2):
        return -0.5 * torch.exp(-0.5 * r2)

    @staticmethod
    def dk_from_k(k):
        """g′(r²) through g(r²): lets a pullback reuse K instead of
        rebuilding r² and rerunning the map."""
        return -0.5 * k


SEKernel = SqExponentialKernel
RBFKernel = SqExponentialKernel


@dataclasses.dataclass(frozen=True, eq=False)
class Matern12Kernel(StationaryKernel):
    """k(x,z) = exp(-||x-z||)."""

    map_id = KernelMapId.MATERN12

    @staticmethod
    def k_of_r2(r2):
        return torch.exp(-_safe_r(r2))

    @staticmethod
    def dk_of_r2(r2):
        r = _safe_r(r2)
        return torch.where(r2 > 0, -0.5 * torch.exp(-r) / torch.where(r2 > 0, r, 1.0), 0.0)


ExponentialKernel = Matern12Kernel


@dataclasses.dataclass(frozen=True, eq=False)
class Matern32Kernel(StationaryKernel):
    """k(x,z) = (1 + √3 r) exp(-√3 r)."""

    map_id = KernelMapId.MATERN32

    @staticmethod
    def k_of_r2(r2):
        t = math.sqrt(3.0) * _safe_r(r2)
        return (1.0 + t) * torch.exp(-t)

    @staticmethod
    def dk_of_r2(r2):
        t = math.sqrt(3.0) * _safe_r(r2)
        return torch.where(r2 > 0, -1.5 * torch.exp(-t), 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class Matern52Kernel(StationaryKernel):
    """k(x,z) = (1 + √5 r + 5r²/3) exp(-√5 r)."""

    map_id = KernelMapId.MATERN52

    @staticmethod
    def k_of_r2(r2):
        t = math.sqrt(5.0) * _safe_r(r2)
        return (1.0 + t + (5.0 / 3.0) * r2) * torch.exp(-t)

    @staticmethod
    def dk_of_r2(r2):
        # at 0 only the r² term is left: 5/3
        t = math.sqrt(5.0) * _safe_r(r2)
        return torch.where(r2 > 0, (-5.0 / 6.0) * (1.0 + t) * torch.exp(-t), 5.0 / 3.0)


@dataclasses.dataclass(frozen=True, eq=False)
class RationalQuadraticKernel(StationaryKernel):
    """k(x,z) = (1 + r²/(2α))^(−α).  Its map closes over α, so it has no
    CUDA map and does not unwrap."""

    alpha: torch.Tensor | float = 2.0

    def k_of_r2(self, r2):
        a = _param(self.alpha, r2)
        return (1.0 + r2 / (2.0 * a)) ** (-a)


@dataclasses.dataclass(frozen=True, eq=False)
class PeriodicKernel(StationaryKernel):
    """The 1-D periodic (MacKay) kernel exp(−2 sin²(π r / p)).  Its map
    closes over the period, so it has no CUDA map and does not unwrap."""

    period: torch.Tensor | float = 1.0

    def k_of_r2(self, r2):
        s = torch.sin(math.pi * _safe_r(r2) / _param(self.period, r2))
        return torch.exp(-2.0 * s * s)


def _as_param(v) -> torch.Tensor:
    """A hyperparameter as a tensor; Python and numpy numbers become f64 so
    that no precision is lost before the cast to the inputs' dtype."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.float64)


def _param(v, like: torch.Tensor) -> torch.Tensor:
    v = _as_param(v).to(dtype=like.dtype)
    # a 0-dim CPU tensor combines with a CUDA tensor without a copy
    return v if v.ndim == 0 else v.to(device=like.device)


@dataclasses.dataclass(frozen=True, eq=False)
class WhiteKernel(Kernel):
    """k(x, z) = δ(x == z).  The one-argument ``gram(X)`` is the identity by
    index (iid noise on each observation, as the reference has it); the
    two-argument gram compares the points' values, so points shared by X
    and Z still meet."""

    def gram(self, X, Z=None):
        X = as_points(X)
        if Z is None:
            return torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        Z = as_points(Z)
        return torch.all(X[:, None, :] == Z[None, :, :], dim=-1).to(X.dtype)

    def diag(self, X):
        X = as_points(X)
        return X.new_ones((X.shape[0],))


@dataclasses.dataclass(frozen=True, eq=False)
class ConstantKernel(Kernel):
    """k(x, z) = value."""

    value: torch.Tensor | float = 1.0

    def gram(self, X, Z=None):
        X = as_points(X)
        Z = X if Z is None else as_points(Z)
        return X.new_zeros((X.shape[0], Z.shape[0])) + _param(self.value, X)

    def diag(self, X):
        X = as_points(X)
        return X.new_zeros((X.shape[0],)) + _param(self.value, X)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearKernel(Kernel):
    """k(x, z) = x·z (a full-precision matmul: TF32 stays off)."""

    def gram(self, X, Z=None):
        X = as_points(X)
        Z = X if Z is None else as_points(Z)
        return X @ Z.T

    def diag(self, X):
        X = as_points(X)
        return torch.sum(X * X, dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class PolynomialKernel(Kernel):
    """k(x, z) = (x·z + c)^degree."""

    degree: int = 2
    c: torch.Tensor | float = 0.0

    def gram(self, X, Z=None):
        X = as_points(X)
        Z = X if Z is None else as_points(Z)
        return (X @ Z.T + _param(self.c, X)) ** self.degree

    def diag(self, X):
        X = as_points(X)
        return (torch.sum(X * X, dim=-1) + _param(self.c, X)) ** self.degree


@dataclasses.dataclass(frozen=True, eq=False)
class ScaledKernel(Kernel):
    """variance * inner."""

    inner: Kernel
    variance: torch.Tensor | float = 1.0

    def gram(self, X, Z=None):
        K = self.inner.gram(X, Z)
        return _param(self.variance, K) * K

    def diag(self, X):
        d = self.inner.diag(X)
        return _param(self.variance, d) * d


@dataclasses.dataclass(frozen=True, eq=False)
class InputScaledKernel(Kernel):
    """inner(s*x, s*z); ``scale`` is scalar or (D,) for ARD."""

    inner: Kernel
    scale: torch.Tensor | float = 1.0

    def _tx(self, X):
        X = as_points(X)
        return X * _param(self.scale, X)

    def gram(self, X, Z=None):
        return self.inner.gram(self._tx(X), None if Z is None else self._tx(Z))

    def diag(self, X):
        return self.inner.diag(self._tx(X))


@dataclasses.dataclass(frozen=True, eq=False)
class SumKernel(Kernel):
    """left + right."""

    left: Kernel
    right: Kernel

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) + self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) + self.right.diag(X)


@dataclasses.dataclass(frozen=True, eq=False)
class ProductKernel(Kernel):
    """left · right, entry by entry (``k1 * k2``)."""

    left: Kernel
    right: Kernel

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) * self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) * self.right.diag(X)


def with_lengthscale(kernel: Kernel, lengthscale) -> Kernel:
    """k((x - z) / lengthscale); ``lengthscale`` scalar or (D,)."""
    return InputScaledKernel(kernel, 1.0 / _as_param(lengthscale))


def ScaleTransform(scale):
    """The reference's ``kernel ∘ ScaleTransform(s)``: returns a function that
    wraps a kernel as ``InputScaledKernel(kernel, s)``."""

    def apply(kernel: Kernel) -> Kernel:
        return InputScaledKernel(kernel, _as_param(scale))

    return apply


def dk_from_k_for(kmap: KernelMap):
    """The g′(r²)-through-g(r²) shortcut of a map, or None: a pullback then
    turns the map's derivative into one multiply on a K it already has."""
    return _DK_FROM_K.get(kmap.id)


_DK_FROM_K = {KernelMapId.SE: SqExponentialKernel.dk_from_k}


def unwrap_stationary(kern: Kernel):
    """Decompose ``σ²·(base ∘ ScaleTransform(s))`` nests into
    ``(KernelMap, input_scale, variance)``, or None if the kernel is not a
    (possibly scaled) parameter-free stationary kernel (the rational
    quadratic and periodic maps close over a parameter: None).
    ``input_scale`` and ``variance`` are None where no wrapper supplies
    them."""
    variance = None
    scale = None
    while True:
        if isinstance(kern, ScaledKernel):
            v = _as_param(kern.variance)
            variance = v if variance is None else variance * v
            kern = kern.inner
        elif isinstance(kern, InputScaledKernel):
            s = _as_param(kern.scale)
            scale = s if scale is None else scale * s
            kern = kern.inner
        else:
            break
    kmap = kern.kernel_map() if isinstance(kern, StationaryKernel) else None
    if kmap is None:
        return None
    return kmap, scale, variance


def _mul(a, b):
    """The product of two optional factors (None is 1)."""
    if a is None:
        return b
    return a if b is None else a * b


def _unwrap_white(kern: Kernel):
    """``σ²·White`` nests → σ² (a tensor, 1 for a bare white), or None.
    Input scaling is absorbed: a positive rescaling keeps points equal or
    distinct, so the white map is unchanged."""
    variance = None
    while isinstance(kern, (ScaledKernel, InputScaledKernel)):
        if isinstance(kern, ScaledKernel):
            variance = _mul(variance, _as_param(kern.variance))
        kern = kern.inner
    if not isinstance(kern, WhiteKernel):
        return None
    return torch.ones((), dtype=torch.float64) if variance is None else variance


def unwrap_stationary_nugget(kern: Kernel):
    """:func:`unwrap_stationary` with a nugget: decompose
    ``σ²·(base ∘ ScaleTransform(s)) [+ τ²·White]``, outer factors included
    (``c·(k + w·White)`` is ``c·k + c·w·White``), into ``(KernelMap,
    input_scale, variance, nugget)``, ``nugget`` the τ² tensor or None
    without a white term; None if the kernel is not of that form.

    The noisy-data Vecchia training model: the white term becomes a
    (τ²/σ²)·I shift on the window Gram's index diagonal, iid noise on each
    observation, as the one-argument ``WhiteKernel.gram`` of the plain
    path.  With duplicated sites the plain path's cross-covariance column
    (the two-argument, value-equality white) also couples coincident points
    and the fused one does not: dedupe the sites to keep the two equal."""
    out_var = None
    out_scale = None
    while isinstance(kern, (ScaledKernel, InputScaledKernel)):
        if isinstance(kern, ScaledKernel):
            out_var = _mul(out_var, _as_param(kern.variance))
        else:
            out_scale = _mul(out_scale, _as_param(kern.scale))
        kern = kern.inner
    white = None
    if isinstance(kern, SumKernel):
        for a, b in ((kern.left, kern.right), (kern.right, kern.left)):
            white = _unwrap_white(b)
            if white is not None:
                kern = a
                break
        else:
            return None
    base = unwrap_stationary(kern)
    if base is None:
        return None
    kmap, scale, variance = base
    return (kmap, _mul(out_scale, scale), _mul(out_var, variance),
            None if white is None else _mul(out_var, white))


# Each CUDA map's spectral density for random Fourier features: None for the
# SE map (a standard normal ω), else the degrees of freedom ν of the Matérn's
# multivariate Student-t (Matérn-ν/2).  The keys are exactly KernelMapId.
SPECTRAL_DF = {KernelMapId.SE: None, KernelMapId.MATERN12: 1, KernelMapId.MATERN32: 3,
               KernelMapId.MATERN52: 5}


def unwrap_spectral(kern: Kernel):
    """:func:`unwrap_stationary` read for random Fourier features:
    ``(df, input_scale, variance)`` with ``df`` from :data:`SPECTRAL_DF` and
    ``input_scale`` and ``variance`` 1.0 where no wrapper supplies them.
    Raises ``NotImplementedError`` for a kernel that does not unwrap
    (rational quadratic, periodic, sums, products), as the JAX sampler
    does."""
    parts = unwrap_stationary(kern)
    if parts is None:
        raise NotImplementedError(
            f"RFF sampling implemented for SE/Matérn bases, got {type(kern).__name__}")
    kmap, scale, variance = parts
    return (SPECTRAL_DF[kmap.id], 1.0 if scale is None else scale,
            1.0 if variance is None else variance)
