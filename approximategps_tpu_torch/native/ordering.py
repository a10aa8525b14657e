"""ctypes bindings of the host-side Vecchia preprocessing in
``vecchia_order.cpp``, built with g++ at first use, with numpy versions of
the same algorithms (same outputs) where no compiler is found.

The library lands in ``approximategps_tpu_torch/_build/`` under a name that
hashes the source, so an edited source rebuilds.  Everything here runs on the
host, eagerly; the outputs are plain gather indices for the device code."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = [
    "maximin_ordering",
    "nearest_predecessor_neighbors",
    "native_available",
    "scaled_ball_predecessors",
]

_SRC = Path(__file__).resolve().parent / "vecchia_order.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build() -> Path | None:
    """The shared library's path, compiled if it is not there yet; None
    where g++ is missing or fails."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"vecchia_order_{tag}.so"
    if so_path.exists():
        return so_path
    try:
        _BUILD_DIR.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
            tmp = Path(td) / "vecchia_order.so"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
                            str(tmp)], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError) as exc:
        err = getattr(exc, "stderr", None)
        detail = err.decode(errors="replace").strip() if err else str(exc)
        warnings.warn(f"g++ did not build {_SRC.name} ({detail[:500]}); the orderings run "
                      "their numpy versions", RuntimeWarning, stacklevel=3)
        return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        lib.agp_maximin_order.argtypes = [c_d, i64, i64, c_i]
        lib.agp_maximin_order.restype = None
        lib.agp_nearest_predecessors.argtypes = [c_d, i64, i64, c_i, i64, c_i]
        lib.agp_nearest_predecessors.restype = None
        lib.agp_scaled_predecessors.argtypes = [c_d, i64, i64, c_i, ctypes.c_double, i64, c_i]
        lib.agp_scaled_predecessors.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _as_f64_2d(X) -> np.ndarray:
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
    return X[:, None] if X.ndim == 1 else X


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def maximin_ordering(X) -> np.ndarray:
    """Greedy farthest-point (maximin) ordering (Guinness 2018): start at the
    point nearest the centroid, then repeatedly add the point farthest from
    the ordered set (lowest index on ties).  Returns an (N,) int64
    permutation."""
    X = _as_f64_2d(X)
    N, D = X.shape
    order = np.empty(N, dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.agp_maximin_order(_ptr(X, ctypes.c_double), N, D, _ptr(order, ctypes.c_int64))
        return order
    centroid = X.mean(axis=0)
    first = int(np.argmin(((X - centroid) ** 2).sum(-1)))
    mind = ((X - X[first]) ** 2).sum(-1)
    order[0] = first
    mind[first] = -np.inf
    for step in range(1, N):
        pick = int(np.argmax(mind))
        order[step] = pick
        np.minimum(mind, ((X - X[pick]) ** 2).sum(-1), out=mind)
        mind[pick] = -np.inf
    return order


def nearest_predecessor_neighbors(X, order, k: int) -> np.ndarray:
    """For each ordering position i, the k nearest points among positions
    0..i−1 (exact).  Returns (N, k) int64 ordering positions, ascending,
    padded with −1 where i < k."""
    X = _as_f64_2d(X)
    order = np.ascontiguousarray(np.asarray(order, dtype=np.int64))
    N, D = X.shape
    nbr = np.empty((N, int(k)), dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.agp_nearest_predecessors(_ptr(X, ctypes.c_double), N, D,
                                     _ptr(order, ctypes.c_int64), int(k),
                                     _ptr(nbr, ctypes.c_int64))
        return nbr
    Xo = X[order]
    for i in range(N):
        m = min(k, i)
        nbr[i, :] = -1
        if m:
            d = ((Xo[:i] - Xo[i]) ** 2).sum(-1)
            nbr[i, :m] = np.sort(np.argpartition(d, m - 1)[:m])
    return nbr


def scaled_ball_predecessors(X, order, rho: float, k: int) -> np.ndarray:
    """The KL-minimising sparsity pattern (Schäfer et al., arXiv 2004.14455)
    at a fixed k: for each ordering position i, the predecessors within
    ``rho``·ℓᵢ of point i, ℓᵢ its distance to the ordered set (the maximin
    distance under the maximin ordering); sets larger than k keep the k
    nearest, smaller ones pad with −1.  Returns (N, k) int64 ordering
    positions, ascending."""
    X = _as_f64_2d(X)
    order = np.ascontiguousarray(np.asarray(order, dtype=np.int64))
    N, D = X.shape
    nbr = np.empty((N, int(k)), dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.agp_scaled_predecessors(_ptr(X, ctypes.c_double), N, D,
                                    _ptr(order, ctypes.c_int64), float(rho), int(k),
                                    _ptr(nbr, ctypes.c_int64))
        return nbr
    Xo = X[order]
    rho2 = float(rho) ** 2
    for i in range(N):
        nbr[i, :] = -1
        if i == 0:
            continue
        d = ((Xo[:i] - Xo[i]) ** 2).sum(-1)
        cand = np.flatnonzero(d <= rho2 * d.min())
        if cand.size > k:
            cand = cand[np.argpartition(d[cand], k - 1)[:k]]
        got = np.sort(cand)
        nbr[i, :got.size] = got
    return nbr
