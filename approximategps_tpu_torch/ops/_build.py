"""Build and load the port's CUDA kernels.

The sources in ``approximategps_tpu_torch/csrc/`` are compiled at first use
by ``nvcc`` into one shared library with a plain C interface, loaded with
ctypes.  The library lands in ``approximategps_tpu_torch/_build/`` under a
name that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs when a module is imported:
the CPU-only test runs never need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load_library", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("gram_chol_inv.cu", "svgp_epilogue.cu")
_HEADERS = ("kernel_maps.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
_d = ctypes.c_double
# name: (argtypes, restype); every launching entry point returns a cudaError_t
_SIGNATURES = {
    # z, L, J, scratch, M, Mp, D, sig2, jitter, kmap, stream
    "agp_gram_chol_inv_f32": ((_p, _p, _p, _p, _i, _i, _i, _d, _d, _i, _p), _i),
    "agp_gram_chol_inv_f64": ((_p, _p, _p, _p, _i, _i, _i, _d, _d, _i, _p), _i),
    # Mp -> scratch elements
    "agp_gram_chol_inv_scratch": ((_i,), ctypes.c_longlong),
    # xs, zs, se, ae, mu, var, B, M, D, block_b, kmap, stream
    "agp_svgp_epilogue_f32": ((_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p), _i),
    "agp_svgp_epilogue_f64": ((_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p), _i),
    "agp_error_string": ((_i,), ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    lib_path = BUILD_DIR / f"libagp_kernels_{_digest()}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        name = load_library().agp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
