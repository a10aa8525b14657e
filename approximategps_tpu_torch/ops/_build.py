"""Build and load the port's CUDA kernels.

The sources in ``approximategps_tpu_torch/csrc/`` are compiled at first use
by ``nvcc``, one process per source, all started together, and linked into
one shared library with a plain C interface, loaded with ctypes.  The library lands in ``approximategps_tpu_torch/_build/`` under a
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
_SOURCES = ("gram_chol_inv.cu", "gram_chol_inv_mma.cu", "svgp_epilogue.cu", "svgp_epilogue_bwd.cu", "svgp_epilogue_mma.cu",
            "svgp_epilogue_bwd_mma.cu", "gram_matvec.cu",
            "gram_matvec_f64.cu", "gram_matvec_mma.cu", "gram_matvec_self_bwd.cu", "vecchia_band.cu", "vecchia_band_f64.cu", "vecchia_band_bwd.cu",
            "vecchia_band_bwd_f64.cu", "band_rows.cu", "band_rows_f64.cu", "stationary_gram.cu",
            "stationary_gram_f64.cu")
_HEADERS = ("kernel_maps.cuh", "fast_maps.cuh", "tf32_mma.cuh", "svgp_epilogue_mma.cuh",
            "vecchia_window.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# name: (argtypes, restype); every launching entry point returns a cudaError_t
_SIGNATURES = {
    # z, coef, L, J, scratch, M, Mp, D, kmap, stream: the f64 host loop and the f32
    # panel steps
    "agp_gram_chol_inv_f64": ((_p, _p, _p, _p, _p, _i, _i, _i, _i, _p), _i),
    "agp_gram_chol_inv_mma_f32": ((_p, _p, _p, _p, _p, _i, _i, _i, _i, _p), _i),
    # A, L, J, scratch, M, Mp, stream: likewise
    "agp_chol_inv_f64": ((_p, _p, _p, _p, _i, _i, _p), _i),
    "agp_chol_inv_mma_f32": ((_p, _p, _p, _p, _i, _i, _p), _i),
    # Mp -> scratch elements of the host loop and of the panel steps (either form)
    "agp_gram_chol_inv_scratch": ((_i,), ctypes.c_longlong),
    "agp_gram_chol_inv_mma_scratch": ((_i,), ctypes.c_longlong),
    # xs, zs, se, ae, mu, var, B, M, D, block_b, kmap, stream
    "agp_svgp_epilogue_f32": ((_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p), _i),
    "agp_svgp_epilogue_f64": ((_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p), _i),
    # xs, zs, se, ae, dmu, dvar, xbar, zbar, sebar, aebar, scratch, B, M, D, kmap, stream
    "agp_svgp_epilogue_bwd_f32": ((_p,) * 11 + (_i, _i, _i, _i, _p), _i),
    "agp_svgp_epilogue_bwd_f64": ((_p,) * 11 + (_i, _i, _i, _i, _p), _i),
    # xs, zs, se, ae, mu, var, scratch, B, M, D, kmap, stream
    "agp_svgp_epilogue_mma_f32": ((_p,) * 7 + (_i, _i, _i, _i, _p), _i),
    # M, D -> scratch elements
    "agp_svgp_epilogue_mma_scratch_f32": ((_i, _i), ctypes.c_longlong),
    "agp_svgp_epilogue_bwd_mma_f32": ((_p,) * 11 + (_i, _i, _i, _i, _p), _i),
    # B, M, D -> scratch elements
    "agp_svgp_epilogue_bwd_mma_scratch_f32": ((_i, _i, _i), ctypes.c_longlong),
    "agp_svgp_epilogue_bwd_scratch_f32": ((_i, _i, _i), ctypes.c_longlong),
    "agp_svgp_epilogue_bwd_scratch_f64": ((_i, _i, _i), ctypes.c_longlong),
    # xq, zk, v, out, N, M, D, R, kmap, deriv, stream
    "agp_gram_matvec_f32": ((_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p), _i),
    "agp_gram_matvec_f64": ((_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p), _i),
    "agp_gram_matvec_mma_f32": ((_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p), _i),
    # x, v, obar, vbar, xbar (its chunks' shares), N, D, R, kmap, stream
    "agp_gram_matvec_self_bwd_f32": ((_p, _p, _p, _p, _p, _i, _i, _i, _i, _p), _i),
    # xw, its strides (n, d, j), valid, its strides (n, t), nugget, nugget_self, out,
    # N, D, k, kmap, stream
    "agp_vecchia_band_f32": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _i, _p, _i, _i, _i, _i, _p), _i),
    "agp_vecchia_band_f64": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _i, _p, _i, _i, _i, _i, _p), _i),
    # the forward's xw, valid, nugget and nugget_self, gbar and its strides (n, j), xbar and
    # its strides (n, d, j), nbar, N, D, k, kmap, stream
    "agp_vecchia_band_bwd_f32": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _i, _p, _ll, _ll, _p, _ll,
                                  _ll, _ll, _p, _i, _i, _i, _i, _p), _i),
    "agp_vecchia_band_bwd_f64": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _i, _p, _ll, _ll, _p, _ll,
                                  _ll, _ll, _p, _i, _i, _i, _i, _p), _i),
    # kw and its strides (n, i, j), kni and its strides (n, t), kdiag and its stride, out, B, k,
    # stream
    "agp_band_rows_f32": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _ll, _p, _i, _i, _p), _i),
    "agp_band_rows_f64": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _p, _ll, _p, _i, _i, _p), _i),
    # x and its strides (b, n, d), z and its strides (b, m, d), out, B, N, M, D, kmap, stream
    "agp_stationary_gram_f32": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _ll, _p, _i, _i, _i, _i, _i,
                                 _p), _i),
    "agp_stationary_gram_f64": ((_p, _ll, _ll, _ll, _p, _ll, _ll, _ll, _p, _i, _i, _i, _i, _i,
                                 _p), _i),
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
        tag = f"{lib_path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f".{tag}.{Path(src).stem}.o" for src in _SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(_SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        tmp = BUILD_DIR / f".{tag}.so.tmp"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs) if proc.returncode]
        log = [" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode:
                failed.append((link, proc.stderr))
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            cmd, out = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
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
