#!/usr/bin/env python3
"""Blocks an SM for the Vecchia band kernel and its pullback, on one CUDA GPU.

    python3 scripts/occupancy_vecchia_torch.py

The two kernels (``csrc/vecchia_band.cu``, ``csrc/vecchia_band_bwd.cu``)
ask ``__launch_bounds__`` for a number of blocks an SM at KW <= 32 in f32
(``Shape::MIN_BLOCKS`` in ``csrc/vecchia_window.cuh`` for the band kernel,
``bwd_min_blocks`` in ``csrc/vecchia_band_bwd.cu`` for the pullback), which
caps their registers.  This script builds both f32 kernels at 6, 5, 4 and 3
blocks an SM from copies of the sources in a temporary directory (the
sources in the tree are not touched), prints ptxas's registers and spills
for KW = 32, and times each build on ``chip_smoke.py``'s shapes at 10^6
windows, k = 32 (the build's, the sweep's and the training step's) with CUDA
events, in turns (6, 5, 4, 3, then 3, 4, 5, 6), each call's bits against
the tree's own build.  Prints the card's name and power limit first.  Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from approximategps_tpu_torch.core import kernels as tk  # noqa: E402
from approximategps_tpu_torch.ops import _build, batched_chol  # noqa: E402
from approximategps_tpu_torch.utils.bijectors import softplus  # noqa: E402

BLOCKS = (6, 5, 4, 3)
# the two launch bounds as the tree states them (f32, KW <= 32)
BOUNDS = (("vecchia_window.cuh", "KW <= 32 ? 6 : 1;"),
          ("vecchia_band_bwd.cu", "KW <= 32 ? 5 : 1;"))
ENTRIES = ("agp_vecchia_band_f32", "agp_vecchia_band_bwd_f32")


def start(blocks: int, tmp: Path):
    """nvcc, started, on copies of the sources with every launch bound at
    ``blocks``: (the copy's directory, its two processes)."""
    d = tmp / f"b{blocks}"
    d.mkdir()
    for src in _build.CSRC.iterdir():
        (d / src.name).write_bytes(src.read_bytes())
    for name, bound in BOUNDS:
        text = (d / name).read_text()
        if bound not in text:
            raise SystemExit(f"occupancy: {name} no longer states {bound!r}")
        (d / name).write_text(text.replace(bound, f"KW <= 32 ? {blocks} : 1;"))
    return d, [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                                 str(d / f"{src}.o"), str(d / src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
               for src in ("vecchia_band.cu", "vecchia_band_bwd.cu")]


def finish(d: Path, procs) -> tuple[ctypes.CDLL, str]:
    """The started build linked and loaded: (the library, ptxas's report)."""
    report = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise SystemExit(f"occupancy: nvcc failed\n{report[-3000:]}")
    subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"),
                    str(d / "vecchia_band.cu.o"), str(d / "vecchia_band_bwd.cu.o")], check=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return lib, report


def kw32_usage(report: str) -> list[str]:
    """ptxas's registers and spills of the f32 KW = 32 kernels."""
    out, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("Used" in line or "spill" in line):
            m = re.search(r"kernelIfLi32ELi(\d)", entry)
            if m:
                kind = "pullback" if "bwd" in entry else "band"
                out.append(f"{kind} map {m.group(1)}: {line.split(':', 1)[-1].strip()}")
    return out


def shapes(dev):
    """chip_smoke.py's three timed calls at 10^6 windows, k = 32."""
    N, K = cs.N_VEC, cs.VEC_K
    f32 = torch.float32
    kmap = tk.Matern32Kernel().kernel_map()
    x = torch.linspace(0.0, float(N), N, device=dev)
    iota = torch.arange(N, device=dev)
    validT = torch.stack([iota >= K - t for t in range(K)]).to(f32)

    def rows10(xs):
        rows = [torch.cat([xs[:1].expand(K - t), xs[:N - K + t]]) for t in range(K)]
        return torch.stack(rows + [xs]).reshape(1, K + 1, N)

    xwT = rows10(x)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    X = cs.SWEEP_SIDE * torch.rand((N, 2), generator=gen, device=dev)
    idx = torch.randint(0, N, (N, K), generator=gen, device=dev)
    pts = torch.cat([(X / 5.0)[idx], (X / 5.0)[:, None, :]], dim=1)
    ones = X.new_ones(()).expand(N, K)
    ratio = torch.tensor([0.1], device=dev)
    th = torch.tensor(cs.NUGGET_THETA, device=dev, dtype=f32)
    xwb = rows10(x / softplus(th[1])).permute(2, 0, 1)
    g = torch.randn((N, K + 1), generator=gen, device=dev)
    return {
        "band, the build's shape": lambda: batched_chol.vecchia_band_t(xwT, validT, kmap),
        "band, the sweep's shape": lambda: batched_chol.vecchia_band(pts.transpose(1, 2), ones,
                                                                     kmap, ratio, False),
        "pullback, the training step's shape": lambda: batched_chol.vecchia_band_bwd(
            xwb, validT.T, kmap, g, ratio),
    }


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    calls = shapes(dev)
    own = {name: fn() for name, fn in calls.items()}
    tree_load = batched_chol._build.load_library
    with tempfile.TemporaryDirectory() as tmp:
        started = {blocks: start(blocks, Path(tmp)) for blocks in BLOCKS}
        libs = {}
        for blocks in BLOCKS:
            libs[blocks], report = finish(*started[blocks])
            for line in kw32_usage(report):
                print(f"{blocks} blocks an SM: {line}")
        try:
            for blocks in BLOCKS + BLOCKS[::-1]:
                batched_chol._build.load_library = lambda b=blocks: libs[b]
                for name, fn in calls.items():
                    got, want = fn(), own[name]
                    same = all(torch.equal(a, b) for a, b in zip(
                        got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)) if a is not None)
                    print(f"{blocks} blocks an SM, {name}: {cs.cuda_ms(fn, 10):.3f} ms "
                          f"(bits as the tree's build: {same})", flush=True)
        finally:
            batched_chol._build.load_library = tree_load


if __name__ == "__main__":
    sys.exit(main())
