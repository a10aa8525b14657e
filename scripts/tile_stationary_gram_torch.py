#!/usr/bin/env python3
"""Block shapes for row 11, the fused stationary Gram, on one CUDA GPU.

    python3 scripts/tile_stationary_gram_torch.py

``csrc/stationary_gram.cu`` gives a block WARPS warps, each owning RPT rows
of a tile whose width is a warp's 16-byte runs (128 columns in f32).  This
script builds the f32 kernel at several (WARPS, RPT) from copies of the
source in a temporary directory (the tree's source is not touched), prints
ptxas's registers for the SE map, and times each build at the minibatch
step's Kuf, (N, M, D) = (2048, 8192, 8), with CUDA events around 50
launches back to back (the device's time a launch: the host enqueues faster
than the kernel runs), in turns (the list, then the list reversed), each
result's bits against the tree's own build.  Prints the card's name and
power limit first.  Needs a CUDA device and nvcc.
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
from approximategps_tpu_torch.ops import _build, gram  # noqa: E402

SHAPES = ((8, 8), (4, 8), (8, 4), (8, 16), (4, 16), (16, 4))  # (WARPS, RPT); the tree's first
STATED = ("constexpr int WARPS = 8;", "constexpr int RPT = 8;")
ENTRY = "agp_stationary_gram_f32"
LAUNCHES = 50


def start(shape, tmp: Path):
    """nvcc, started, on a copy of the sources with the block shape set:
    (the copy's directory, its process)."""
    warps, rpt = shape
    d = tmp / f"w{warps}r{rpt}"
    d.mkdir()
    for src in _build.CSRC.iterdir():
        (d / src.name).write_bytes(src.read_bytes())
    text = (d / "stationary_gram.cu").read_text()
    if any(s not in text for s in STATED):
        raise SystemExit(f"tile_stationary_gram: stationary_gram.cu no longer states {STATED}")
    text = text.replace(STATED[0], f"constexpr int WARPS = {warps};")
    (d / "stationary_gram.cu").write_text(text.replace(STATED[1], f"constexpr int RPT = {rpt};"))
    return d, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "sg.o"),
                                str(d / "stationary_gram.cu")], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)


def finish(d: Path, proc) -> tuple[object, str]:
    """The started build linked and loaded: (its entry point, ptxas's
    registers of the f32 SE kernel without the wide-D chunk loop)."""
    report = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"tile_stationary_gram: nvcc failed\n{report[-3000:]}")
    subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "sg.o")],
                   check=True)
    fn = getattr(ctypes.CDLL(str(d / "lib.so")), ENTRY)
    fn.argtypes, fn.restype = _build._SIGNATURES[ENTRY]
    regs, entry = "?", False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = "stationary_gram_kernelIfLi0ELb0E" in line
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            entry = False
    return fn, regs


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    X = torch.randn((cs.M, cs.D), device=dev)
    Z = torch.randn((cs.BATCH, cs.D), device=dev)
    se = tk.SqExponentialKernel().kernel_map()
    ref = gram.stationary_gram_pass(X, Z, se)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (X.data_ptr(), 0, cs.D, 1, Z.data_ptr(), 0, cs.D, 1, out.data_ptr(), 1, cs.M,
            cs.BATCH, cs.D, int(se.id), stream)
    with tempfile.TemporaryDirectory() as tmp:
        started = [(shape, *start(shape, Path(tmp))) for shape in SHAPES]
        built = {shape: finish(d, proc) for shape, d, proc in started}
        times = {shape: [] for shape in SHAPES}
        for shape in SHAPES + SHAPES[::-1]:
            fn, _ = built[shape]
            out.zero_()
            _build.check(fn(*args), "stationary_gram variant")
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"tile_stationary_gram: {shape} differs from the tree's build")
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(LAUNCHES):
                fn(*args)
            b.record()
            b.synchronize()
            times[shape].append(a.elapsed_time(b) / LAUNCHES)
    bound_ms, _ = cs.bound(cs.M * cs.BATCH * (3 * cs.D + 1),
                           4 * (cs.M * cs.D + cs.BATCH * cs.D + cs.M * cs.BATCH), cs.M * cs.BATCH)
    for (warps, rpt), ms in times.items():
        print(f"stationary_gram f32 (2048, 8192, 8) se, WARPS={warps} RPT={rpt} "
              f"({32 * warps} threads, {warps * rpt} rows a block, {built[(warps, rpt)][1]} "
              f"registers): {' '.join(f'{t:.4f}' for t in ms)} ms a launch, bound {bound_ms:.4f}")


if __name__ == "__main__":
    sys.exit(main())
