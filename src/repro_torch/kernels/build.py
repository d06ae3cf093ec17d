"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source under ``csrc/`` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<src>.cu

The libraries land in ``_build/`` next to this file (listed in
``.gitignore``), named by a digest of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  All
sources are compiled in parallel, one ``nvcc`` each.  ``ptxas``'s report
(registers, shared memory, spills per kernel) is kept beside each
library.  Nothing here runs at import time; a missing ``nvcc`` or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["SOURCES", "BuildInfo", "build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library name -> (source file, {C function: argtypes})
SOURCES = {
    "blmac_bank": ("blmac_bank.cu", {
        # frames, stride_c, stride_tile, n_chan, n_tiles, tile, taps, n_out,
        # out, ld, digits, tiles, groups, terms, dest, n_row_tiles, stream
        "blmac_bank_launch": [_P, _L, _L, _I, _I, _I, _I, _I, _P, _L, _P, _P,
                              _P, _P, _P, _I, _P],
        "blmac_bank_smem_bytes": [_I],  # taps
    }),
    "blmac_specialized": ("blmac_specialized.cu", {
        # frames, stride_c, stride_tile, table, offsets, segs, n_segs,
        # tab_pad, out, n_filters, n_chan, n_tiles, tile, taps, threads,
        # outs, stream, device
        "blmac_specialized_launch": [_P, _L, _L, _P, _P, _P, _I, _I, _P, _I,
                                     _I, _I, _I, _I, _I, _I, _P, _I],
        # tab_pad, threads, taps, outs
        "blmac_specialized_smem_bytes": [_I, _I, _I, _I],
        # frames, stride_c, stride_tile, image, index, terms, b_bytes, out,
        # n_filters, n_chan, n_tiles, tile, taps, stream, device
        "blmac_specialized_wgmma_launch": [_P, _L, _L, _P, _P, _P, _I, _P,
                                           _I, _I, _I, _I, _I, _P, _I],
    }),
    "blmac_combine": ("blmac_combine.cu", {
        # y, stride_row, stride_chan, n_real, n_chan, n_out, n_groups,
        # max_union, group_quads, group_union, ulist, quads, table, wide,
        # stream
        "blmac_combine_launch": [_P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P,
                                 _P, _P, _I, _P],
    }),
    "blmac_pulse_matmul": ("blmac_pulse_matmul.cu", {
        # x, codes, group_exp, workspace, counters, out, m, n, k, planes,
        # group, bm, per, stages, stream, device
        "blmac_pulse_matmul_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _P, _I],
        # bm, planes, group, stages
        "blmac_pulse_matmul_smem_bytes": [_I, _I, _I, _I],
        # stream, unsigned long long* id
        "blmac_stream_id": [_P, _P],
    }),
}


@dataclass(frozen=True)
class BuildInfo:
    """One compiled library: where it is, how long ``nvcc`` took (0.0
    when it was already built) and ``ptxas``'s per-kernel report."""

    name: str
    path: str
    seconds: float
    cached: bool
    ptxas: str

    def resources(self) -> dict:
        """Registers, static shared memory (bytes) and spill bytes per
        kernel, parsed from the ``ptxas -v`` report.  The kernels take
        dynamic shared memory, sized per launch
        (``blmac_bank_smem_bytes(taps)``, ``blmac_specialized_smem_bytes(
        tab_pad, threads, taps, outs)``; K2's tensor-core design from its
        taps and filter tables, in its launch, beside 24 static bytes for
        its barriers and walk; the combine fold 128 bytes a staged shared
        row, `CombineLayout.max_union`), and so does the pulse matmul
        (``blmac_pulse_matmul_smem_bytes(bm, planes, group, stages)``)."""
        out: dict = {}
        kernel = None
        for line in self.ptxas.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = _demangled(m.group(1))
                out[kernel] = {"static_smem_bytes": 0}  # ptxas omits a zero
                continue
            if kernel is None:
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[kernel]["static_smem_bytes"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[kernel]["spill_store_bytes"] = int(m.group(1))
        return out


def _demangled(symbol: str) -> str:
    for name in ("blmac_bank_kernel", "blmac_specialized_kernel_wgmma",
                 "blmac_specialized_kernel", "blmac_combine_kernel",
                 "blmac_pulse_matmul_kernel"):
        if name in symbol:
            # a template instance: its int and bool arguments, mangled as
            # Li<value>E and Lb<0 or 1>E
            args = [v if t == "i" else ("false", "true")[int(v)]
                    for t, v in re.findall(r"L([ib])(\d+)E", symbol)]
            return f"{name}<{', '.join(args)}>" if args else name
    return symbol


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built on the machine with the GPU"
    )


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, BuildInfo]:
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` per source, all started together; returns
    a `BuildInfo` per library.  Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos: dict[str, BuildInfo] = {}
    running = {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists() and log.exists():
            infos[name] = BuildInfo(name, str(target), 0.0, True,
                                    log.read_text())
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        running[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, target, log,
        )
    failures = []
    for name, (proc, t0, tmp, target, log) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, target)
        log.write_text(text)
        infos[name] = BuildInfo(name, str(target), seconds, False, text)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return infos


_LIBS: dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes``/``restype`` set on each of its C functions."""
    lib = _LIBS.get(name)
    if lib is None:
        info = build_all([name])[name]
        lib = ctypes.CDLL(info.path)
        for fn, argtypes in SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
