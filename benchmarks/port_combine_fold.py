#!/usr/bin/env python3
"""Time the port's combine-fold kernel at the CSE leg's shapes on a GPU.

    python3 benchmarks/port_combine_fold.py [--src DIR]

The shapes of `chip_smoke.py`'s ``cse`` leg, each on the combine matrix
the port's CSE pass makes for the bank:

  * ``serve`` — the serve bank (256 spread-lowpass filters × 63 taps: 256
                real + 434 shared rows, 11,563 nonzeros) over one push of
                4,096 outputs;
  * ``sweep`` — the paper's §3.1 sweep bank (9,900 filters × 127 taps,
                16-bit po2: 9,900 real + 1,424 shared rows, 828,212
                nonzeros) over 16,258 outputs (16,384 samples).

Each fold runs in place on a (rows, 1, n_out) int32 buffer laid out as
K1 leaves it (`bank_output`: rows padded to 8 words), full-range samples
drawn from a seed.  It is first checked bit for bit against
`combine_plain` (the float64 route on the card) and int64 numpy on 8
rows, then timed two ways: CUDA events around back-to-back folds
(``ms``) and events around folds queued behind a GPU spin (``device_us``,
the device alone).  Each is set beside the fold's bound (its bytes over
3.35 TB/s against one IMAD a nonzero an output at 132 SMs × 64 × 1.98
GHz, as in `chip_smoke.py`), and, where the tree's table has the
redesigned layout, the kernel's launch geometry.  ``--src`` picks the
`src` directory the port is imported from, so that two trees are timed by
the same script in one run.  Two options measure the design itself, on a
tree with the redesigned table: ``--unpaired`` builds the table without
pairing rows (`CombineLayout(..., pair=False)`: one row a pair, the
other slot empty), and ``--source FILE`` compiles FILE (a variant of
``csrc/blmac_combine.cu`` with the same C interface) with the port's
``nvcc`` flags and times it in place of the tree's kernel.  Prints one
JSON object with the times and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SERVE_FILTERS, SERVE_TAPS, PUSH = 256, 63, 4096
SWEEP_TAPS, SWEEP_SAMPLES = 127, 16384
CHECK_ROWS = 8


def cuda_ms(fn, target_ms: float = 200.0) -> float:
    """Mean milliseconds of ``fn`` by CUDA events over enough calls to
    fill ``target_ms``, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(500, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_us(fn, reps: int = 50, spin_cycles: int = 10_000_000) -> float:
    """Mean device microseconds of ``fn``: CUDA events around ``reps``
    calls queued behind a GPU spin (about 5 ms), run back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def fold_bound(n_real: int, n_shared: int, nnz: int, n_out: int) -> dict:
    """`chip_smoke.py`'s bound of one fold over one channel."""
    nbytes = 4 * n_out * (2 * n_real + n_shared) + 4 * (n_real + 1) + 8 * nnz
    ops = nnz * n_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def geometry(bf, table, n_out: int, dev) -> dict | None:
    """The redesigned kernel's launch: span, row groups, staged KiB a
    block, blocks, and the table entries it walks a sample (padding
    included) against the nonzeros; None for a tree whose table has no
    layouts."""
    if not hasattr(table, "layout"):
        return None
    groups = table.groups_for(1, n_out, bf.sm_count(dev))
    lay = table.layout(groups)
    return {"span": bf.COMBINE_SPAN, "groups": lay.n_groups,
            "rows_a_group": -(-table.live_rows // lay.n_groups),
            "staged_kib": lay.max_union * 4 * bf.COMBINE_SPAN / 1024,
            "blocks": -(-n_out // bf.COMBINE_SPAN) * lay.n_groups,
            "threads": 32 * bf.COMBINE_WARPS, "wide": lay.wide,
            "entries": lay.entries,
            "entries_per_nonzero": lay.entries / max(table.nnz, 1)}


def variant_library(path: str):
    """``path`` compiled as the port compiles ``blmac_combine.cu`` and
    loaded with the same C interface."""
    import ctypes

    from repro_torch.kernels.build import NVCC_FLAGS, SOURCES, nvcc_path

    out = os.path.join(os.path.dirname(os.path.abspath(path)),
                       os.path.basename(path) + ".so")
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out, path], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    fn = lib.blmac_combine_launch
    fn.argtypes = SOURCES["blmac_combine"][1]["blmac_combine_launch"]
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(here, "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--unpaired", action="store_true",
                    help="build the kernel's table without row pairs")
    ap.add_argument("--source", help="a variant of blmac_combine.cu to "
                    "compile and time in place of the tree's kernel")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_combine_fold: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler import compile_bank, cse_pass
    from repro_torch.core import po2_quantize_batch
    from repro_torch.filters import spread_lowpass_qbank, sweep_bank

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    dev = torch.device("cuda", 0)
    if args.source:
        bf._combine_library = lambda lib=variant_library(args.source): lib
    sweep_q, _ = po2_quantize_batch(sweep_bank(SWEEP_TAPS), 16)
    cases = {
        "serve": (spread_lowpass_qbank(SERVE_FILTERS, SERVE_TAPS), PUSH),
        "sweep": (sweep_q, SWEEP_SAMPLES - SWEEP_TAPS + 1),
    }
    rng = np.random.default_rng(0)
    rows = {}
    for name, (qbank, n_out) in cases.items():
        t0 = time.perf_counter()
        combine = cse_pass(compile_bank(qbank)).combine
        mine_s = time.perf_counter() - t0
        n_real, n_shared = combine.shape
        y_host = rng.integers(-(1 << 31), 1 << 31,
                              (n_real + n_shared, 1, n_out)).astype(np.int32)
        y0 = bf.bank_output(n_real + n_shared, 1, n_out, dev)
        y0.copy_(torch.as_tensor(y_host))
        table = bf.combine_table(combine, dev)
        if args.unpaired:  # built once per row groups, as layout() is
            table.layout = functools.lru_cache()(
                lambda g, t=table: bf.CombineLayout(
                    t.row_ptr, t.cols, t.coeffs, t.n_shared, g, t.wide,
                    pair=False).to(dev))
        t0 = time.perf_counter()
        got = bf.combine_fold(y0.clone(), table)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0  # the table's layout built too
        want = bf.combine_plain(y0, combine, n_real)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: the fold differs from combine_plain")
        sample = rng.choice(n_real, CHECK_ROWS, replace=False)
        exact = y_host[sample].astype(np.int64) + np.tensordot(
            combine[sample], y_host[n_real:].astype(np.int64), axes=1)
        if not np.array_equal(exact.astype(np.int32),
                              got.cpu().numpy()[sample]):
            raise RuntimeError(f"{name}: the fold differs from int64 numpy")
        del got, want
        y = y0.clone()
        fold = lambda y=y, table=table: bf.combine_fold(y, table)  # noqa: E731
        nnz = int(np.count_nonzero(combine))
        rows[name] = {"n_real": n_real, "n_shared": n_shared, "nonzeros": nnz,
                      "n_out": n_out, "mine_s": mine_s,
                      "first_call_s": first_s,
                      "ms": cuda_ms(fold), "device_us": queued_us(fold),
                      **fold_bound(n_real, n_shared, nnz, n_out),
                      "geometry": geometry(bf, table, n_out, dev)}
        rows[name]["device_share_of_bound"] = (
            rows[name]["bound_ms"] * 1e3 / rows[name]["device_us"])
        del y, y0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.abspath(args.src),
                      "source": args.source, "paired": not args.unpaired,
                      "fold": rows,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
