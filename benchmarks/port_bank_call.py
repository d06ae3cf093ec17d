#!/usr/bin/env python3
"""Time the port's whole `blmac_fir_bank` call at the sweep shape on a GPU.

    python3 benchmarks/port_bank_call.py [--src DIR]

The paper's §3.1 sweep bank (9,900 filters × 127 taps, 16-bit po2
quantization) over 1 channel × 16,384 8-bit samples, timed with CUDA
events (mean over back-to-back calls after a warm-up, as `chip_smoke.py`'s
``cuda_ms``) two ways: through `repro_torch.kernels.blmac_fir_bank`, the
entry point a user calls (the bank digested for the program cache on
every call), and through the kernel module's `blmac_fir_bank` with the
program's schedule in hand.  ``--src`` picks the `src` directory the
port is imported from, so that two trees of the port are timed by the
same script in one run.  Prints one JSON object with both times, the
bank kernel's launches a call, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

TAPS, SAMPLES, TILE = 127, 16384, 1024


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
    reps = max(3, min(200, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(here, "src"),
                    help="the src directory to import repro_torch from")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_bank_call: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler import compile_bank
    from repro_torch.core import po2_quantize_batch
    from repro_torch.filters import sweep_bank
    from repro_torch.kernels import blmac_fir_bank

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    dev = torch.device("cuda", 0)
    q, _ = po2_quantize_batch(sweep_bank(TAPS), 16)
    prog = compile_bank(q)
    sched = prog.schedule()
    x = torch.as_tensor(np.random.default_rng(0).integers(-128, 128,
                                                          (1, SAMPLES)),
                        dtype=torch.int32, device=dev)
    # the launch counter is `bank_apply.launches` (one launch a call) or,
    # in trees before it, `bank_call.launches` (one a populated group)
    counter = getattr(bf, "bank_apply", None) or bf.bank_call
    blmac_fir_bank(x, q)  # builds the kernel and the program's tables
    torch.cuda.synchronize()
    counter.launches = 0
    blmac_fir_bank(x, q)
    torch.cuda.synchronize()
    launches = counter.launches
    ops_ms = cuda_ms(lambda: blmac_fir_bank(x, q))
    module_ms = cuda_ms(lambda: bf.blmac_fir_bank(
        x, prog.packed, TAPS, TILE, fast_path=False, schedule=sched))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"src": args.src, "filters": len(q), "taps": TAPS,
                      "samples": SAMPLES, "ops_blmac_fir_bank_ms": ops_ms,
                      "module_blmac_fir_bank_ms": module_ms,
                      "bank_launches_per_call": launches,
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
