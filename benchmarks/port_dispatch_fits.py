#!/usr/bin/env python3
"""Fit the port's ``"cuda"`` cost-model lane several times on a GPU and
show the one-filter engine's plan under each fit.

    python3 benchmarks/port_dispatch_fits.py [--src DIR] [--fits N]

The engine is `chip_smoke.py`'s one-filter auto engine: one 127-tap
filter of the paper's §3.1 sweep bank (row 4,950, 263 pulses, 16-bit po2
quantization) over 2 channels.  Each fit is `calibrate_backend("cuda")`
run anew into a temporary cache directory; for each it records the
fitted per-launch constants of the bank kernel K1 (``call_us``) and the
specialized kernel K2 (``spec_call_us``), the engine's mode and every
candidate the planner weighed with its predicted µs.  Then K1
(`bank_apply`) and K2 (`specialized_call`) run at the shape the engine
plans for (2 channels × 2,048 samples, tile 512), each checked bit for
bit against the other and split into the host's and the device's µs a
call as the fit measures them (`_split_us`, the least of five batches of
50 calls queued behind a GPU spin).  ``--src`` picks the `src` directory
the port is imported from, so that two trees run by the same script in
one call.  Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

TAPS, ROW, CHANNELS, CHUNK, TILE = 127, 4950, 2, 2048, 512


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(here, "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--fits", type=int, default=5,
                    help="how many times to fit the lane")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("port_dispatch_fits: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler import clear_caches, compile_bank
    from repro_torch.core import po2_quantize_batch
    from repro_torch.core import costmodel as cm
    from repro_torch.filters import FilterBankEngine, sweep_bank
    from repro_torch.kernels.runtime import dispatch_candidates

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    dev = torch.device("cuda", 0)
    q, _ = po2_quantize_batch(sweep_bank(TAPS), 16)
    one = q[ROW][None]
    fits = []
    with tempfile.TemporaryDirectory() as cache:
        os.environ["REPRO_TORCH_CACHE_DIR"] = cache
        for _ in range(args.fits):
            clear_caches()
            t0 = time.perf_counter()
            cal = cm.calibrate_backend("cuda", dev)
            fit_s = time.perf_counter() - t0
            eng = FilterBankEngine(one, channels=CHANNELS, device=dev)
            fits.append({
                "fit_s": fit_s, "call_us": cal.call_us,
                "spec_call_us": cal.spec_call_us, "mode": eng.mode,
                "candidates": [
                    {"mode": p.mode, "bank_tile": p.bank_tile,
                     "predicted_us": p.predicted_us}
                    for p, _ in dispatch_candidates(
                        eng.program, CHANNELS, device=dev)]})

    prog = compile_bank(one)
    x = torch.randint(-128, 128, (CHANNELS, CHUNK + TAPS - 1),
                      dtype=torch.int32, device=dev)
    frames, n_out = bf.frame_signal_batch(x, TAPS, TILE)
    sp = bf.SpecializedProgram(prog.pulse_schedules(), TAPS, TILE, dev)
    terms = bf.bank_terms(prog.schedule(), TAPS, dev)
    k1 = bf.bank_apply(frames, terms, TILE, n_out)
    k2 = bf.specialized_call(frames, sp)
    k2 = k2[0].reshape(CHANNELS, -1)[:, :n_out]
    if not torch.equal(k1[0], k2):
        raise RuntimeError("K1 and K2 differ at the engine's shape")
    split = {}
    for name, fn in (
            ("k1", lambda: bf.bank_apply(frames, terms, TILE, n_out)),
            ("k2", lambda: bf.specialized_call(frames, sp))):
        host, device = cm._split_us(fn, 50, 5)
        split[name] = {"host_us": host, "device_us": device}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.abspath(args.src), "fits": fits,
                      "engine_shape": {"channels": CHANNELS,
                                       "samples": CHUNK, "tile": TILE},
                      "split_us": split,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
