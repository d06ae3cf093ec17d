#!/usr/bin/env python3
"""Time the port's pulse-specialized kernel (K2) at the specialized leg's
shapes on a GPU.

    python3 benchmarks/port_specialized_push.py [--src DIR] [--designs]

The shapes of `chip_smoke.py`'s specialized leg, all on 127-tap filters of
the paper's §3.1 sweep bank (16-bit po2 quantization) over 8-bit samples:

  * ``blmac_fir``  — one filter (263 pulses) over 2**20 samples, tile 1,024;
  * ``push_1x2``   — one engine push of the one-filter engine: the same
                     filter over 2 channels × 4,096 new samples (the
                     buffer with its 126-sample tail), tile 512;
  * ``push_8x2``   — one push of the 8-filter engine, 2 channels, tile 512.

Each is one `specialized_call` over frames built beforehand, checked
bit for bit against `specialized_plain` and timed two ways: CUDA events
around back-to-back calls (``ms``, the host's time a call included when
it is the longer) and events around calls queued behind a GPU spin
(``device_us``, the device alone).  ``--src`` picks the `src` directory
the port is imported from, so that two trees are timed by the same script
in one run.  ``--designs`` times every case on both of K2's designs (the
CUDA-core walk and the tensor cores, `specialized_route` overridden for
the timing, each checked against the plain version), adds one filter
over one channel of 2**12 … 2**20 outputs and the benchmark's
fir127.array64 block (64 channels × 2**20 samples), and gives each
case's own route.  Prints one JSON object with the times and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

TAPS, FIR_SAMPLES, PUSH, CHANNELS = 127, 1 << 20, 4096, 2


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


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(here, "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--designs", action="store_true",
                    help="time each case on both K2 designs, and more cases")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_specialized_push: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler import compile_bank
    from repro_torch.core import po2_quantize_batch
    from repro_torch.filters import sweep_bank

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    dev = torch.device("cuda", 0)
    q, _ = po2_quantize_batch(sweep_bank(TAPS), 16)
    one = q[4950][None]  # the specialized leg's filter
    eight = q[np.linspace(0, len(q) - 1, 8).astype(int)]
    rng = np.random.default_rng(0)
    cases = {
        "blmac_fir": (one, 1, FIR_SAMPLES, 1024),
        "push_1x2": (one, CHANNELS, PUSH + TAPS - 1, 512),
        "push_8x2": (eight, CHANNELS, PUSH + TAPS - 1, 512),
    }
    if args.designs:
        cases.update({f"one_2^{k}": (one, 1, (1 << k) + TAPS - 1, 512)
                      for k in range(12, 21)})
        cases["array64"] = (one, 64, FIR_SAMPLES, 1024)
    route, rule = bf.specialized_route, bf._route
    rows = {}
    for name, (bank, chans, n, tile) in cases.items():
        scheds = compile_bank(bank).pulse_schedules()
        x = torch.as_tensor(rng.integers(-128, 128, (chans, n)),
                            dtype=torch.int32, device=dev)
        n_pad = -(-n // tile) * tile  # the engine pads a push to a tile
        frames, _ = bf.frame_signal_batch(
            torch.nn.functional.pad(x, (0, n_pad - n)), TAPS, tile)
        prog = bf.SpecializedProgram(scheds, TAPS, tile, dev)
        want = torch.stack([bf.specialized_plain(frames, p, TAPS, tile)
                            for p in scheds])
        rows[name] = {"filters": len(scheds), "channels": chans,
                      "samples": n, "tile": tile,
                      "route": route(len(scheds), chans, frames.shape[1],
                                     tile, bf.sm_count(dev), TAPS)}
        for design in ("walk", "wgmma") if args.designs else (None,):
            if design is not None:  # the launch's rule, overridden
                bf._route = lambda outs, taps, d=design: d
            try:
                got = bf.specialized_call(frames, prog)
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name}: K2 ({design or 'route'}) "
                                       f"differs from its plain version")
                t = {"ms": cuda_ms(lambda: bf.specialized_call(frames, prog)),
                     "device_us": queued_us(
                         lambda: bf.specialized_call(frames, prog))}
            finally:
                bf._route = rule
            rows[name].update(t if design is None else {design: t})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.abspath(args.src), "k2": rows,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
