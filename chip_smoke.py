#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the four CUDA libraries from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (in parallel), then drives the port's paths through the entry
points a user calls, each leg with the kernels' launch counts zeroed just
before it and read just after:

  * serve       — `FilterBankEngine(mode="packed")` over the 256-filter
                  63-tap spread-lowpass bank, 1 channel, 32 pushes of
                  4,096 samples (the reference's ``--fir-bank`` serving
                  defaults); one K1 launch a push, counted push by push;
                  bit-exact against the plain CPU path and the numpy
                  oracle;
  * sweep       — `blmac_fir_bank` over the paper's 9,900-filter 127-tap
                  sweep bank (§3.1), 16-bit po2 quantization, 1 channel ×
                  16,384 samples; one K1 launch, the (B, C, n_out) result
                  written in the caller's order; bit-exact against the
                  plain version in full and the numpy oracle on 64
                  sampled rows;
  * specialized — `blmac_fir` on one 127-tap filter over 2**20 samples,
                  `FilterBankEngine(mode="specialized")` on 8 filters × 2
                  channels and the one-filter `FilterBankEngine` (auto mode)
                  on 2 channels, 8 pushes of 4,096 samples each; bit-exact
                  against the numpy oracle, one K2 launch a call and a push
                  (the auto engine must plan K2); prints K2's launch
                  geometry and outputs a thread (16, or 4 on the engines'
                  small grids), ``ptxas`` resources and the one-filter
                  engine's push time by host clock;
  * pulse_matmul — one qwen2.5-3b decoder layer at its published widths
                  (d_model 2048, 16 heads × 128, 2 KV heads, d_ff 11,008;
                  random normal weights, std 0.02, seed 0): `pulse_quantize`
                  of its seven projections on the card at P = 4 (bit for
                  bit the CPU quantizer on 64 columns of each and on edge
                  values), `pulse_matmul_op` on each at M = 4 (decode) and
                  M = 128 (prefill), each launch within 1e-5 relative of
                  float64 ``x @ pulse_dequantize`` and of the plain version;
                  then `quantize_param_tree` over the layer's leaves in the
                  reference's layout.  After the leg: the kernel's CUDA-core
                  route (groups whose exponent is below -112) on an edge
                  matrix, exact at x = I and within 1e-5 of the plain
                  version at both M; two launches of ``down`` at each M
                  compared with `torch.equal`; decode and prefill steps
                  (the 7 calls) under `torch.profiler`: launches counted
                  by the wrapper (7 a step), the kernels the trace saw
                  (K3's alone), and from that trace the device's idle
                  share of the traced steps' spans; and each of the 14
                  launches with its plan (tile,
                  blocks an SM, stages, splits of K, blocks), CUDA-event
                  time, device time (events around launches queued behind
                  a GPU spin), library time and bound.

  * cse         — the CSE pass on the host over the serve bank (seconds,
                  shared rows, nonzeros), then the serve leg's 32 pushes
                  through `FilterBankEngine(opt, mode="packed")` and
                  ``mode="specialized"``: bit-exact against the parent
                  engine and the numpy oracle, one K1 (or K2) launch and one
                  combine-fold launch a push, counted push by push; then the
                  sweep bank optimized (1,424 shared rows) through
                  `blmac_fir_bank` with its schedule in hand, K1 on the
                  augmented rows plus the fold, against the parent's call;
                  the fold held against `combine_plain` at both shapes and
                  on full-range samples whose sums wrap past 2**31, and
                  timed by events and by device time, with the kernel's
                  launch (span, row groups, staged KiB, blocks) and the
                  fitted cost model's price of it beside its measured
                  host and device µs;
  * dispatch    — the ``"cuda"`` cost-model lane fitted on the card
                  (`calibrate_backend`: its constants, the card's name they
                  are keyed on, the fit's seconds; fitted before the
                  specialized leg, whose one-filter auto engine must plan
                  K2), the plan and CSE verdict for 1, 16, 32 and 256
                  filters at 63 taps and for the sweep bank, the chosen
                  candidate's and the runner-up's predicted time beside
                  the time measured for each, and the filter count at which
                  K1 overtakes K2 at 63 taps, measured and predicted;
  * machine     — the paper's §4 accounting and `lower()` on the card:
                  Table 4 at full size (the sweep bank's mean
                  `machine_cycles`, its `fused_last_add` mean and the
                  vmachine's share of filters that do not fit the
                  256-code memory, equal to `machine_cycles_batch`, to the
                  vmachine's cycles and to ``BENCH_machine.json``'s
                  ``"100"`` grid, the paper's 231.6 beside them); then
                  `lower()`'s ``"scheduled"`` (K1) and ``"specialized"``
                  (K2, one launch for all filters) on the sweep bank, its
                  CSE-optimized program (plus one fold each), the serve
                  bank and one sweep filter, over 512 outputs of 8-bit
                  samples: tolerance 0 against ``"oracle"`` and
                  ``"vmachine"`` (with its fit mask), the scalar machine
                  on 4 sampled rows × 8 outputs and reject-parity on every
                  row the mask flags, the launches of every call counted;
                  its host seconds, and each lowered call at the sweep and
                  serve shapes timed by CUDA events and by host clock.

  * sharded     — the reference's serving path: the ``--fir-bank``
                  entry point (`repro_torch.launch.serve.serve_fir_bank`,
                  256 × 63, chunk 4,096, 32 chunks, `AsyncBankServer` at
                  depth 2) on the default mesh (1×1 on one card), every
                  chunk against the unsharded packed engine and the tail
                  against the oracle; the sweep bank through
                  `ShardedFilterBankEngine` on a (4, 2) mesh of the card's
                  slots (4 shards, time slices with the halo exchange) in
                  4 pushes of 4,096, joined and held against the sweep
                  leg's `blmac_fir_bank` result, then at the planner's
                  choice on an (8, 1) mesh; the serve bank at C = 4 on a
                  (2, 2) mesh, 2 bank shards × 2 channel groups, against
                  the oracle; 32 serve filters at C = 2 on a (2, 1) mesh,
                  2 specialized shards (one K2 launch each a push);
                  `lower(cse_pass(serve bank), "sharded")` on a (2, 1)
                  mesh, the fold launched once a call on the card; the
                  launcher as a user runs it (`python -m
                  repro_torch.launch.serve`, a fresh process) and the
                  loop cold and warm in one fresh process; chaos behind the
                  server (a (4, 1) mesh, integrity probe on, shard 1 killed
                  at chunk 3 and shard 0 at chunk 6, 8 chunks) against the
                  oracle with the fault counters equal to the kills.  For
                  each leg: pushes by CUDA events and host clock
                  (medians), the same pushes through the unsharded engine,
                  each shard alone (`time_shards`), the plan's
                  ``predicted_us`` beside the measured push, and the K1/K2
                  launches of every push against the plan.

Between them, with the serve leg's engine: its throughput, and its push
broken down into the engine's own steps, timed by CUDA events (the
chunk's upload, cat/pad/framing, the K1 launch, the device-to-host copy)
against the push's host clock.

Then each kernel is held against its plain PyTorch version on the card at
the main path's shapes (tolerance 0 for the FIR kernels, integer
arithmetic modulo 2**32; the reference's 1e-5 relative bound for the
pulse matmul) and timed with CUDA events beside its plain version, one
PyTorch library call computing the same function (`F.conv1d` in float64,
exact here; a float32 `torch.matmul` over the decoded weights) and its
bound on an H100 SXM (K1's by its output bytes or its adds at the int8
tensor-core rate, with the CUDA-core bounds it had before beside it; the
fold's by its bytes or its multiply-adds at the int32 rate, with no
library call: torch has no integer matmul on CUDA); the
whole sweep call, and K1 into a contiguous result, are timed too.
The cost model's calibration file goes to a temporary directory that is
removed at exit.  Prints one JSON object per phase, the
``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line; without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks the bounds are taken against (NVIDIA's data sheet and the
# Hopper white paper): HBM3 bandwidth, and the INT32 rate of the CUDA
# cores — 132 SMs × 64 INT32 lanes × 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2's bound counts adds, and the integer pipe's IADD3 adds three operands
# (two adds) in one instruction: the least time for N int32 adds is N / 2
# IADD3 at 64 lanes an SM a clock, i.e. N adds at twice the INT32 rate.
# (If a measured K2 ever reads below this, the rate is too low: raise it
# here and say why.)
INT32_ADDS_PER_S = 2 * INT32_OPS_PER_S
# dense int8 tensor-core rate of the H100 SXM, 1,979 TOP/s (data sheet): the
# bank kernel's bound by operations (its adds, done as int8 products)
INT8_TC_OPS_PER_S = 1979e12
# dense TF32 tensor-core rate of the H100 SXM, 494.7 TFLOP/s (data sheet),
# over 3: a 3xTF32 split, the cheapest tensor-core route that keeps float32
# accuracy — the pulse matmul's bound by operations
TF32X3_FLOPS_PER_S = 494.7e12 / 3

SERVE_FILTERS, SERVE_TAPS, SERVE_CHUNK, SERVE_CHUNKS = 256, 63, 4096, 32
DISPATCH_FILTERS = (1, 16, 32, 256)  # the plans printed, at SERVE_TAPS
CROSSOVER_FILTERS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
WRAP_CHECK_ROWS = 8
SWEEP_TAPS, SWEEP_SAMPLES, SWEEP_CHECK_ROWS = 127, 16384, 64
SPEC_SAMPLES = 1 << 20
SPEC_CHUNK, SPEC_PUSHES, SPEC_CHANNELS = 4096, 8, 2
OPS_TILE = 1024  # blmac_fir / blmac_fir_bank default signal tile

# one qwen2.5-3b decoder layer (src/repro/configs/qwen2_5_3b.py) as x @ W
# projections, (K, N); P = 4 is `examples/serve_lm.py`'s --planes default,
# M = 4 and 128 the decode and prefill rows of `launch/serve.py`'s
# --batch 4 --prompt-len 32 defaults
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF = 2048, 16, 2, 128, 11008
LAYER = {
    "wq": (D_MODEL, N_HEADS * HEAD_DIM), "wk": (D_MODEL, N_KV * HEAD_DIM),
    "wv": (D_MODEL, N_KV * HEAD_DIM), "wo": (N_HEADS * HEAD_DIM, D_MODEL),
    "gate": (D_MODEL, D_FF), "up": (D_MODEL, D_FF), "down": (D_FF, D_MODEL),
}
PLANES, DECODE_M, PREFILL_M = 4, 4, 128
REL_TOL = 1e-5  # the reference's bound, tests/test_kernels.py
K3_KERNEL = "blmac_pulse_matmul_kernel"
STEP_SPAN = "chip_smoke_step"  # record_function name of a profiled step
CPU_CHECK_COLS = 64


def check(ok: bool, what: str) -> None:
    """Fail the run (an exception, so a non-zero exit before the result
    line) when a phase's check does not hold; unlike ``assert``, never
    compiled away."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, target_ms: float = 200.0) -> float:
    """Mean milliseconds of ``fn`` on the device: CUDA events around a
    run of launches after a warm-up, enough of them to fill
    ``target_ms``."""
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


def queued_us(fn, reps: int = 20, spin_cycles: int = 4_000_000) -> float:
    """Mean device microseconds of ``fn``'s launches without the host's
    time a call: CUDA events around ``reps`` calls queued behind a GPU
    spin (``spin_cycles`` clocks, about 2 ms), so the card runs them back
    to back however slowly the host enqueues them."""
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


def max_abs_diff(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise RuntimeError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def plain_groups(frames, sched, taps: int, tile: int) -> list:
    """The bank kernel's plain version on the frames' device, group by
    group in the schedule's padded order: (rows, C, n_tiles, tile) each,
    zeros for an all-zero group."""
    import numpy as np
    import torch

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    out = []
    for g in sched.groups:
        op = torch.tensor(g.packed.view(np.int32), device=frames.device)
        out.append(bf.bank_call_plain(frames, op, taps, g.schedule,
                                      g.tail_shift, tile) if g.sel_layers
                   else torch.zeros((op.shape[0],) + tuple(frames.shape[:2])
                                    + (tile,), dtype=torch.int32,
                                    device=frames.device))
    return out


def bank_plain(frames, sched, taps: int, tile: int):
    """`plain_groups` reordered as the reference does (``y[inv]``): (B, C,
    n_tiles · tile) int32 in the caller's filter order."""
    import torch

    y = torch.cat(plain_groups(frames, sched, taps, tile))
    y = y.reshape(y.shape[0], frames.shape[0], -1)
    return y.index_select(0, torch.as_tensor(sched.inv, device=frames.device))


def serve_push_breakdown(eng, chunks) -> dict:
    """Where a packed engine push goes: the engine's own steps of
    `FilterBankEngine.push` (``_upload``: the chunk's copy to the card;
    ``_advance`` and ``_frame``: cat/tail/pad/framing; ``_run``: the one K1
    launch; the output's copy to the host), with CUDA events and the
    host's clock after each, over ``chunks`` (the first, whose buffer has
    no history yet, untimed); the median of each segment against the whole
    push by the host's clock, and the push itself timed alone on the same
    chunks.  Fails the run when the steps' output differs from the
    push's."""
    import statistics

    import numpy as np
    import torch

    names = ("h2d", "cat_pad_frame", "k1", "d2h")
    eng.reset()
    want = [eng.push(c) for c in chunks]
    push_ms = []
    eng.reset()
    for c in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.push(c)
        push_ms.append((time.perf_counter() - t0) * 1e3)
    eng.reset()
    ev_ms = {n: [] for n in names}
    host_ms = {n: [] for n in names}
    wall_ms = []
    for k, chunk in enumerate(chunks):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t = [time.perf_counter()]
        ev[0].record()
        c = eng._upload(chunk)
        ev[1].record()
        t.append(time.perf_counter())
        buf = eng._advance(c)
        check(buf is not None, f"push {k} still primes the engine")
        frames, n_out = eng._frame(buf)
        ev[2].record()
        t.append(time.perf_counter())
        y = eng._run(frames, n_out)
        ev[3].record()
        t.append(time.perf_counter())
        host = y.cpu().numpy()
        ev[4].record()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        check(np.array_equal(host, want[k]),
              f"push {k}: the steps differ from the engine's push")
        if k == 0:
            continue
        wall_ms.append((t[-1] - t[0]) * 1e3)
        for i, name in enumerate(names):
            ev_ms[name].append(ev[i].elapsed_time(ev[i + 1]))
            host_ms[name].append((t[i + 1] - t[i]) * 1e3)
    med = statistics.median
    wall = med(wall_ms)
    return {"pushes_timed": len(wall_ms), "chunk": chunks[0].shape[-1],
            "filters": eng.n_filters, "push_wall_ms_median": wall,
            "engine_push_ms_median": med(push_ms[1:]),
            "events_ms_median": {n: med(v) for n, v in ev_ms.items()},
            "host_ms_median": {n: med(v) for n, v in host_ms.items()},
            "events_share_of_wall": {n: med(v) / wall
                                     for n, v in ev_ms.items()},
            "output_bytes": int(want[-1].nbytes)}


def bound(ops: float, nbytes: float,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """Least time on an H100 SXM for ``ops`` operations at ``ops_per_s``
    (default: int32) and ``nbytes`` of device-memory traffic: the larger
    of the two."""
    ops_ms = ops / ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def conv1d_ms(x, qbank, n_out: int) -> float:
    """One PyTorch call computing the same bank output: `F.conv1d` in
    float64 over the integer taps (exact: every partial sum < 2**31 <
    2**53), timed as a yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xf = x.to(torch.float64).reshape(1, 1, -1)
    w = torch.as_tensor(qbank, dtype=torch.float64, device=x.device)[:, None]
    y = F.conv1d(xf, w)
    check(y.shape[-1] == n_out, "conv1d output length")
    del y
    return cuda_ms(lambda: F.conv1d(xf, w))


def rel_err(got, want) -> float:
    """max|got − want| / max|want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def edge_weights():
    """Powers of two, the next float64 above them, sign flips and 1.5×,
    in row 0 of a group; an all-zero group; a group of 2**-130."""
    import numpy as np

    vals = []
    for k in (2, 5, -7, 20, 0, -126, -127, -130, -149):
        b = 2.0 ** k
        vals += [b, np.nextafter(b, np.inf), -b, 1.5 * b]
    w = np.random.default_rng(1).standard_normal((96, len(vals) + 2)) * 0.02
    w[0, :len(vals)] = vals
    w[:, -1] = 2.0 ** -130
    w[:32, -2] = 0.0
    return w


def profile_step(fn, launches: int, launch_count, steps: int = 5,
                 reps: int = 20) -> dict:
    """A model step ``fn`` of ``launches`` kernel launches.  Its wall time
    on the host clock without the profiler (mean of ``reps`` steps, each
    ended by a synchronise), and ``steps`` steps traced by `torch.profiler`
    after one warm-up step it does not trace (the first step under a
    profiler runs slow), each in a `record_function` span that ends with a
    synchronise.  From that one trace: the steps' spans (host clock), the
    union of all their kernels' intervals (device busy), the device's idle
    share of the summed spans, and device time and count per kernel name.

    The share is taken over the steps together: the trace's device times
    can sit hundreds of µs off its host times, so a kernel cannot be
    placed in a step by its start time, and the trace has missed a kernel
    (69 seen for 70 launches, once in 14 runs), so it cannot be placed by
    its order either.  The launches are counted by the kernels' own
    wrapper (``launch_count()``), and the kernels the trace saw are
    reported beside them.  Fails the run when the wrapper counts another
    number of launches, the trace shows no kernel or more kernels than
    were launched in the traced steps, or the kernels were busy longer
    than the spans."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    wall_unprofiled_us = (time.perf_counter() - t0) * 1e6 / reps
    before = launch_count()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for i in range(1 + steps):
            with record_function(f"{STEP_SPAN}{i}"):
                fn()
                torch.cuda.synchronize()
            prof.step()
    made = launch_count() - before
    check(made == (1 + steps) * launches,
          f"{made} launches in {1 + steps} steps, want {launches} each")
    traced = steps * launches
    spans, kernels = [], []
    for e in prof.events():
        if e.name.startswith(STEP_SPAN):
            if e.device_type == DeviceType.CPU:
                spans.append(e.time_range.end - e.time_range.start)
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end, e.name))
    check(len(spans) == steps, f"{len(spans)} traced step spans, want "
                               f"{steps}")
    check(0 < len(kernels) <= traced,
          f"the trace shows {len(kernels)} kernels for {traced} launches")
    by_name: dict = {}
    busy, reach = 0.0, float("-inf")
    for k0, k1, name in sorted(kernels):
        row = by_name.setdefault(name, {"count": 0, "device_us": 0.0})
        row["count"] += 1
        row["device_us"] += k1 - k0
        busy += max(0.0, k1 - max(k0, reach))
        reach = max(reach, k1)
    span = sum(spans)
    check(busy <= span, f"kernels busy {busy} us in spans of {span} us")
    return {"wall_us_unprofiled": wall_unprofiled_us,
            "traced_steps": steps, "launches_traced": traced,
            "kernels_seen": len(kernels), "span_us_by_step": spans,
            "span_us_median": statistics.median(spans),
            "span_us_sum": span, "device_busy_us_sum": busy,
            "device_busy_us_per_step": busy / steps,
            "idle_share": 1.0 - busy / span, "kernels": by_name}


def subnormal_weights():
    """A (256, 160) matrix whose columns 0..15 are scaled by 2**-130 and
    32..47 by 2**-140: their groups' exponents fall below -112, so their
    steps take the kernel's CUDA-core route (their pulses reach below
    2**-136, which TF32 cannot hold); the rest std 0.02."""
    import numpy as np

    w = np.random.default_rng(2).standard_normal((256, 160)) * 0.02
    w[:, :16] *= 2.0 ** -130
    w[:, 32:48] *= 2.0 ** -140
    return w


def pulse_matmul_leg(dev, smi: str) -> dict:
    """The K3 path at qwen2.5-3b's widths (see the module notes); emits
    its phases and returns the kernel's row of the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.core.serve_quant import quantize_param_tree
    from repro_torch.kernels import (pulse_dequantize, pulse_matmul_op,
                                     pulse_quantize)
    from repro_torch.kernels.ref import pulse_decode_ref, pulse_matmul_ref

    bmm = importlib.import_module("repro_torch.kernels.blmac_matmul")
    torch.backends.cuda.matmul.allow_tf32 = False
    lrng = np.random.default_rng(0)
    host = {name: lrng.standard_normal(shape, dtype=np.float32) * 0.02
            for name, shape in LAYER.items()}
    weights = {name: torch.as_tensor(w, device=dev) for name, w in host.items()}
    xs = {(m, name): torch.as_tensor(
              lrng.standard_normal((m, LAYER[name][0]), dtype=np.float32),
              device=dev)
          for m in (DECODE_M, PREFILL_M) for name in LAYER}
    torch.cuda.synchronize()

    # -- the path: quantize on the card, then 7 launches per M -------------
    bmm.pulse_matmul.launches = 0
    t0 = time.perf_counter()
    quant = {name: pulse_quantize(w, PLANES) for name, w in weights.items()}
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    ys = {(m, name): pulse_matmul_op(x, *quant[name], PLANES)
          for (m, name), x in xs.items()}
    torch.cuda.synchronize()
    launches = bmm.pulse_matmul.launches
    check(launches == len(xs), f"pulse matmul launched {launches} times, "
                               f"want {len(xs)}")

    # -- the quantizer against the CPU's ------------------------------------
    for name, w in host.items():
        c_cpu, g_cpu = pulse_quantize(w[:, :CPU_CHECK_COLS], PLANES,
                                      device="cpu")
        codes, ge = quant[name]
        check(torch.equal(codes[:, :, :CPU_CHECK_COLS].cpu(), c_cpu)
              and torch.equal(ge[:, :CPU_CHECK_COLS].cpu(), g_cpu),
              f"device quantizer differs from the CPU's on {name}")
    edge = edge_weights()
    for planes in (1, 2, PLANES):
        c_gpu, g_gpu = pulse_quantize(edge, planes, device=dev)
        c_cpu, g_cpu = pulse_quantize(edge, planes, device="cpu")
        check(torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(g_gpu.cpu(), g_cpu),
              f"device quantizer differs from the CPU's on edge values, "
              f"P={planes}")
    # would the card's own float64 log2 give numpy's exponents?  (the
    # quantizer takes numpy's; this only records the answer)
    gmax = torch.as_tensor(np.abs(edge).reshape(3, 32, -1).max(axis=1))
    gmax = gmax[gmax > 0]
    log2_mismatch = int((torch.ceil(torch.log2(gmax.to(dev))).cpu().long()
                         != torch.as_tensor(np.ceil(np.log2(gmax.numpy())))
                         .long()).sum())
    emit({"phase": "pulse_quantize", "planes": PLANES,
          "matrices": {n: list(s) for n, s in LAYER.items()},
          "weights": sum(w.size for w in host.values()), "seconds": quant_s,
          "bit_exact_vs_cpu": True, "cpu_checked_columns": CPU_CHECK_COLS,
          "device_log2_exponent_mismatches_on_edges": log2_mismatch,
          "edge_groups": int(gmax.numel())})

    # -- every launch against float64 and the plain version -----------------
    errs = {}
    for (m, name), y in ys.items():
        codes, ge = quant[name]
        x = xs[(m, name)]
        e64 = rel_err(y, x.double() @ pulse_dequantize(codes, ge))
        eplain = rel_err(y, pulse_matmul_ref(x, codes, ge))
        check(e64 < REL_TOL and eplain < REL_TOL,
              f"pulse matmul {name} at M={m}: relative error {e64} vs "
              f"float64, {eplain} vs plain")
        errs[f"{name}@{m}"] = {"vs_float64": e64, "vs_plain": eplain}
    emit({"phase": "pulse_matmul", "planes": PLANES, "launches": launches,
          "launches_by_m": {DECODE_M: len(LAYER), PREFILL_M: len(LAYER)},
          "max_rel_err_vs_float64": max(e["vs_float64"] for e in errs.values()),
          "max_rel_err_vs_plain": max(e["vs_plain"] for e in errs.values()),
          "tolerance": REL_TOL, "rel_err": errs})

    # -- quantize_param_tree over the layer, in the reference's layout -----
    state = {
        "stage0/slot0/ffn/gate": weights["gate"][None],
        "stage0/slot0/ffn/up": weights["up"][None],
        "stage0/slot0/ffn/down": weights["down"][None],
        "stage0/slot0/mixer/wq":
            weights["wq"].reshape(1, D_MODEL, N_HEADS, HEAD_DIM),
        "stage0/slot0/mixer/wk": weights["wk"].reshape(1, D_MODEL, N_KV, HEAD_DIM),
        "stage0/slot0/mixer/wv": weights["wv"].reshape(1, D_MODEL, N_KV, HEAD_DIM),
        "stage0/slot0/mixer/wo":
            weights["wo"].reshape(1, N_HEADS, HEAD_DIM, D_MODEL),
        "stage0/slot0/mixer/bq": torch.zeros((1, N_HEADS, HEAD_DIM), device=dev),
        "stage0/slot0/mixer/bk": torch.zeros((1, N_KV, HEAD_DIM), device=dev),
        "stage0/slot0/mixer/bv": torch.zeros((1, N_KV, HEAD_DIM), device=dev),
        "stage0/slot0/norm1/scale": torch.ones((1, D_MODEL), device=dev),
        "stage0/slot0/norm2/scale": torch.ones((1, D_MODEL), device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qstate, stats = quantize_param_tree(state, PLANES)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    changed = sorted(k for k in state if not torch.equal(qstate[k], state[k]))
    check(stats["n_quantized"] == 4, f"quantize_param_tree: {stats}")
    check(torch.equal(qstate["stage0/slot0/ffn/down"][0],
                      pulse_dequantize(*quant["down"]).float()),
          "quantize_param_tree's down differs from the K3 path's decode")
    emit({"phase": "quantize_param_tree", "planes": PLANES, "seconds": tree_s,
          "leaves": len(state), "quantized": changed, "stats": stats,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    # -- the CUDA-core route: groups below 2**-112, on an edge matrix -------
    w_sub = subnormal_weights()
    c_sub, g_sub = pulse_quantize(w_sub, PLANES, device=dev)
    tiny_groups = int((g_sub < bmm.MIN_TENSOR_EXP).sum())
    check(tiny_groups > 0, "the edge matrix has no group below -112")
    dec_sub = pulse_decode_ref(c_sub, g_sub)
    eye = torch.eye(w_sub.shape[0], dtype=torch.float32, device=dev)
    sub_err = {}
    for m in (DECODE_M, PREFILL_M):
        got = torch.cat([bmm.pulse_matmul(eye[r:r + m], c_sub, g_sub, PLANES)
                         for r in range(0, w_sub.shape[0], m)])
        check(torch.equal(got, dec_sub),
              f"subnormal groups at M={m}: the decode is not exact")
        x_sub = torch.as_tensor(lrng.standard_normal(
            (m, w_sub.shape[0]), dtype=np.float32), device=dev)
        sub_err[m] = rel_err(bmm.pulse_matmul(x_sub, c_sub, g_sub, PLANES),
                             pulse_matmul_ref(x_sub, c_sub, g_sub))
        check(sub_err[m] < REL_TOL,
              f"subnormal groups at M={m}: relative error {sub_err[m]}")
    subnormal = {"shape": list(w_sub.shape), "groups_below_-112": tiny_groups,
                 "exact_at_identity": True, "rel_err_vs_plain": sub_err}

    # -- two launches of down at each M agree bit for bit ---------------------
    for m in (DECODE_M, PREFILL_M):
        codes, ge = quant["down"]
        first = bmm.pulse_matmul(xs[(m, "down")], codes, ge, PLANES)
        again = bmm.pulse_matmul(xs[(m, "down")], codes, ge, PLANES)
        check(torch.equal(first, again),
              f"two launches of down at M={m} differ")

    # -- each launch: plan, CUDA-event time, library, bound.  Timed before
    # any profiler runs: after one, the host's time a call grows ---------
    rows, calls = {}, {}
    for m in (DECODE_M, PREFILL_M):
        for name in LAYER:
            codes, ge = quant[name]
            x = xs[(m, name)]
            k_dim, n_dim = LAYER[name]
            w_dec = pulse_decode_ref(codes, ge)
            plain = pulse_matmul_ref(x, codes, ge)
            nbytes = (4 * m * k_dim + codes.numel() + ge.numel()
                      + 4 * m * n_dim)
            ops = 2 * m * k_dim * n_dim
            b_ms, b_by = bound(ops, nbytes, TF32X3_FLOPS_PER_S)
            plan = bmm.cuda_launch_plan(m, n_dim, k_dim, PLANES, bmm.GROUP,
                                        dev)
            key = f"{name}@{m}"
            calls[key] = (lambda x=x, codes=codes, ge=ge:
                          bmm.pulse_matmul(x, codes, ge, PLANES))
            rows[key] = {
                "shape": f"{name}: x ({m}, {k_dim}) @ W ({k_dim}, {n_dim}), "
                         f"P={PLANES}",
                "plan": dataclasses.asdict(plan),
                "max_abs_err": float((ys[(m, name)] - plain).abs().max()),
                "max_rel_err": errs[key]["vs_plain"],
                "ms": cuda_ms(calls[key]),
                "library_ms": cuda_ms(lambda: torch.matmul(x, w_dec)),
                "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
                "bytes": nbytes}
            if name == "down":
                rows[key]["plain_ms"] = cuda_ms(
                    lambda: pulse_matmul_ref(x, codes, ge))
    # -- one step of the layer at each M under the profiler ------------------
    profiles = {}
    for m in (DECODE_M, PREFILL_M):
        prof = profile_step(lambda m=m: [
            pulse_matmul_op(xs[(m, name)], *quant[name], PLANES)
            for name in LAYER], len(LAYER),
            lambda: bmm.pulse_matmul.launches)
        extra = sorted(name for name in prof["kernels"]
                       if K3_KERNEL not in name)
        check(not extra, f"a step at M={m} ran other kernels: {extra}")
        profiles[m] = prof

    # -- device time of each launch: CUDA events around launches queued
    # behind a spin (the profiler once missed a kernel of 70) -------------
    for key, fn in calls.items():
        rows[key]["device_us"] = queued_us(fn)
    sums = {m: {k: sum(rows[f"{name}@{m}"][k] for name in LAYER)
                for k in ("ms", "library_ms", "bound_ms", "device_us")}
            for m in (DECODE_M, PREFILL_M)}
    emit({"phase": "pulse_matmul_profile", "planes": PLANES,
          "steps": profiles, "launches": {
              k: {f: r[f] for f in ("plan", "ms", "device_us", "library_ms",
                                    "bound_ms", "bound_by")}
              for k, r in rows.items()},
          "seven_launch_sums": sums,
          "bit_identical_repeat": True, "subnormal_route_ran": True,
          "subnormal_route": subnormal,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    # the kernels line: measured numbers and the bound (plans stay above)
    rows = {k: {f: v for f, v in r.items() if f != "plan"}
            for k, r in rows.items()}
    prefill = rows[f"down@{PREFILL_M}"]
    return {"name": "blmac_pulse_matmul_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blmac_pulse_matmul.cu",
            "replaces": "src/repro/kernels/blmac_matmul.py:95",
            "replaces_function": "_pulse_matmul_kernel",
            "launches": launches,
            "launches_by_m": {DECODE_M: len(LAYER), PREFILL_M: len(LAYER)},
            **prefill, "kernel_ms": prefill["ms"],
            "decode_shape": rows[f"down@{DECODE_M}"],
            "other_shapes": {k: {f: r[f] for f in ("ms", "device_us",
                                                   "library_ms", "bound_ms",
                                                   "bound_by")}
                             for k, r in rows.items()
                             if not k.startswith("down")},
            "seven_launch_sums": sums, "subnormal_route_ran": True}


def fold_bound(n_real: int, n_shared: int, nnz: int, n_chan: int,
               n_out: int) -> tuple[float, str, int, int]:
    """The combine fold's least time: its bytes (each real row read and
    written, each shared row read, the table once) over HBM against its
    multiply-adds (one a nonzero an output) at the int32 rate."""
    nbytes = 4 * n_chan * n_out * (2 * n_real + n_shared) \
        + 4 * (n_real + 1) + 8 * nnz
    ops = nnz * n_chan * n_out
    return (*bound(ops, nbytes), ops, nbytes)


def candidate_call(program, plan, schedule, chunk: int, dev):
    """A callable that runs one dispatch the planner priced: ``plan`` on
    ``program`` over one channel of ``chunk`` outputs, with its tables
    built beforehand — K1 (`bank_schedule_apply`) or K2
    (`specialized_call`), then the fold for an optimized program."""
    import torch

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    taps = program.taps
    x = torch.randint(-128, 128, (1, chunk + taps - 1), dtype=torch.int32,
                      device=dev)
    frames, n_out = bf.frame_signal_batch(x, taps, plan.tile)
    table = (None if program.combine is None
             else bf.combine_table(program.combine, dev))
    if plan.mode == "scheduled":
        terms = bf.bank_terms(schedule, taps, dev)
        return lambda: bf.bank_schedule_apply(frames, schedule, taps,
                                              plan.tile, n_out, terms=terms,
                                              combine=table)
    sp = bf.SpecializedProgram(program.pulse_schedules(), taps, plan.tile, dev)

    def run():
        y = bf.specialized_call(frames, sp)
        y = y.reshape(y.shape[0], 1, -1)
        return y if table is None else bf.combine_fold(y, table)
    return run


def cse_leg(dev, smi, serve_prog, serve_q, chunks, parent_outs, sweep_prog,
            sweep_q, x_sweep, y_sweep, cal) -> dict:
    """The CSE path (see the module notes); emits its phase and returns
    the fold kernel's row of the ``kernels`` line.  ``cal`` is the fitted
    ``"cuda"`` lane, whose price of each fold is set beside the fold's
    host and device µs."""
    import numpy as np
    import torch

    from repro_torch.core.costmodel import _split_us, predict_combine_us

    from repro_torch.compiler import cse_pass
    from repro_torch.filters import FilterBankEngine, fir_bit_layers_batch

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    t0 = time.perf_counter()
    serve_opt = cse_pass(serve_prog)
    serve_mine_s = time.perf_counter() - t0
    check(serve_opt is not serve_prog, "the CSE pass declined the serve bank")
    engines = {mode: FilterBankEngine(serve_opt, channels=1, mode=mode,
                                      device=dev)
               for mode in ("packed", "specialized")}
    kernel_of = {"packed": bf.bank_apply, "specialized": bf.specialized_call}
    bf.reset_launch_counts()  # the path: 32 pushes through each engine
    per_push = {mode: [] for mode in engines}
    outs = {mode: [] for mode in engines}
    for c in chunks:
        for mode, e in engines.items():
            before = (kernel_of[mode].launches, bf.combine_fold.launches)
            outs[mode].append(e.push(c))
            per_push[mode].append((kernel_of[mode].launches - before[0],
                                   bf.combine_fold.launches - before[1]))
    path_launches = {"bank_apply": bf.bank_apply.launches,
                     "specialized_call": bf.specialized_call.launches,
                     "combine_fold": bf.combine_fold.launches}
    for mode in engines:
        check(per_push[mode] == [(1, 1)] * len(chunks),
              f"cse {mode}: launches a push (kernel, fold) {per_push[mode]}")
        check(all(np.array_equal(a, b)
                  for a, b in zip(outs[mode], parent_outs)),
              f"cse {mode} engine differs from the parent engine")
        last = outs[mode][-1]
        tail_in = np.concatenate(chunks, axis=1)[
            :, -(last.shape[2] + SERVE_TAPS - 1):]
        check(np.array_equal(last, fir_bit_layers_batch(tail_in, serve_q)),
              f"cse {mode}: the last push differs from the numpy oracle")

    # the sweep bank optimized, through blmac_fir_bank with its schedule
    t0 = time.perf_counter()
    sweep_opt = cse_pass(sweep_prog)
    sweep_mine_s = time.perf_counter() - t0
    check(sweep_opt is not sweep_prog, "the CSE pass declined the sweep bank")
    sweep_sched = sweep_opt.schedule()
    sweep_table = bf.combine_table(sweep_opt.combine, dev)

    def sweep_call():
        return bf.blmac_fir_bank(
            x_sweep, sweep_opt.packed, SWEEP_TAPS, OPS_TILE, fast_path=False,
            schedule=sweep_sched, combine=sweep_table,
            n_real=sweep_opt.n_real)

    bf.reset_launch_counts()
    y_opt = sweep_call()
    torch.cuda.synchronize()
    sweep_launches = (bf.bank_apply.launches, bf.combine_fold.launches)
    check(sweep_launches == (1, 1),
          f"optimized sweep call: (K1, fold) launches {sweep_launches}")
    check(torch.equal(y_opt, y_sweep),
          "the optimized sweep call differs from the parent's")
    path_launches["combine_fold"] += sweep_launches[1]
    path_launches["bank_apply"] += sweep_launches[0]
    del y_opt
    sweep_call_ms = cuda_ms(sweep_call)
    parent_sched = sweep_prog.schedule()
    parent_call_ms = cuda_ms(lambda: bf.blmac_fir_bank(
        x_sweep, sweep_prog.packed, SWEEP_TAPS, OPS_TILE, fast_path=False,
        schedule=parent_sched))

    # the fold against its plain version at both shapes, timed
    rows = {}
    for name, prog, x, tile, n_out in (
            ("serve", serve_opt, None, engines["packed"].tile, None),
            ("sweep", sweep_opt, x_sweep, OPS_TILE, None)):
        if x is None:  # one push of the serve leg
            x = torch.as_tensor(np.concatenate(chunks, axis=1)
                                [:, :SERVE_CHUNK + SERVE_TAPS - 1], device=dev)
            n_pad = -(-x.shape[1] // tile) * tile
            x = torch.nn.functional.pad(x, (0, n_pad - x.shape[1]))
            n_out = SERVE_CHUNK
        frames, n_all = bf.frame_signal_batch(x, prog.taps, tile)
        n_out = n_out or n_all
        terms = bf.bank_terms(prog.schedule(), prog.taps, dev)
        table = bf.combine_table(prog.combine, dev)
        y0 = bf.bank_apply(frames, terms, tile, n_out)  # before the fold
        want = bf.combine_plain(y0, prog.combine, prog.n_real)
        y = bf.bank_apply(frames, terms, tile, n_out)  # K1's buffer, again
        got = bf.combine_fold(y, table)
        err = max_abs_diff(got, want)
        check(err == 0, f"fold differs from combine_plain at {name}: {err}")
        # full-range samples: the sums wrap past 2**31
        y_wide = torch.randint(-(1 << 31), 1 << 31, tuple(y0.shape),
                               dtype=torch.int32, device=dev)
        want_wide = bf.combine_plain(y_wide, prog.combine, prog.n_real)
        got_wide = bf.combine_fold(y_wide.clone(), table)
        check(torch.equal(got_wide, want_wide),
              f"fold differs from combine_plain at {name}, full range")
        sample = np.random.default_rng(1).choice(prog.n_real, WRAP_CHECK_ROWS,
                                                 replace=False)
        yw = y_wide.cpu().numpy().astype(np.int64)
        exact = yw[sample] + np.tensordot(prog.combine[sample],
                                          yw[prog.n_real:], axes=1)
        check(np.array_equal(exact.astype(np.int32),
                             got_wide.cpu().numpy()[sample]),
              f"fold differs from int64 numpy at {name}, full range")
        wrapped = bool(np.abs(exact).max() >= 1 << 31)
        check(wrapped, f"the full-range case at {name} never wrapped")
        del y_wide, want_wide, got_wide
        nnz = table.nnz
        b_ms, b_by, ops, nbytes = fold_bound(prog.n_real, prog.n_shared, nnz,
                                             1, n_out)
        lay = table.layout(table.groups_for(1, n_out, bf.sm_count(dev)))
        fold = lambda y=y, table=table: bf.combine_fold(y, table)  # noqa: E731
        host_us, dev_us = _split_us(fold, 20)
        predicted = predict_combine_us(prog.n_real, prog.n_shared, 1, 1,
                                       n_out, cal=cal, nnz=nnz,
                                       entries=lay.entries)
        rows[name] = {
            "shape": f"{prog.n_real} real + {prog.n_shared} shared rows "
                     f"({nnz} nonzeros) x 1 channel x {n_out} samples",
            "max_abs_err": err, "wrap_checked": wrapped,
            "ms": cuda_ms(fold), "device_us": queued_us(fold),
            "plain_ms": cuda_ms(lambda y0=y0, prog=prog: bf.combine_plain(
                y0, prog.combine, prog.n_real)),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "library_ms": None,
            # the cost model's price of this fold (a caller that waits:
            # host + device) against the two measured as the fit does
            "model": {"predicted_us": predicted, "host_us": host_us,
                      "device_us": dev_us,
                      "error": predicted / (host_us + dev_us) - 1},
            # the launch: samples a block (T), real rows a group, shared
            # rows staged a block (KiB), blocks, threads a block
            "design": {"span": bf.COMBINE_SPAN, "groups": lay.n_groups,
                       "rows_a_group": -(-table.live_rows // lay.n_groups),
                       "staged_kib": lay.max_union * 4 * bf.COMBINE_SPAN
                       / 1024,
                       "blocks": -(-n_out // bf.COMBINE_SPAN) * lay.n_groups,
                       "threads": 32 * bf.COMBINE_WARPS,
                       "wide_entries": lay.wide}}
        del y, y0, want, got
    emit({"phase": "cse", "serve_mine_s": serve_mine_s,
          "serve": {"n_real": serve_opt.n_real,
                    "n_shared": serve_opt.n_shared,
                    "nonzeros": int(np.count_nonzero(serve_opt.combine)),
                    "pulses_parent": int(serve_prog.pulse_counts.sum()),
                    "pulses_optimized": int(serve_opt.pulse_counts.sum()),
                    "adds_parent": serve_prog.total_adds(),
                    "adds_optimized": serve_opt.total_adds()},
          "engine_launches_per_push": {m: per_push[m] for m in engines},
          "bit_exact_vs_parent_and_oracle": True,
          "sweep_mine_s": sweep_mine_s,
          "sweep": {"n_real": sweep_opt.n_real,
                    "n_shared": sweep_opt.n_shared,
                    "nonzeros": int(np.count_nonzero(sweep_opt.combine)),
                    "pulses_parent": int(sweep_prog.pulse_counts.sum()),
                    "pulses_optimized": int(sweep_opt.pulse_counts.sum()),
                    "launches_k1_fold": list(sweep_launches),
                    "optimized_call_ms": sweep_call_ms,
                    "parent_call_ms": parent_call_ms},
          "fold": rows, "path_launches": path_launches,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    serve_row = rows["serve"]
    return {"name": "blmac_combine_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blmac_combine.cu",
            "replaces": "src/repro/kernels/blmac_fir.py:633",
            "replaces_function": "_combine_shared (an XLA program, no "
                                 "Pallas kernel)",
            "launches": path_launches["combine_fold"],
            **rows["sweep"], "kernel_ms": rows["sweep"]["ms"],
            "serve_shape": serve_row,
            "library_note": "no PyTorch call computes it on CUDA: torch has "
                            "no integer matmul there"}


def dispatch_leg(dev, smi, cal, fit_s, sweep_prog) -> None:
    """The planner on the card (see the module notes); emits its phase.
    Measured times are taken as the fit takes its probes (`_split_us`):
    the host's µs a call and the device's, each the least over batches of
    calls queued behind a spin; a dispatch a caller waits for costs their
    sum, which is what the model predicts."""
    import torch

    from repro_torch.compiler import compile_bank, cse_pass
    from repro_torch.core.costmodel import (BankDispatchPlan, _split_us,
                                            calibration_path)
    from repro_torch.filters import spread_lowpass_qbank
    from repro_torch.kernels import autotune_bank_dispatch
    from repro_torch.kernels.runtime import DEFAULT_TILE, dispatch_candidates

    def measured(fn):
        host, device = _split_us(fn, 50)
        return {"host_us": host, "device_us": device,
                "measured_us": host + device}

    def plan_row(prog, chunk):
        opt = cse_pass(prog)
        plan, sched = autotune_bank_dispatch(opt, chunk_hint=chunk,
                                             device=dev)
        # the chosen candidate and the runner-up among every candidate of
        # the program and (for an optimized one) of its parent
        progs = [opt] + ([prog] if opt is not prog else [])
        cands = sorted(((p, c) for p in progs for c in dispatch_candidates(
            p, chunk_hint=chunk, device=dev)),
            key=lambda pc: pc[1][0].predicted_us)
        chosen = cands[0][1][0]
        check(chosen.predicted_us == plan.predicted_us
              and chosen.mode == plan.mode,
              f"the plan {plan} is not the cheapest candidate {chosen}")
        timed = []
        for p, (cplan, csched) in cands[:2]:
            timed.append({"program": "optimized" if p is opt and opt is not
                          prog else "parent",
                          **dataclasses.asdict(cplan),
                          **measured(candidate_call(p, cplan, csched, chunk,
                                                    dev))})
        return {"filters": prog.n_filters, "taps": prog.taps, "chunk": chunk,
                "plan": dataclasses.asdict(plan),
                "cse": plan.cse or "no sharing found",
                "n_shared": getattr(opt, "n_shared", 0),
                "chosen_and_runner_up": timed}

    plans = {}
    for b in DISPATCH_FILTERS:
        plans[f"{b}x{SERVE_TAPS}"] = plan_row(
            compile_bank(spread_lowpass_qbank(b, SERVE_TAPS)), SERVE_CHUNK)
    plans["sweep"] = plan_row(sweep_prog, SWEEP_SAMPLES)

    # where K1 overtakes K2 at 63 taps: both kernels timed on each bank
    # (K2 priced and run past the planner's SPECIALIZE_BANK_MAX too)
    n_tiles = -(-SERVE_CHUNK // DEFAULT_TILE)
    crossover = []
    for b in CROSSOVER_FILTERS:
        prog = compile_bank(spread_lowpass_qbank(b, SERVE_TAPS))
        k1, k1_sched = next(c for c in dispatch_candidates(
            prog, chunk_hint=SERVE_CHUNK, device=dev)
            if c[0].mode == "scheduled")
        k2 = BankDispatchPlan(
            "specialized", DEFAULT_TILE, 1, 1, prog.predict_specialized_us(
                1, n_tiles, cal=cal, tile=DEFAULT_TILE), cal.lane)
        row = {"filters": b}
        for mode, p, sched in (("k1", k1, k1_sched), ("k2", k2, None)):
            row[mode] = {"predicted_us": p.predicted_us,
                         **measured(candidate_call(prog, p, sched,
                                                   SERVE_CHUNK, dev))}
        crossover.append(row)

    def first(kind):
        return next((r["filters"] for r in crossover
                     if r["k1"][kind] < r["k2"][kind]), None)

    emit({"phase": "dispatch", "lane": cal.lane,
          "constants": dataclasses.asdict(cal), "keyed_on": cal.device_name,
          "fit_s": fit_s, "calibration_file": os.path.basename(
              calibration_path()),
          "plans": plans, "k1_k2_at_63_taps": crossover,
          "k1_overtakes_k2_at_filters": {"measured": first("measured_us"),
                                         "device": first("device_us"),
                                         "predicted": first("predicted_us")},
          "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi})


MACHINE_OUT = 512  # outputs a channel of the machine phase's lowered calls
MACHINE_SCALAR_FILTERS, MACHINE_SCALAR_OUTPUTS = 4, 8
PAPER_MEAN_CYCLES = 231.6  # §4, the paper's mean over its 127-tap bank


def host_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds of ``fn`` (a lowered call ends in a copy to
    the host, so it returns with the device done), after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def machine_leg(dev, smi, sweep_prog, serve_prog) -> dict:
    """The §4 machine model and `lower()` on the card (see the module
    notes); emits the ``machine`` phase and returns the kernels' launches
    counted over its lowered calls."""
    import numpy as np
    import torch

    from repro_torch.compiler import compile_bank, cse_pass, lower
    from repro_torch.core import (FirBlmacMachine, MachineSpec,
                                  machine_cycles_batch)

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(19)

    # -- Table 4 at the paper's size: the sweep bank's cycles and fit share
    cycles = sweep_prog.machine_cycles()  # the paper's spec at 127 taps
    fused = sweep_prog.machine_cycles(
        MachineSpec(taps=sweep_prog.taps, fused_last_add=True))
    check(np.array_equal(cycles, machine_cycles_batch(sweep_prog.qbank))
          and np.array_equal(fused, machine_cycles_batch(
              sweep_prog.qbank, fused_last_add=True)),
          "machine_cycles differs from machine_cycles_batch")
    with open(os.path.join(HERE, "BENCH_machine.json")) as f:
        committed = json.load(f)["grids"]["100"]
    table4 = {"filters": int(sweep_prog.n_filters),
              "mean_cycles": float(cycles.mean()),
              "fused_mean_cycles": float(fused.mean()),
              "paper_mean_cycles": PAPER_MEAN_CYCLES}

    cases = {"sweep": sweep_prog, "sweep_cse": cse_pass(sweep_prog),
             "serve": serve_prog,
             # the specialized leg's filter, a bandpass of the sweep bank
             "one_filter": compile_bank(
                 sweep_prog.qbank[sweep_prog.n_filters // 2][None])}
    check(cases["sweep_cse"] is not sweep_prog,
          "the CSE pass declined the sweep bank")
    launches = {"bank_apply": 0, "specialized_call": 0, "combine_fold": 0}
    rows, signals, oracles, lowered = {}, {}, {}, {}
    for name, prog in cases.items():
        row = {"filters": prog.out_filters, "rows": prog.n_filters,
               "taps": prog.taps, "outputs": MACHINE_OUT}
        t0 = time.perf_counter()
        # an optimized program runs its parent's signal against the
        # parent's oracle (its effective coefficients are the parent's)
        parent = prog if prog.combine is None else prog.parent
        if parent.key not in oracles:
            signals[parent.key] = rng.integers(
                -128, 128, prog.taps - 1 + MACHINE_OUT)
            oracles[parent.key] = lower(parent, "oracle")(
                signals[parent.key])
        x, oracle = signals[parent.key], oracles[parent.key]
        if prog.combine is not None:
            check(np.array_equal(prog.effective_qbank(), parent.qbank),
                  f"{name}: effective_qbank differs from the parent's")
        row["oracle_s"] = time.perf_counter() - t0

        # the vmachine: outputs (folded exactly for an optimized program),
        # fit mask and cycles
        t0 = time.perf_counter()
        vlow = lower(prog, "vmachine")
        vm, fits = vlow.vmachine, vlow.fits
        y_vm = vlow(x)
        check(np.array_equal(y_vm, oracle),
              f"{name}: vmachine differs from the oracle")
        vcycles = vm.run(x[:prog.taps]).cycles[:, 0]
        if prog.combine is None:
            check(np.array_equal(prog.machine_cycles(), vcycles)
                  and np.array_equal(vcycles,
                                     machine_cycles_batch(prog.qbank)),
                  f"{name}: machine_cycles, machine_cycles_batch and the "
                  f"vmachine differ")
        else:
            check(np.array_equal(prog.machine_cycles(),
                                 vcycles[:prog.n_real] + prog.use_counts)
                  and np.array_equal(prog.shared_cycles(),
                                     vcycles[prog.n_real:]),
                  f"{name}: machine_cycles/shared_cycles differ from the "
                  f"widened vmachine")
        row["vmachine_s"] = time.perf_counter() - t0
        row["fits"] = int(fits.sum())
        row["not_fitting_pct"] = float(100 * (~fits).mean())
        row["mean_cycles"] = float(prog.machine_cycles().mean())

        # the scalar machine: sampled rows and outputs, and reject-parity
        # on every row the fit mask flags (same spec as the vmachine's)
        t0 = time.perf_counter()
        sample = rng.choice(prog.n_filters,
                            min(MACHINE_SCALAR_FILTERS, prog.n_filters),
                            replace=False)
        xs = x[:prog.taps - 1 + MACHINE_SCALAR_OUTPUTS]
        vres = vm.run(xs)
        replayed = 0
        for b in sample:
            m = FirBlmacMachine(vm.spec)
            try:
                m.program(prog.qbank[b])
            except ValueError:
                check(not fits[b], f"{name}: scalar rejected row {b}, the "
                                   f"vmachine fit it")
                continue
            check(bool(fits[b]), f"{name}: the vmachine rejected row {b}, "
                                 f"the scalar machine programmed it")
            res = m.run(xs)
            check(np.array_equal(res.outputs, vres.outputs[b])
                  and np.array_equal(res.cycles, vres.cycles[b]),
                  f"{name}: scalar machine differs from the vmachine "
                  f"(row {b})")
            replayed += 1
        for b in np.nonzero(~fits)[0]:
            try:
                FirBlmacMachine(vm.spec).program(prog.qbank[b])
            except ValueError:
                continue
            check(False, f"{name}: the vmachine flags row {b}, the scalar "
                         f"machine programmed it")
        row["scalar_replayed"] = replayed
        row["scalar_rejected"] = int((~fits).sum())
        row["scalar_s"] = time.perf_counter() - t0

        # K1 and K2 through lower(): one launch each, one fold with a
        # combine, tolerance 0 against the oracle and the vmachine
        for backend, kernel in (("scheduled", "bank_apply"),
                                ("specialized", "specialized_call")):
            low = lowered[name, backend] = lower(prog, backend, device=dev)
            bf.reset_launch_counts()
            y = low(x)
            got = {k: getattr(bf, k).launches for k in launches}
            want = {k: 0 for k in launches}
            want[kernel] = 1
            want["combine_fold"] = int(prog.combine is not None)
            check(got == want, f"{name} {backend}: launches {got}, want "
                               f"{want}")
            for k in launches:
                launches[k] += got[k]
            err = int(np.abs(y.astype(np.int64) - oracle).max())
            check(err == 0 and y.dtype == np.int32
                  and y.shape == oracle.shape
                  and np.array_equal(y, y_vm),
                  f"{name} {backend}: differs from the oracle by {err} "
                  f"or from the vmachine")
            row[backend] = {"launches": got, "max_abs_err": err}
        rows[name] = row

    # Table 4's fit share is the vmachine's over the sweep bank; the
    # counts are deterministic, so they equal the committed baseline
    table4["not_fitting_pct"] = rows["sweep"]["not_fitting_pct"]
    for key, ref in (("mean_cycles", "mean_cycles_all"),
                     ("fused_mean_cycles", "fused_mean_cycles_all"),
                     ("not_fitting_pct", "pct_not_fitting")):
        check(abs(table4[key] - committed[ref]) < 1e-9,
              f"Table 4: {key} {table4[key]} differs from "
              f"BENCH_machine.json's {committed[ref]}")
    table4["paper_rel_err"] = table4["mean_cycles"] / PAPER_MEAN_CYCLES - 1
    host_s = time.perf_counter() - t_phase

    # timings (reported, not claimed): each lowered call by CUDA events and
    # by the host's clock, at the sweep and serve shapes
    timings = {}
    for name in ("sweep", "sweep_cse", "serve"):
        prog = cases[name]
        parent = prog if prog.combine is None else prog.parent
        x = signals[parent.key]
        for backend in ("scheduled", "specialized"):
            low = lowered[name, backend]
            timings[f"{name}/{backend}"] = {
                "cuda_event_ms": cuda_ms(lambda: low(x)),
                "host_ms": host_ms(lambda: low(x))}
    emit({"phase": "machine", "table4": table4, "host_s": host_s,
          "cases": rows, "lowered_call_ms": timings, "launches": launches,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return launches


# the sharded phase (the reference's `--fir-bank` serving path)
SHARDED_CHANNELS, SHARDED_CHANNEL_PUSHES = 4, 2
NARROW_FILTERS, NARROW_CHANNELS = 32, 2  # K2's shards: SPECIALIZE_BANK_MAX
CHAOS_CHUNKS, CHAOS_KILLS = 8, ((1, 3), (0, 6))
SWEEP_PUSH = 4096


def plan_summary(plan) -> dict:
    """A `ShardedBankPlan` as JSON: its mesh use, critical-path
    prediction and each shard's mode, tile and predicted µs."""
    return {"n_bank_shards": plan.n_bank_shards, "n_data": plan.n_data,
            "data_mode": plan.data_mode, "predicted_us": plan.predicted_us,
            "cse": plan.cse,
            "shards": [{"mode": p.mode, "tile": p.tile,
                        "bank_tile": p.bank_tile, "lane": p.lane,
                        "predicted_us": p.predicted_us}
                       for p in plan.shard_plans]}


def plan_launches(eng) -> tuple[int, int]:
    """K1 and K2 launches a push of a sharded engine makes by its plan:
    one K1 launch a data slot of each scheduled shard, one K2 launch for
    each specialized shard."""
    modes = [p.mode for p in eng.plan.shard_plans]
    return modes.count("scheduled") * eng.n_data, modes.count("specialized")


def push_times(eng, chunks, want) -> dict:
    """Each push of ``chunks`` through ``eng`` (reset first) timed by CUDA
    events around the push and its copy back and by the host's clock; for
    an engine with ``push_async`` also the host's time of the dispatch
    and of ``result()`` (copy back and reassembly) apart; and the K1/K2
    launches of every push.  Each output is held against ``want`` and
    dropped, as a streaming caller consumes it (kept outputs would time
    the host's first touch of fresh pages instead)."""
    import numpy as np
    import torch

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    eng.reset()
    torch.cuda.synchronize()
    rec = {k: [] for k in ("events_ms", "host_ms", "dispatch_ms",
                           "result_ms", "k1", "k2")}
    for c, w in zip(chunks, want):
        b1, b2 = bf.bank_apply.launches, bf.specialized_call.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        if hasattr(eng, "push_async"):
            pending = eng.push_async(c)
            t1 = time.perf_counter()
            out = pending.result()
            rec["dispatch_ms"].append((t1 - t0) * 1e3)
            rec["result_ms"].append((time.perf_counter() - t1) * 1e3)
        else:
            out = eng.push(c)
        end.record()
        torch.cuda.synchronize()
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["events_ms"].append(start.elapsed_time(end))
        rec["k1"].append(bf.bank_apply.launches - b1)
        rec["k2"].append(bf.specialized_call.launches - b2)
        check(np.array_equal(out, w), f"a push of {type(eng).__name__} "
                                      f"differs from the unsharded engine")
        del out
    return rec


def sharded_numbers(eng, chunks, unsharded, smi) -> dict:
    """The numbers the sharded phase reports for one leg, the sharded and
    the unsharded engine in turns (unsharded, sharded, sharded,
    unsharded) over the same pushes, every output held against the
    unsharded engine's: medians by CUDA events and host clock, the
    sharded push split into dispatch and ``result()``, its plan's
    prediction beside the measured median, each shard alone
    (`time_shards`), and the launches a push against the plan (a mismatch
    fails the run)."""
    import statistics

    unsharded.reset()
    want = [unsharded.push(c) for c in chunks]
    turns = [(name, push_times(e, chunks, want)) for name, e in (
        ("unsharded", unsharded), ("sharded", eng), ("sharded", eng),
        ("unsharded", unsharded))]
    del want
    plan = plan_launches(eng)
    got = [g for name, rec in turns if name == "sharded"
           for g in zip(rec["k1"], rec["k2"])]
    check(all(g == plan for g in got),
          f"launches a push {got}, the plan gives {plan} ({eng.describe()})")

    def median(name, key):
        return statistics.median(v for n, rec in turns if n == name
                                 for v in rec[key])

    measured_us = median("sharded", "events_ms") * 1e3
    return {
        "describe": eng.describe(), "plan": plan_summary(eng.plan),
        "push_ms_events_median": median("sharded", "events_ms"),
        "push_ms_host_median": median("sharded", "host_ms"),
        "dispatch_ms_host_median": median("sharded", "dispatch_ms"),
        "result_ms_host_median": median("sharded", "result_ms"),
        "unsharded_push_ms_events_median": median("unsharded", "events_ms"),
        "unsharded_push_ms_host_median": median("unsharded", "host_ms"),
        "turns_events_ms_median": [[name, statistics.median(rec["events_ms"])]
                                   for name, rec in turns],
        "predicted_us": eng.plan.predicted_us, "measured_us": measured_us,
        "model_rel_err": eng.plan.predicted_us / measured_us - 1,
        "time_shards_ms": (eng.time_shards(chunks[-1]) * 1e3).tolist(),
        "k1_k2_per_push": list(plan), "pushes": len(chunks),
        "nvidia_smi": smi}


SERVE_ARGV = ["--fir-bank", str(SERVE_FILTERS), "--taps", str(SERVE_TAPS),
              "--chunk", str(SERVE_CHUNK), "--chunks", str(SERVE_CHUNKS)]
# the launcher's loop twice in one fresh process, each resolved chunk's
# arrival on the host clock and the garbage collector's passes during
# the call (all counted by generation; each of generation 2 or of 1 ms or
# more as [start ms, ms, generation]): the first run pays the process's
# first launches, allocations and copies; the loop is the last
# ``seconds`` before the last arrival
COLD_WARM = """
import gc, json, sys, time
from repro_torch.launch.serve import parser, serve_fir_bank
args = parser().parse_args(sys.argv[1:])
runs, gcs = [], []

def on_gc(phase, info):
    if phase == "start":
        gcs.append([time.perf_counter(), 0.0, info["generation"]])
    else:
        gcs[-1][1] = (time.perf_counter() - gcs[-1][0]) * 1e3

gc.callbacks.append(on_gc)
for _ in range(2):
    marks, gcs[:] = [], []
    t0 = time.perf_counter()
    run = serve_fir_bank(args, consume=lambda out: marks.append(
        time.perf_counter()))
    runs.append({"seconds": run.seconds, "call_s": time.perf_counter() - t0,
                 "filter_samples_per_s": run.samples * args.fir_bank
                 / run.seconds,
                 "arrival_ms": [(m - t0) * 1e3 for m in marks],
                 "arrival_gaps_ms": [(b - a) * 1e3
                                     for a, b in zip(marks, marks[1:])],
                 "to_first_arrival_ms": (marks[0] - t0) * 1e3,
                 "gc_passes_by_generation": [
                     sum(g[2] == n for g in gcs) for n in range(3)],
                 "gc_long_passes": [[(g[0] - t0) * 1e3, g[1], g[2]]
                                    for g in gcs
                                    if g[2] == 2 or g[1] >= 1.0]})
print("COLD_WARM " + json.dumps(runs))
"""


def fresh_launcher() -> dict:
    """The ``--fir-bank`` launcher at the serving defaults in fresh
    processes on the card: as a user runs it (its printed aggregate
    rate), and the loop cold then warm in one process (`COLD_WARM`)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    def run(argv):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable] + argv, env=env, cwd=HERE,
                             capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"{argv[:2]} exited {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        return res.stdout, time.perf_counter() - t0

    out, wall = run(["-m", "repro_torch.launch.serve"] + SERVE_ARGV)
    rate = [ln for ln in out.splitlines() if "filter-samples/s" in ln]
    check(len(rate) == 1 and "tail chunk bit-exact" in out,
          f"the launcher printed {out[-2000:]}")
    cw, _ = run(["-c", COLD_WARM] + SERVE_ARGV)
    runs = json.loads(cw.split("COLD_WARM ", 1)[1])
    return {"launcher_line": rate[0],
            "launcher_filter_samples_per_s": float(
                rate[0].split(", ")[-1].split()[0]),
            "launcher_process_wall_s": wall,
            "cold": runs[0], "warm": runs[1]}


def sharded_leg(dev, smi, serve_prog, sweep_prog, x_sweep, y_sweep) -> dict:
    """The ``sharded`` phase: the reference's serving path, bit for bit.

    (1) the ``--fir-bank`` entry point (`serve_fir_bank`, 256 × 63, chunk
    4,096, 32 chunks, depth 2) on the default mesh, every chunk against
    the unsharded packed engine; (2) the sweep bank through a (4, 2) mesh
    of the card's slots (4 shards, time slices with the halo exchange) in
    4 pushes of 4,096, joined against the sweep leg's `blmac_fir_bank`
    result, then on an (8, 1) mesh at the planner's choice; (3) the serve
    bank at C = 4 on a (2, 2) mesh (2 shards × 2 channel groups) against
    the numpy oracle; (3b) 32 serve filters at C = 2 on a (2, 1) mesh, 2
    specialized shards; (3c) a CSE program lowered to the sharded backend,
    its fold on the card; (4) chaos behind `AsyncBankServer`: two shards
    of a (4, 1) mesh killed,
    the stream against the oracle, the fault counters against the kills.
    Each leg's launches are counted with the counts zeroed just before it;
    returns them by leg."""
    import numpy as np
    import torch

    from repro_torch.compiler import cse_pass, lower
    from repro_torch.distributed import FaultInjector, bank_mesh
    from repro_torch.filters import FilterBankEngine, ShardedFilterBankEngine
    from repro_torch.launch.serve import parser, serve_fir_bank
    from repro_torch.serving import AsyncBankServer

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    launches = {}

    def counted(name, fn):
        bf.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {"bank_apply": bf.bank_apply.launches,
                          "specialized_call": bf.specialized_call.launches,
                          "combine_fold": bf.combine_fold.launches}
        return out

    def slots(n_bank, n_data):
        return bank_mesh(n_bank, n_data, devices=[dev] * (n_bank * n_data))

    # -- (1) the entry point at the reference's serving defaults: every
    # chunk held against the unsharded engine's as it resolves ------------
    args = parser().parse_args(SERVE_ARGV + ["--depth", "2",
                                             "--device", "cuda"])
    stream = np.random.default_rng(0).integers(
        -128, 128, (1, SERVE_CHUNK * SERVE_CHUNKS)).astype(np.int32)
    chunks = [stream[:, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK]
              for k in range(SERVE_CHUNKS)]
    plain = FilterBankEngine(serve_prog, channels=1, mode="packed",
                             device=dev)
    expect = [plain.push(c) for c in chunks]
    seen = []

    def against_unsharded(out):
        seen.append(np.array_equal(out, expect[len(seen)]))

    run = counted("entry_point",
                  lambda: serve_fir_bank(args, consume=against_unsharded))
    del expect
    check(np.array_equal(run.stream, stream), "the launcher served another "
                                              "stream")
    check(seen == [True] * SERVE_CHUNKS,
          f"the entry point's chunks against the unsharded engine: {seen}")
    eng = run.engine
    check(eng.program.key == serve_prog.key, "the launcher compiled "
                                             "another bank")
    k1_push, k2_push = plan_launches(eng)
    check(launches["entry_point"]["bank_apply"] == SERVE_CHUNKS * k1_push
          and launches["entry_point"]["specialized_call"]
          == SERVE_CHUNKS * k2_push,
          f"entry point: launches {launches['entry_point']} for "
          f"{SERVE_CHUNKS} chunks of ({k1_push}, {k2_push})")
    check(run.server.chunks_out == SERVE_CHUNKS
          and run.server.failed_chunks == 0, "the server dropped chunks")
    # the serving loop alone, timed: no consumer, as the launcher runs it
    timed = serve_fir_bank(args)
    legs = {"entry_point": {
        "filter_samples_per_s": timed.samples * SERVE_FILTERS / timed.seconds,
        "wall_s": timed.seconds, "checked_run_wall_s": run.seconds,
        "fresh_process": fresh_launcher(),
        "k1_launches_per_chunk":
            launches["entry_point"]["bank_apply"] / SERVE_CHUNKS,
        **sharded_numbers(eng, chunks, plain, smi)}}

    # -- (2) full width: the sweep bank on a (4, 2) mesh, then (8, 1) -------
    xs = x_sweep.cpu().numpy()
    sweep_chunks = [xs[:, k:k + SWEEP_PUSH]
                    for k in range(0, xs.shape[1], SWEEP_PUSH)]
    want = y_sweep.cpu().numpy()
    sweep_plain = FilterBankEngine(sweep_prog, channels=1, mode="packed",
                                   device=dev)
    for name, mesh, kw in (
            ("sweep_4x2_time", slots(4, 2),
             dict(n_bank_shards=4, data_mode="time")),
            ("sweep_8x1_planned", slots(8, 1), {})):
        t0 = time.perf_counter()
        seng = ShardedFilterBankEngine(sweep_prog, mesh=mesh,
                                       chunk_hint=SWEEP_PUSH, **kw)
        build_s = time.perf_counter() - t0
        outs = counted(name, lambda: [seng.push(c) for c in sweep_chunks])
        got = np.concatenate(outs, axis=2)
        check(np.array_equal(got, want),
              f"{name}: the sharded sweep differs from blmac_fir_bank")
        del got, outs
        check(launches[name]["bank_apply"] == len(sweep_chunks)
              * plan_launches(seng)[0], f"{name}: {launches[name]}")
        legs[name] = {"build_s": build_s,
                      **sharded_numbers(seng, sweep_chunks, sweep_plain, smi)}
    if legs["sweep_4x2_time"]["plan"]["data_mode"] != "time":
        check(False, "the (4, 2) sweep mesh did not slice time")
    del want

    # -- (3) channel sharding: C = 4 on a (2, 2) mesh, 2 bank shards × 2
    # channel groups (4 K1 launches a push) ---------------------------------
    rng = np.random.default_rng(20)
    xc = rng.integers(-128, 128, (SHARDED_CHANNELS,
                                  SHARDED_CHANNEL_PUSHES * SERVE_CHUNK)) \
        .astype(np.int32)
    cchunks = [xc[:, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK]
               for k in range(SHARDED_CHANNEL_PUSHES)]
    ceng = ShardedFilterBankEngine(serve_prog, channels=SHARDED_CHANNELS,
                                   mesh=slots(2, 2), n_bank_shards=2,
                                   data_mode="channels",
                                   chunk_hint=SERVE_CHUNK)
    check(ceng.data_mode == "channels" and ceng.n_bank_shards == 2,
          f"the channel mesh is not used: {ceng.describe()}")
    couts = counted("channels_2x2", lambda: [ceng.push(c) for c in cchunks])
    check(np.array_equal(np.concatenate(couts, axis=2),
                         lower(serve_prog, "oracle")(xc)),
          "the channel-sharded stream differs from the numpy oracle")
    check(launches["channels_2x2"]["bank_apply"]
          == len(cchunks) * plan_launches(ceng)[0],
          f"channels: {launches['channels_2x2']}")
    legs["channels_2x2"] = sharded_numbers(
        ceng, cchunks, FilterBankEngine(serve_prog, channels=SHARDED_CHANNELS,
                                        mode="packed", device=dev), smi)

    # -- (3b) specialized shards: a narrow bank, C = 2, on a (2, 1) mesh ----
    narrow = serve_prog.select(np.arange(NARROW_FILTERS))
    neng = ShardedFilterBankEngine(narrow, channels=NARROW_CHANNELS,
                                   mesh=slots(2, 1), n_bank_shards=2,
                                   chunk_hint=SERVE_CHUNK)
    modes = [p.mode for p in neng.plan.shard_plans]
    check(modes == ["specialized"] * 2,
          f"the narrow bank planned no specialized shards: {neng.describe()}")
    nchunks = [xc[:NARROW_CHANNELS, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK]
               for k in range(SHARDED_CHANNEL_PUSHES)]
    nouts = counted("specialized_2x1", lambda: [neng.push(c)
                                                for c in nchunks])
    check(np.array_equal(np.concatenate(nouts, axis=2),
                         lower(narrow, "oracle")(xc[:NARROW_CHANNELS])),
          "the specialized shards differ from the numpy oracle")
    check(launches["specialized_2x1"]["specialized_call"] == 2 * len(nchunks)
          and launches["specialized_2x1"]["bank_apply"] == 0,
          f"specialized shards: {launches['specialized_2x1']}")
    legs["specialized_2x1"] = sharded_numbers(
        neng, nchunks, FilterBankEngine(narrow, channels=NARROW_CHANNELS,
                                        device=dev), smi)

    # -- (3c) a CSE program through the sharded backend at the planner's
    # choice, then its augmented bank forced into 2 shards: the shards'
    # launches, then one fold on the card before the copy back ------------
    serve_opt = cse_pass(serve_prog)
    x1 = stream[:, :SERVE_CHUNK]
    want1 = lower(serve_prog, "oracle")(x1)
    exe = lower(serve_opt, "sharded", mesh=slots(2, 1))
    feng = ShardedFilterBankEngine(serve_opt.bank, mesh=slots(2, 1),
                                   n_bank_shards=2, combine=serve_opt.combine,
                                   chunk_hint=SERVE_CHUNK)
    for name, eng_c, call in (
            ("lower_cse_2x1", exe.engine, lambda: exe(x1)),
            ("cse_2_shards", feng, lambda: (feng.reset(), feng.push(x1))[1])):
        check(np.array_equal(counted(name, call), want1),
              f"{name}: the sharded CSE program differs from the oracle")
        k1_c, k2_c = plan_launches(eng_c)
        check(launches[name] == {"bank_apply": k1_c, "specialized_call": k2_c,
                                 "combine_fold": 1},
              f"{name}: {launches[name]} ({eng_c.describe()})")
        legs[name] = {
            "describe": eng_c.describe(), "plan": plan_summary(eng_c.plan),
            "call_ms_events": cuda_ms(call), "call_ms_host": host_ms(call),
            "launches": launches[name], "nvidia_smi": smi}
    check(feng.n_bank_shards == 2, f"cse_2_shards: {feng.describe()}")

    # -- (4) chaos behind the server: two shards killed --------------------
    inj = FaultInjector()
    for shard, at in CHAOS_KILLS:
        inj.kill_shard(shard, at)
    keng = ShardedFilterBankEngine(serve_prog, mesh=slots(4, 1),
                                   n_bank_shards=4, fault_injector=inj,
                                   integrity_check=True,
                                   chunk_hint=SERVE_CHUNK)
    server = AsyncBankServer(keng, depth=2)
    kx = stream[:, :CHAOS_CHUNKS * SERVE_CHUNK]

    def chaos():
        got = []
        for k in range(CHAOS_CHUNKS):
            got += server.submit(kx[:, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK])
        return got + server.drain()

    t0 = time.perf_counter()
    kouts = counted("chaos", chaos)
    chaos_s = time.perf_counter() - t0
    check(np.array_equal(np.concatenate(kouts, axis=2),
                         lower(serve_prog, "oracle")(kx)),
          "the recovered stream differs from the numpy oracle")
    st = keng.fault_stats()
    n_kills = len(CHAOS_KILLS)
    check(st["injected"]["kills"] == st["lost_shards"] == st["recoveries"]
          == st["detections"] == n_kills and not st["degraded"],
          f"chaos counters: {st}")
    check(server.failed_chunks == 0 and server.chunks_out == CHAOS_CHUNKS,
          f"the server dropped chunks: {server.fault_stats()}")
    legs["chaos"] = {"describe": keng.describe(), "wall_s": chaos_s,
                     "fault_stats": st, "server": {
                         k: v for k, v in server.fault_stats().items()
                         if k != "engine"},
                     "launches": launches["chaos"], "nvidia_smi": smi}
    total = {k: sum(v[k] for v in launches.values())
             for k in ("bank_apply", "specialized_call", "combine_fold")}
    emit({"phase": "sharded", "legs": legs, "launches": launches,
          "launches_total": total, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.compiler import compile_bank
    from repro_torch.core import po2_quantize_batch
    from repro_torch.filters import (FilterBankEngine, fir_bit_layers_batch,
                                     spread_lowpass_qbank, sweep_bank)
    from repro_torch.kernels import blmac_fir, blmac_fir_bank
    from repro_torch.kernels.build import build_all, library

    # the kernel module, not the same-named function the package exports
    bf = importlib.import_module("repro_torch.kernels.blmac_fir")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "env", "device": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    infos = build_all()
    build_s = time.perf_counter() - t0
    dynamic_smem = {
        "blmac_bank_kernel": {
            t: library("blmac_bank").blmac_bank_smem_bytes(t)
            for t in (SERVE_TAPS, SWEEP_TAPS)},
    }  # K2's depends on its table: see the specialized phase
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: {"nvcc_s": i.seconds, "cached": i.cached,
                            "kernels": i.resources()}
                        for n, i in infos.items()},
          "dynamic_smem_bytes_by_taps": dynamic_smem,
          "blmac_bank_ptxas": [ln.strip() for ln in
                               infos["blmac_bank"].ptxas.splitlines()
                               if "registers" in ln or "spill" in ln
                               or "Compiling entry" in ln
                               or "Performance Loss" in ln]})

    rng = np.random.default_rng(0)

    # -- serve leg -----------------------------------------------------------
    serve_q = spread_lowpass_qbank(SERVE_FILTERS, SERVE_TAPS)
    serve_prog = compile_bank(serve_q)
    stream = rng.integers(-128, 128, (1, SERVE_CHUNK * SERVE_CHUNKS)) \
        .astype(np.int32)
    chunks = [stream[:, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK]
              for k in range(SERVE_CHUNKS)]
    eng = FilterBankEngine(serve_prog, channels=1, mode="packed", device=dev)
    bf.reset_launch_counts()
    outs, serve_per_push = [], []
    t0 = time.perf_counter()
    for c in chunks:
        before = bf.bank_apply.launches
        outs.append(eng.push(c))
        serve_per_push.append(bf.bank_apply.launches - before)
    serve_s = time.perf_counter() - t0
    serve_launches = bf.bank_apply.launches
    check(serve_per_push == [1] * SERVE_CHUNKS,
          f"serve leg: K1 launches per push {serve_per_push}, want one a "
          f"push")
    cpu_eng = FilterBankEngine(serve_prog, channels=1, mode="packed",
                               device="cpu")
    cpu_outs = [cpu_eng.push(c) for c in chunks]
    check(all(np.array_equal(a, b) for a, b in zip(outs, cpu_outs)),
          "serve stream differs from the plain CPU path")
    last = outs[-1]
    tail_in = stream[:, -(last.shape[2] + SERVE_TAPS - 1):]
    check(np.array_equal(last, fir_bit_layers_batch(tail_in, serve_q)),
          "serve tail chunk differs from the numpy oracle")
    n_serve_out = sum(o.shape[2] for o in outs)
    emit({"phase": "serve", "filters": SERVE_FILTERS, "taps": SERVE_TAPS,
          "pushes": SERVE_CHUNKS, "chunk": SERVE_CHUNK,
          "outputs_per_filter": n_serve_out, "bank_launches": serve_launches,
          "bank_launches_per_push": serve_per_push,
          "groups": len(eng.bank_schedule.groups), "wall_s": serve_s,
          "bit_exact_vs_cpu_and_oracle": True})

    # -- sweep leg -----------------------------------------------------------
    sweep_q, _ = po2_quantize_batch(sweep_bank(SWEEP_TAPS), 16)
    sweep_prog = compile_bank(sweep_q)
    x_sweep = torch.as_tensor(rng.integers(-128, 128, (1, SWEEP_SAMPLES)),
                              dtype=torch.int32, device=dev)
    bf.reset_launch_counts()
    y_sweep = blmac_fir_bank(x_sweep, sweep_q)
    torch.cuda.synchronize()
    sweep_launches = bf.bank_apply.launches
    check(sweep_launches == 1,
          f"blmac_fir_bank made {sweep_launches} bank launches, want 1")
    sched = sweep_prog.schedule()  # the plan blmac_fir_bank used
    frames, n_sweep = bf.frame_signal_batch(x_sweep, SWEEP_TAPS, OPS_TILE)
    check(tuple(y_sweep.shape) == (len(sweep_q), 1, n_sweep)
          and y_sweep.stride(2) == 1, "sweep output is not (B, C, n_out)")
    # the plain version per group, reordered and cut like the reference
    y_plain = bank_plain(frames, sched, SWEEP_TAPS, OPS_TILE)[:, :, :n_sweep]
    sweep_diff = max_abs_diff(y_sweep, y_plain)
    check(sweep_diff == 0, f"bank kernel differs from plain by {sweep_diff}")
    del y_plain
    rows = np.sort(rng.choice(len(sweep_q), SWEEP_CHECK_ROWS, replace=False))
    want = fir_bit_layers_batch(x_sweep.cpu().numpy(), sweep_q[rows])
    got_rows = y_sweep[torch.as_tensor(rows, device=dev)].cpu().numpy()
    check(np.array_equal(got_rows, want),
          "sweep rows differ from the numpy oracle")
    emit({"phase": "sweep", "filters": len(sweep_q), "taps": SWEEP_TAPS,
          "samples": SWEEP_SAMPLES, "output_bytes": y_sweep.numel() * 4,
          "groups": len(sched.groups),
          "zero_groups": sum(not g.sel_layers for g in sched.groups),
          "bank_launches": sweep_launches, "max_abs_diff_vs_plain": sweep_diff,
          "oracle_rows_checked": SWEEP_CHECK_ROWS})

    # -- the cost model's "cuda" lane, fitted on this card (the specialized
    # leg's one-filter auto engine plans with it) ---------------------------
    from repro_torch.core.costmodel import calibrate_backend

    probes: dict = {}
    t0 = time.perf_counter()
    cal = calibrate_backend("cuda", dev, report=probes)
    fit_s = time.perf_counter() - t0
    emit({"phase": "calibration", "fit_s": fit_s,
          "constants": dataclasses.asdict(cal), "probes": probes})

    # -- specialized leg -----------------------------------------------------
    spec_q = sweep_q[4950]  # a bandpass filter of the sweep bank
    x_spec = torch.as_tensor(rng.integers(-128, 128, SPEC_SAMPLES),
                             dtype=torch.int32, device=dev)
    bank8 = sweep_q[np.linspace(0, len(sweep_q) - 1, 8).astype(int)]
    x8 = rng.integers(-128, 128, (SPEC_CHANNELS, SPEC_PUSHES * SPEC_CHUNK)) \
        .astype(np.int32)
    spec_chunks = [x8[:, k * SPEC_CHUNK:(k + 1) * SPEC_CHUNK]
                   for k in range(SPEC_PUSHES)]
    spec_eng = FilterBankEngine(bank8, channels=SPEC_CHANNELS,
                                mode="specialized", device=dev)
    one_eng = FilterBankEngine(spec_q[None], channels=SPEC_CHANNELS,
                               device=dev)  # auto mode
    if one_eng.mode != "specialized" or one_eng.dispatch_plan.lane != "cuda":
        from repro_torch.kernels.runtime import dispatch_candidates

        check(False, f"auto mode chose {one_eng.dispatch_plan} among "
                     f"{dispatch_candidates(one_eng.program, SPEC_CHANNELS, device=dev)}")
    bf.reset_launch_counts()
    y_spec = blmac_fir(x_spec, spec_q)
    torch.cuda.synchronize()
    fir_launches = bf.specialized_call.launches
    per_push = {"specialized_8x2": [], "auto_1x2": []}
    push_s = []
    y_eng = {"specialized_8x2": [], "auto_1x2": []}
    for chunk in spec_chunks:
        for name, e in (("specialized_8x2", spec_eng), ("auto_1x2", one_eng)):
            before = bf.specialized_call.launches
            t0 = time.perf_counter()
            y_eng[name].append(e.push(chunk))  # ends in a device-to-host copy
            if name == "auto_1x2":
                push_s.append(time.perf_counter() - t0)
            per_push[name].append(bf.specialized_call.launches - before)
    spec_launches = bf.specialized_call.launches
    check(spec_launches > 0, "specialized leg never launched its kernel")
    check(fir_launches == 1, f"blmac_fir made {fir_launches} K2 launches")
    check(all(n == 1 for v in per_push.values() for n in v),
          f"K2 launches per engine push: {per_push}")
    want_spec = fir_bit_layers_batch(x_spec.cpu().numpy(), spec_q)[0, 0]
    check(np.array_equal(y_spec.cpu().numpy(), want_spec),
          "blmac_fir differs from the numpy oracle")
    check(np.array_equal(np.concatenate(y_eng["specialized_8x2"], axis=2),
                         fir_bit_layers_batch(x8, bank8)),
          "specialized engine differs from the numpy oracle")
    check(np.array_equal(np.concatenate(y_eng["auto_1x2"], axis=2),
                         fir_bit_layers_batch(x8, spec_q[None])),
          "one-filter engine differs from the numpy oracle")
    spec_pulses = compile_bank(spec_q[None]).pulse_schedules()[0]
    sframes, n_spec = bf.frame_signal(x_spec, SWEEP_TAPS, OPS_TILE)
    sprog = bf.specialized_program(spec_pulses, SWEEP_TAPS, OPS_TILE, str(dev))
    s_plain = bf.specialized_plain(sframes, spec_pulses, SWEEP_TAPS, OPS_TILE)
    s_walk = bf.pulse_table_walk(sframes.cpu().numpy(),
                                 *bf.pulse_tables([spec_pulses], SWEEP_TAPS),
                                 SWEEP_TAPS, OPS_TILE)[0]
    check(np.array_equal(s_walk, s_plain.cpu().numpy()),
          "the table walk differs from the plain version")
    spec_diff = max_abs_diff(bf.specialized_call(sframes, sprog)[0], s_plain)
    check(spec_diff == 0, f"specialized kernel differs by {spec_diff}")
    threads, cols, tab_pad, k2_smem = sprog.geometry
    check(library("blmac_specialized").blmac_specialized_smem_bytes(
              tab_pad, threads, SWEEP_TAPS, bf.OUTS_PER_THREAD) == k2_smem,
          "K2's shared memory differs between the host and the library")
    k2_resources = infos["blmac_specialized"].resources()
    k2_outs = {  # outputs a thread and segments of taps, at each call's grid
        "blmac_fir": (bf.specialized_outs(1, 1, sframes.shape[0], OPS_TILE,
                                          bf.sm_count(dev)), OPS_TILE),
        **{name: (bf.specialized_outs(
            e.n_filters, SPEC_CHANNELS, e._frame(torch.zeros(
                (SPEC_CHANNELS, SPEC_CHUNK + SWEEP_TAPS - 1),
                dtype=torch.int32, device=dev))[0].shape[1],
            e.tile, bf.sm_count(dev)), e.tile)
           for name, e in (("specialized_8x2", spec_eng),
                           ("auto_1x2", one_eng))}}
    emit({"phase": "specialized", "taps": SWEEP_TAPS, "samples": SPEC_SAMPLES,
          "pulses": len(spec_pulses),
          "taps_with_pulses": len({j for _, j, _ in spec_pulses}),
          "engine_filters": len(bank8), "engine_channels": SPEC_CHANNELS,
          "pushes": SPEC_PUSHES, "chunk": SPEC_CHUNK,
          "specialized_launches": spec_launches,
          "blmac_fir_launches": fir_launches,
          "launches_per_push": per_push,
          "one_filter_engine_push_ms": [t * 1e3 for t in push_s],
          "one_filter_engine_push_ms_median": sorted(push_s)[len(push_s) // 2]
          * 1e3,
          "max_abs_diff_vs_plain": spec_diff, "bit_exact_vs_oracle": True,
          "table_walk_bit_exact": True,
          "geometry": {"threads": threads, "columns": cols,
                       "table_words": sprog.table_len, "smem_bytes": k2_smem},
          "outputs_a_thread": {name: o for name, (o, _) in k2_outs.items()},
          "tap_segments": {name: bf.specialized_segments(
              o, bf.specialized_geometry(t, SWEEP_TAPS, 0, o)[0])
              for name, (o, t) in k2_outs.items()},
          "ptxas": k2_resources})

    # -- the CSE path and the planner -----------------------------------------
    fold_row = cse_leg(dev, smi, serve_prog, serve_q, chunks, outs,
                       sweep_prog, sweep_q, x_sweep, y_sweep, cal)
    dispatch_leg(dev, smi, cal, fit_s, sweep_prog)
    machine_launches = machine_leg(dev, smi, sweep_prog, serve_prog)
    sharded_launches = sharded_leg(dev, smi, serve_prog, sweep_prog, x_sweep,
                                   y_sweep)

    # -- K1 at the main path's shapes: the sweep call and one serve push ----
    # K1's bound: the bytes (samples in, the int32 output out, once each)
    # over HBM, or its adds (one per pulse and per fold an output, as the
    # CUDA-core bound counted them) over the int8 tensor-core rate; the
    # CUDA-core bounds of the earlier design are kept beside it
    half = SWEEP_TAPS // 2
    terms_k1 = bf.bank_terms(sched, SWEEP_TAPS, dev)  # cached by the leg
    out_k1 = bf.bank_output(len(sweep_q), 1, n_sweep, dev)

    def k1():
        bf.bank_apply(frames, terms_k1, OPS_TILE, n_sweep, out=out_k1)

    k1_ops = (int(sweep_prog.pulse_counts.sum()) + half) * n_sweep
    k1_bytes = 4 * (SWEEP_SAMPLES + len(sweep_q) * n_sweep)
    k1_bound, k1_by = bound(k1_ops, k1_bytes, INT8_TC_OPS_PER_S)
    k1_ms = cuda_ms(k1)
    k1_device_us = queued_us(k1, reps=10)
    # into a contiguous result (rows 8 bytes off 16 bytes: thread stores)
    out_dense = torch.empty((len(sweep_q), 1, n_sweep), dtype=torch.int32,
                            device=dev)
    k1_dense_ms = cuda_ms(lambda: bf.bank_apply(frames, terms_k1, OPS_TILE,
                                                n_sweep, out=out_dense))
    check(torch.equal(out_dense, y_sweep), "K1 into a contiguous result "
                                           "differs")
    del out_dense
    k1_plain_ms = cuda_ms(lambda: plain_groups(frames, sched, SWEEP_TAPS,
                                               OPS_TILE))
    k1_lib_ms = conv1d_ms(x_sweep, sweep_q, n_sweep)
    # the whole call by events, its tables cached: through the ops entry
    # point (which looks the program up by a digest of the bank), and
    # through the kernel module with the schedule in hand
    bf.reset_launch_counts()
    ops_call_ms = cuda_ms(lambda: blmac_fir_bank(x_sweep, sweep_q))
    ops_calls = bf.bank_apply.launches
    bf.reset_launch_counts()
    module_call_ms = cuda_ms(lambda: bf.blmac_fir_bank(
        x_sweep, sweep_prog.packed, SWEEP_TAPS, OPS_TILE, fast_path=False,
        schedule=sched))
    module_calls = bf.bank_apply.launches
    sweep_call = {"ops_blmac_fir_bank_ms": ops_call_ms,
                  "module_blmac_fir_bank_ms": module_call_ms,
                  "launches_per_call": sweep_launches,
                  "calls_timed": {"ops": ops_calls, "module": module_calls}}

    # serve shape: one push of the engine (32 such pushes per leg)
    sbuf = torch.as_tensor(stream[:, :SERVE_CHUNK + SERVE_TAPS - 1],
                           device=dev)
    spad = -(-sbuf.shape[1] // eng.tile) * eng.tile
    n_push = sbuf.shape[1] - SERVE_TAPS + 1  # outputs of one push
    sframes_b, _ = bf.frame_signal_batch(
        torch.nn.functional.pad(sbuf, (0, spad - sbuf.shape[1])),
        SERVE_TAPS, eng.tile)
    s_out = bf.bank_output(SERVE_FILTERS, 1, n_push, dev)

    def k1_serve():
        bf.bank_apply(sframes_b, eng._terms, eng.tile, n_push, out=s_out)

    serve_diff = max_abs_diff(
        bf.bank_apply(sframes_b, eng._terms, eng.tile, n_push),
        bank_plain(sframes_b, eng.bank_schedule, SERVE_TAPS,
                   eng.tile)[:, :, :n_push])
    check(serve_diff == 0, "bank kernel differs at the serve shape")
    s_ops = (int(serve_prog.pulse_counts.sum()) + SERVE_TAPS // 2) * n_push
    s_bytes = 4 * (sbuf.shape[1] + SERVE_FILTERS * n_push)
    s_bound, s_by = bound(s_ops, s_bytes, INT8_TC_OPS_PER_S)
    s_device_us = queued_us(k1_serve)
    serve_shape = {
        "shape": f"{SERVE_FILTERS} filters x {SERVE_TAPS} taps x 1 channel x "
                 f"{sbuf.shape[1]} samples (one push), tile {eng.tile}",
        "max_abs_err": serve_diff, "ms": cuda_ms(k1_serve),
        "device_us": s_device_us,
        "plain_ms": cuda_ms(lambda: plain_groups(
            sframes_b, eng.bank_schedule, SERVE_TAPS, eng.tile)),
        "bound_ms": s_bound, "bound_by": s_by,
        "cuda_core_bound_ms": s_ops / INT32_OPS_PER_S * 1e3,
        "cuda_core_iadd3_bound_ms": s_ops / INT32_ADDS_PER_S * 1e3,
        "library_ms": conv1d_ms(sbuf[0], serve_q, n_push),
        "ops": s_ops, "bytes": s_bytes,
        "launches_per_push": serve_per_push,
    }

    # K2's adds: one per pulse and one per fold (a tap other than the
    # centre that carries pulses) per output, as IADD3 pairs (see
    # INT32_ADDS_PER_S); bytes: the samples in and the outputs out, once
    k2_folds = len({j for _, j, _ in spec_pulses if j != half})
    k2_ops = (len(spec_pulses) + k2_folds) * n_spec
    k2_bytes = 4 * (SPEC_SAMPLES + n_spec)
    k2_bound, k2_by = bound(k2_ops, k2_bytes, INT32_ADDS_PER_S)
    k2_ms = cuda_ms(lambda: bf.specialized_call(sframes, sprog))
    k2_device_us = queued_us(lambda: bf.specialized_call(sframes, sprog))
    k2_plain_ms = cuda_ms(lambda: bf.specialized_plain(
        sframes, spec_pulses, SWEEP_TAPS, OPS_TILE))
    k2_lib_ms = conv1d_ms(x_spec, spec_q[None], n_spec)

    kernels = [
        {"name": "blmac_bank_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/blmac_bank.cu",
         "replaces": "src/repro/kernels/blmac_fir.py:200",
         "replaces_function": "_fir_kernel_bank",
         "launches": (serve_launches + sweep_launches
                      + machine_launches["bank_apply"]
                      + sharded_launches["bank_apply"]),
         "launches_by_leg": {"serve": serve_launches, "sweep": sweep_launches,
                             "machine": machine_launches["bank_apply"],
                             "sharded": sharded_launches["bank_apply"]},
         "shape": f"{len(sweep_q)} filters x {SWEEP_TAPS} taps x 1 channel x "
                  f"{SWEEP_SAMPLES} samples, tile {OPS_TILE}, "
                  f"{len(sched.groups)} groups in 1 launch",
         "max_abs_err": sweep_diff, "max_abs_diff": sweep_diff,
         "ms": k1_ms, "kernel_ms": k1_ms, "device_us": k1_device_us,
         "contiguous_out_ms": k1_dense_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "bound_share": k1_bound / k1_ms,
         "cuda_core_bound_ms": k1_ops / INT32_OPS_PER_S * 1e3,
         "cuda_core_iadd3_bound_ms": k1_ops / INT32_ADDS_PER_S * 1e3,
         "library_ms": k1_lib_ms, "ops": k1_ops, "bytes": k1_bytes,
         "terms": {"row_tiles": terms_k1.n_row_tiles,
                   "terms_by_group": terms_k1.groups[:, 1].tolist(),
                   "k": terms_k1.k},
         "sweep_call": sweep_call, "serve_shape": serve_shape},
        {"name": "blmac_specialized_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/blmac_specialized.cu",
         "replaces": "src/repro/kernels/blmac_fir.py:112",
         "replaces_function": "_fir_kernel_specialized",
         "launches": (spec_launches + machine_launches["specialized_call"]
                      + sharded_launches["specialized_call"]),
         "launches_by_leg": {"specialized": spec_launches,
                             "machine": machine_launches["specialized_call"],
                             "sharded": sharded_launches["specialized_call"]},
         "shape": f"1 filter x {SWEEP_TAPS} taps ({len(spec_pulses)} pulses) x "
                  f"{SPEC_SAMPLES} samples, tile {OPS_TILE}",
         "max_abs_err": spec_diff, "max_abs_diff": spec_diff,
         "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms,
         "ops": k2_ops, "bytes": k2_bytes, "device_us": k2_device_us,
         "launches_by_call": {"blmac_fir": fir_launches, **per_push,
                              "machine": machine_launches["specialized_call"]}},
    ]

    # -- engine throughput on the serve leg (before the pulse_matmul leg,
    # whose profiler phases slow the host's later calls) ---------------------
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_done = sum(eng.push(c).shape[2] for c in chunks)
    dt = time.perf_counter() - t0
    emit({"phase": "engine_throughput", "filters": SERVE_FILTERS,
          "pushes": SERVE_CHUNKS, "wall_s": dt,
          "filter_samples_per_s": SERVE_FILTERS * n_done / dt,
          "device": kind, "nvidia_smi": smi})
    bf.reset_launch_counts()
    breakdown = serve_push_breakdown(eng, chunks)
    check(bf.bank_apply.launches == 3 * SERVE_CHUNKS,
          f"serve breakdown: {bf.bank_apply.launches} bank launches for "
          f"{3 * SERVE_CHUNKS} pushes")
    emit({"phase": "serve_push_breakdown", **breakdown,
          "device": kind, "nvidia_smi": smi})

    fold_row["launches_by_leg"] = {"cse": fold_row["launches"],
                                   "machine": machine_launches["combine_fold"],
                                   "sharded": sharded_launches["combine_fold"]}
    fold_row["launches"] += (machine_launches["combine_fold"]
                             + sharded_launches["combine_fold"])
    kernels.append(fold_row)
    kernels.append(pulse_matmul_leg(dev, smi))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    # the cost model's fitted constants go to a directory of this run only
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache") as cache_dir:
        os.environ["REPRO_TORCH_CACHE_DIR"] = cache_dir
        sys.exit(main())
