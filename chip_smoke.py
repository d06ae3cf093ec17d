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
against the push's host clock.  After those timings:

  * sessions    — the reference's multi-tenant path: the ``--sessions``
                  entry point (`repro_torch.launch.serve.serve_sessions`,
                  256 × 63, 64 tenants of 4 rows, 8 lanes, 16 chunks of
                  512, a `swap_filters` and a pause/resume), every tenant
                  bit-exact against the numpy oracle for its rows, K1 + K2
                  launches equal to the rounds; its steps by host clock,
                  one round by CUDA events and host (and its kernel
                  alone), bytes up, down and kept a round,
                  `serve_stats()`, output and filter-samples/s (kept and
                  computed), `predicted_step_us` beside the step; the
                  dedicated arm (one engine a tenant) in turns with the
                  shared server; the loop without a journal, with one
                  without fsync and with fsync, in turns; a child process
                  SIGKILLed with chunk 8 queued and recovered here by
                  `BankSessionServer.recover`, every tenant bit-exact with
                  no gap or duplicate; `swap_program` after chunk 7 to a
                  12-bit bank, every tenant exact before and after; then
                  sessions × shards (`port_session_chaos_check` from
                  ``tests/torch_differential.py``) on a (4, 1) mesh of the
                  card's slots, two kills and a journal, the counters equal
                  to the kills and 8 tenants marked a kill, and full-range
                  int32 samples with the integrity probe on, without and
                  with a kill, bit-exact with no corruption read.
  * lm          — the language-model serving stack (plain PyTorch; the
                  reference's LM path reaches no Pallas kernel, so none
                  of the four kernels runs: their counts, zeroed before
                  it, must stay 0), in a fresh process (``--lm-leg``):
                  qwen2.5-3b at its published widths (36 layers, 3.086e9
                  float32 parameters from seed 0) through the launcher's
                  `serve_lm` at ``--no-reduced --batch 4 --prompt-len 32
                  --new-tokens 16 --cache-len 256``, bf16 compute: the
                  tokens' shape and dtype, every emitted token's logits
                  against one teacher-forced forward over prompt and
                  prefix (within 5% of the logits' scale), the same in
                  float32 with TF32 off (1e-4), bf16 against float32
                  (prefill logits, greedy agreement), ``max_new_tokens=0``;
                  prefill and decode steps by CUDA events, a warm
                  `generate` by host clock, the decode step's bytes bound
                  (the float32 weights read once; with the cast at use,
                  twice) and a traced decode step's idle share; then
                  ``--quant-planes 4`` (the quantized leaves counted from
                  the stacked shapes by the reference's rule, its error,
                  seconds and greedy agreement); mamba2-370m and
                  recurrentgemma-2b at full width in bf16 and float32
                  against their teacher-forced forwards (the SSD and
                  RG-LRU decode states; bf16 within 25%, float32 within
                  the reference's SSD tolerance 2e-3); and every
                  registered arch reduced, float32, prefill and 4 decode
                  steps on the card against the port on the CPU with the
                  same parameters (within 1e-4 of the scale, tokens
                  equal).
  * train       — the language model's training half (plain PyTorch;
                  the reference's training path reaches no Pallas kernel
                  either, so the four counts, zeroed before it, must stay
                  0), in a fresh process (``--train-leg``): qwen2.5-3b at
                  its published widths (3.086e9 float32 master weights
                  from a CUDA generator with seed 0, bf16 compute, remat
                  full), the reference launcher's B = 16 × S = 256 markov
                  batch repeated for 5 AdamW steps (warmup 1, lr 3e-4)
                  through `make_train_step`: step 0's loss against a
                  forward-only `loss_fn` (1e-3), every loss and grad norm
                  finite, the loss falling; each step by CUDA events,
                  tokens/s, MFU against 989 TFLOP/s, the step's FLOPs
                  (8·N·D with remat) and optimizer-bytes bounds, the peak
                  memory, the bytes a checkpoint would write (none is
                  written); the step's parts (grads, clip, optimizer) by
                  events and each traced alone, and a whole step traced
                  (idle share, kernels); then the launcher (``python -m
                  repro_torch.launch.train --arch qwen2.5-3b --steps 20``,
                  its checkpoint restored on the card) and
                  ``examples/port_train_lm.py --size 100m --steps 50`` in
                  fresh processes, the loss falling in both; `TrainLoop`'s
                  crash at step 13 resumed from 10 and bit-exact
                  (`torch.equal`) with the uninterrupted run; every arch
                  reduced, float32, TF32 off, two steps on the card
                  against the CPU (metrics, params and optimizer state
                  within 1e-4 of each leaf's scale; Adam-amplified
                  elements counted, each within the most two AdamW runs
                  can part, in key-bias leaves or at most 1% of a leaf);
                  and the int8 all-reduce on four slots of the card
                  against the exact mean (0.02) and gradient (0.05).
  * mesh        — the language model on a (2, 4) mesh of the card's slots
                  (``cuda:0`` in all eight; plain PyTorch, the four
                  counts zeroed before it must stay 0), in a fresh process
                  (``--mesh-leg``): qwen2.5-3b at its published widths in
                  the train phase's shape (B 16 × S 256, AdamW, bf16,
                  remat), 5 steps unsharded and then 5 on the mesh from
                  the same init (train rules: data-parallel over the two
                  data slots, tensor-parallel over the four model slots
                  for the attention, MLP, embedding, head and loss, each
                  model slot's weight blocks gathered over data a repeat
                  unit at a time): each step
                  by CUDA events, the peak memory, the state's bytes a
                  slot from the placement, the bytes one step's
                  all-gathers, reduce-scatters and all-reduces move, its
                  launches and milliseconds in the leg's result, a traced mesh
                  step (the unsharded one is the train phase's); step 0's
                  loss against the unsharded one (1e-3), every step's
                  loss and grad norm (1e-3), and the direction of step
                  1's update (the sign of each element's first moment)
                  agreeing in all but 1% of the elements; then the same
                  at full width cut to 8 layers in float32, TF32 off,
                  two steps each way with both states on the card: the
                  params and moments a layer at a time within 1e-4 of the
                  layer's scale (`train_tree_gap`: elements whose own
                  moments part by more than keeps their update within
                  half the bound held to the most two AdamW runs can
                  part, and counted by layer beyond the bound, in
                  key-bias leaves or at most 1% of a layer; the largest
                  gap of the others printed with its headroom);
                  qwen2.5-3b served at full
                  width in decode rules (B 4 over data, prompt 32, the
                  caches' ring over model: sequence-parallel decode),
                  bf16 and float32, teacher-forced by the unsharded
                  engine's greedy tokens (logits within 5% / 1e-4 of
                  their scale, every float32 argmax equal), decode steps
                  by events beside the unsharded engine's; the other
                  four block kinds at their published widths, depth cut
                  to fit the card (mixtral-8x22b at 1 layer: 8 experts,
                  2 a model slot; deepseek-v3-671b's 3 dense layers: MLA,
                  128 heads, 32 a slot; recurrentgemma-2b's (R, R, A);
                  mamba2-370m at 8 layers: SSD, 32 heads, 8 a slot), each
                  two bf16 steps unsharded and on the mesh (loss and
                  grad norm 1e-3, step 1's update direction, the sign of
                  the params' move from their init, flipped in under
                  1%), then served the same way as qwen2.5-3b, its
                  caches checked cut over model; each cell's step and
                  decode ms, kernels a step and peak beside the
                  unsharded, and mixtral's dry run (every slot traced)
                  equal to its step's FLOPs and `COLLECTIVES`; every arch
                  reduced, float32, TF32 off, two train steps and greedy
                  decoding in both decode cases on the mesh against the
                  card unsharded (1e-4, `tests/torch_differential.py`
                  `mesh_vs`); and a reduced train state written sharded
                  on (2, 4), restored on (4, 1) and back, bit-exact.
                  Its ``dryrun`` phase: the port's dry run
                  (`repro_torch.launch.dryrun`) of the full-width train
                  cell on (2, 4) ``meta`` slots, every slot traced, held
                  against the measured mesh step — its FLOPs equal to
                  `FlopCounterMode`'s count of one more real step, its
                  all-gather and reduce-scatter bytes equal to
                  `TRAFFIC`, its memory of every slot on one device
                  within 10% of the card's peak and the one-slot
                  trace's figure for it an upper bound within 1.35×
                  (that trace gives every per-device figure), its ops
                  beside the
                  traced step's kernels and its roofline terms beside the
                  step's milliseconds (printed), its all-reduces equal
                  to the step's `COLLECTIVES`; then ``python -m
                  repro_torch.launch.dryrun --arch qwen2.5-3b --shape
                  decode_32k`` in a fresh process, its wall seconds and
                  lines, and the card's memory beside the constant the
                  dry run prices against.

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
removed at exit.  Prints one JSON object per phase, the script's wall
seconds (the ``total`` phase), the ``{"kernels": [...]}`` line (each
kernel's launches by leg, ``lm``, ``train`` and ``mesh`` among them), the card's
name and power limit as ``nvidia-smi`` reports them, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line; without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
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
    than the spans.  ``launch_count=None``: a step of library kernels no
    wrapper counts (the ``lm`` phase); only the trace's kernels are
    reported."""
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
    before = launch_count() if launch_count else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for i in range(1 + steps):
            with record_function(f"{STEP_SPAN}{i}"):
                fn()
                torch.cuda.synchronize()
            prof.step()
    if launch_count:
        made = launch_count() - before
        check(made == (1 + steps) * launches,
              f"{made} launches in {1 + steps} steps, want {launches} each")
    traced = steps * launches if launch_count else float("inf")
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
            "traced_steps": steps, "launches_traced": traced if launch_count else None,
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


SESSIONS_ARGV = ["--fir-bank", str(SERVE_FILTERS), "--taps", str(SERVE_TAPS),
                 "--sessions", "64", "--slots", "8", "--chunk", "512",
                 "--chunks", "16"]  # the reference's documented --sessions
SESSION_KILL_AT = 8  # the SIGKILLed child dies with chunk 8 queued
SESSION_SWAP_AT = 8  # swap_program flips after chunk 7
SESSION_CHAOS = dict(n_sessions=32, n_slots=8, rows_per_session=4,
                     n_chunks=6, chunk=512, n_bank_shards=4)
SESSION_CHAOS_KILLS = ((1, 5), (0, 14))  # dispatch rounds, 4 a step
# a child that serves the launcher's tenants with a journal and SIGKILLs
# itself with chunk KILL_AT journaled and queued, never stepped
SESSION_VICTIM = """
import os, signal, sys
import numpy as np
from repro_torch.compiler import compile_bank
from repro_torch.filters import spread_lowpass_qbank
from repro_torch.launch.serve import parser
from repro_torch.serving import BankSessionServer

wal, kill_at = sys.argv[1], int(sys.argv[2])
a = parser().parse_args(sys.argv[3:])
prog = compile_bank(spread_lowpass_qbank(a.fir_bank, a.taps))
srv = BankSessionServer(prog, n_slots=a.slots, auto_step=False,
                        device=a.device, chunk_hint=a.chunk, journal=wal)
per = a.fir_bank // a.sessions
rng = np.random.default_rng(0)  # the launcher's streams
ss = [srv.open_session(np.arange(i * per, (i + 1) * per), session_id=f"t{i}")
      for i in range(a.sessions)]
streams = [rng.integers(-128, 128, a.chunk * a.chunks).astype(np.int32)
           for _ in ss]
for k in range(kill_at + 1):
    for s, x in zip(ss, streams):
        s.push(x[k * a.chunk:(k + 1) * a.chunk])
    if k < kill_at:
        srv.step()
        for s in ss:
            s.pull()
print("VICTIM_OK", srv.serve_stats()["journal"], flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def sessions_leg(dev, smi, serve_prog) -> dict:
    """The ``sessions`` phase: the reference's multi-tenant serving path.

    (1) the ``--sessions`` entry point (`serve_sessions`, 256 × 63, 64
    tenants of 4 rows, 8 lanes, 16 chunks of 512, a `swap_filters` and a
    pause/resume) with its launches counted, every tenant held against
    the numpy oracle for its rows, K1 + K2 launches equal to the rounds;
    its numbers: steps and one round (events, host), bytes a round,
    `serve_stats()`, rates, the model's step; (2) the reference
    benchmark's dedicated arm (one engine a tenant) in turns with the
    shared server; (3) the loop with no journal, a journal without and
    with fsync, in turns; (4) a child SIGKILLed with chunk 8 queued,
    recovered here, every tenant bit-exact with no gap or duplicate; (5)
    `swap_program` after chunk 7 to a 12-bit bank, every tenant exact
    before and after; (6) sessions × shards: `port_session_chaos_check`
    on a (4, 1) mesh of the card's slots with two kills and a journal,
    then full-range int32 samples with the probe on, without and with a
    kill.  Returns the launches by leg."""
    import shutil
    import statistics

    import numpy as np
    import torch

    from repro_torch.compiler import compile_bank
    from repro_torch.distributed import bank_mesh
    from repro_torch.filters import (FilterBankEngine, fir_bit_layers_batch,
                                     spread_lowpass_qbank)
    from repro_torch.filters import bank as bank_mod
    from repro_torch.launch.serve import parser, serve_sessions
    from repro_torch.serving import BankSessionServer

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_differential import port_session_chaos_check

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    launches = {}
    legs = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_sessions")

    def counted(name, fn):
        bf.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {"bank_apply": bf.bank_apply.launches,
                          "specialized_call": bf.specialized_call.launches,
                          "combine_fold": bf.combine_fold.launches}
        return out

    def args_for(*extra):
        return parser().parse_args(SESSIONS_ARGV + ["--device", str(dev),
                                                    *extra])

    args = args_for()
    chunk, n_chunks, taps = args.chunk, args.chunks, args.taps
    qbank = serve_prog.qbank
    rounds_out = []  # (B, n_slots, n_out) of every shared round
    lanes = bank_mod.FilterBankEngine.apply_lanes

    def recording(self, buf):
        y = lanes(self, buf)
        rounds_out.append(y.shape)
        return y

    # -- (1) the entry point, counted and checked tenant by tenant ---------
    bank_mod.FilterBankEngine.apply_lanes = recording
    try:
        run = counted("launcher", lambda: serve_sessions(args))
    finally:
        bank_mod.FilterBankEngine.apply_lanes = lanes
    check(run.program.key == serve_prog.key, "the launcher compiled another "
                                             "bank")
    t0 = time.perf_counter()
    oracle = [fir_bit_layers_batch(x[None, :], qbank[sel])[:, 0]
              for x, sel in zip(run.streams, run.selections)]
    oracle_s = time.perf_counter() - t0
    for i in range(len(oracle)):
        check(np.array_equal(run.tenant_output(i), oracle[i]),
              f"tenant {i} differs from the numpy oracle")
    st = run.stats
    lk = launches["launcher"]
    check(lk["bank_apply"] + lk["specialized_call"] == st["rounds"]
          == len(rounds_out) and lk["combine_fold"] == 0,
          f"launches {lk} for {st['rounds']} rounds")
    eng = run.server.engine
    n_rows = len(run.selections[0])
    served = st["samples_out"] * n_rows  # the rows the tenants keep
    computed = sum(b * c * n for b, c, n in rounds_out)
    # one steady round: the 8 lanes of tail + one chunk each
    buf = np.stack([x[:chunk + taps - 1] for x in run.streams[:args.slots]])
    buf_dev = torch.as_tensor(buf, device=dev)
    round_ms_events = cuda_ms(lambda: eng.apply_lanes(buf))
    round_ms_host = host_ms(lambda: eng.apply_lanes(buf), reps=20)
    kernel_ms = cuda_ms(lambda: eng._run(*eng._frame(buf_dev)))
    n_round = buf.shape[1] - taps + 1
    steps_ms = [t * 1e3 for t in run.step_seconds]
    legs["launcher"] = {
        "argv": SESSIONS_ARGV, "plan": (dataclasses.asdict(eng.dispatch_plan)
                                        if eng.dispatch_plan else None),
        "mode": eng.mode, "loop_s": run.seconds,
        "step_ms_host": steps_ms,
        "step_ms_host_median": statistics.median(steps_ms),
        "predicted_step_us": run.server.predicted_step_us(),
        "dispatch_us_model": run.server._dispatch_us(),
        "round_ms_events": round_ms_events, "round_ms_host": round_ms_host,
        "round_kernel_ms_events": kernel_ms,
        "round_bytes_up": int(buf.nbytes),
        "round_bytes_down": 4 * len(qbank) * args.slots * n_round,
        "round_bytes_kept": 4 * n_rows * args.slots * n_round,
        "rounds": st["rounds"], "steps": st["steps"],
        "occupancy": st["occupancy"],
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "output_samples_per_s": st["samples_out"] / run.seconds,
        "filter_samples_per_s_served": served / run.seconds,
        "filter_samples_per_s_computed": computed / run.seconds,
        "oracle_host_s": oracle_s, "launches": lk, "nvidia_smi": smi}

    # -- (2) the dedicated arm, in turns with the shared server ------------
    dedicated = [FilterBankEngine(run.program, channels=1, device=dev,
                                  chunk_hint=chunk) for _ in run.streams]

    def dedicated_run():
        for e in dedicated:
            e.reset()
        outs = [[] for _ in dedicated]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in range(n_chunks):
            for i, (e, x) in enumerate(zip(dedicated, run.streams)):
                y = e.push(x[k * chunk:(k + 1) * chunk])
                outs[i].append(y[run.selections[i], 0])
        dt = time.perf_counter() - t
        for i, o in enumerate(outs):
            check(np.array_equal(np.concatenate(o, axis=1), oracle[i]),
                  f"dedicated tenant {i} differs from the oracle")
        return dt

    turns = []
    for arm in ("shared", "dedicated", "dedicated", "shared"):
        if arm == "shared":
            r = serve_sessions(args)
            turns.append((arm, r.seconds, r.stats["samples_out"]))
        else:
            turns.append((arm, dedicated_run(),
                          sum(o.shape[1] for o in oracle)))
    rate = {arm: statistics.median(n / t for a, t, n in turns if a == arm)
            for arm in ("shared", "dedicated")}
    legs["dedicated"] = {
        "turns": [[a, t, n / t] for a, t, n in turns],
        "shared_output_samples_per_s": rate["shared"],
        "dedicated_output_samples_per_s": rate["dedicated"],
        "shared_over_dedicated": rate["shared"] / rate["dedicated"],
        "dedicated_mode": dedicated[0].mode, "nvidia_smi": smi}
    del dedicated

    # -- (3) the journal's cost: none, no fsync, fsync, in turns ------------
    jruns = {"none": [], "nofsync": [], "fsync": []}
    jstats, per_run = {}, []
    for k, arm in enumerate(("none", "nofsync", "fsync", "fsync", "nofsync",
                             "none")):
        if arm == "none":
            r = serve_sessions(args)
        else:
            r = serve_sessions(args_for("--journal-path",
                                        os.path.join(work, f"wal{k}")),
                               journal_fsync=arm == "fsync")
            jstats[arm] = r.stats["journal"]
        jruns[arm].extend(t * 1e3 for t in r.step_seconds)
        per_run.append([arm, statistics.median(r.step_seconds) * 1e3])
    med = {arm: statistics.median(v) for arm, v in jruns.items()}
    legs["journal"] = {
        "step_ms_host_median": med, "runs_step_ms_host_median": per_run,
        "overhead_nofsync": med["nofsync"] / med["none"],
        "overhead_fsync": med["fsync"] / med["none"],
        "journal_stats": jstats, "nvidia_smi": smi}

    # -- (4) a SIGKILLed child, recovered here ------------------------------
    wal = os.path.join(work, "victim")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", SESSION_VICTIM, wal, str(SESSION_KILL_AT)]
        + SESSIONS_ARGV + ["--device", str(dev)], env=env, cwd=HERE,
        capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    check(res.returncode == -9 and "VICTIM_OK" in res.stdout,
          f"the victim exited {res.returncode}: {res.stderr[-2000:]}")
    t0 = time.perf_counter()
    srv = counted("recover", lambda: BankSessionServer.recover(
        wal, run.program, n_slots=args.slots, device=dev, auto_step=False,
        chunk_hint=chunk))
    recover_s = time.perf_counter() - t0
    tenants = [srv.sessions[f"t{i}"] for i in range(len(run.streams))]
    outs = [[t.pull()] for t in tenants]
    for k in range(SESSION_KILL_AT + 1, n_chunks):
        for t, x in zip(tenants, run.streams):
            t.push(x[k * chunk:(k + 1) * chunk])
        srv.step()
        for o, t in zip(outs, tenants):
            o.append(t.pull())
    n_pre = SESSION_KILL_AT * chunk - (taps - 1)  # delivered by the child
    for i, o in enumerate(outs):
        got = np.concatenate(o, axis=1)
        check(got.shape[1] == oracle[i].shape[1] - n_pre
              and np.array_equal(got, oracle[i][:, n_pre:]),
              f"recovered tenant {i}: a gap, a duplicate or a wrong sample")
    legs["recovery"] = {
        "child_process_s": child_s, "child_said": res.stdout.strip()[-400:],
        "recover_s": recover_s, "recovered_sessions": len(tenants),
        "regenerated_samples": int(outs[0][0].shape[1]),
        "launches_in_recover": launches["recover"],
        "journal_after": srv.journal.stats(), "nvidia_smi": smi}
    srv.close()

    # -- (5) swap_program mid-run -------------------------------------------
    q12 = spread_lowpass_qbank(len(qbank), taps, coeff_bits=12)
    t0 = time.perf_counter()
    prog12 = compile_bank(q12)
    compile_s = time.perf_counter() - t0
    srv = BankSessionServer(run.program, n_slots=args.slots, auto_step=False,
                            device=dev, chunk_hint=chunk)
    tenants = [srv.open_session(sel) for sel in run.selections]
    outs = [[] for _ in tenants]

    def serve(k0, k1):
        for k in range(k0, k1):
            for t, x in zip(tenants, run.streams):
                t.push(x[k * chunk:(k + 1) * chunk])
            srv.step()
            for o, t in zip(outs, tenants):
                o.append(t.pull())

    serve(0, SESSION_SWAP_AT)
    t0 = time.perf_counter()
    srv.swap_program(prog12)
    swap_s = time.perf_counter() - t0
    counted("swap_after", lambda: serve(SESSION_SWAP_AT, n_chunks))
    cut = SESSION_SWAP_AT * chunk - (taps - 1)
    for i, (o, x, sel) in enumerate(zip(outs, run.streams, run.selections)):
        got = np.concatenate(o, axis=1)
        after = fir_bit_layers_batch(x[None, cut:], q12[sel])[:, 0]
        check(np.array_equal(got[:, :cut], oracle[i][:, :cut])
              and np.array_equal(got[:, cut:], after),
              f"tenant {i} differs across swap_program")
    legs["swap_program"] = {
        "compile_s": compile_s, "swap_s": swap_s,
        "program_swaps": srv.program_swaps, "mode_after": srv.engine.mode,
        "launches_after": launches["swap_after"], "nvidia_smi": smi}

    # -- (6) sessions × shards: kills, then the probe on wide samples -------
    def slots(n):
        return bank_mesh(n, 1, devices=[dev] * n)

    t0 = time.perf_counter()
    chaos = counted("chaos", lambda: port_session_chaos_check(
        qbank, SESSION_CHAOS_KILLS, mesh=slots(4), device=dev,
        journal_path=os.path.join(work, "chaos"), **SESSION_CHAOS))
    chaos_s = time.perf_counter() - t0
    n_kills = len(SESSION_CHAOS_KILLS)
    check(chaos["lost_shards"] == chaos["recoveries"] == chaos["detections"]
          == chaos["session_faults"] == n_kills
          and sum(chaos["per_session"].values())
          == n_kills * SESSION_CHAOS["n_slots"],
          f"sessions × shards counters: {chaos}")
    probe = {}
    for name, kills in (("wide_probe", ()), ("wide_probe_kill", ((1, 3),))):
        st = counted(name, lambda: port_session_chaos_check(
            qbank, kills, mesh=slots(4), device=dev, integrity_check=True,
            sample_bits=32, **dict(SESSION_CHAOS, n_sessions=16,
                                   n_chunks=4)))
        check(st["corruptions"] == 0 and st["detections"] == len(kills),
              f"{name}: {st}")
        probe[name] = {k: st[k] for k in ("detections", "corruptions",
                                          "lost_shards", "recoveries",
                                          "n_bank_shards", "session_faults")}
    legs["shards"] = {"chaos_s": chaos_s, "fault_stats": {
        k: v for k, v in chaos.items() if k != "per_session"},
        "attributed": sum(chaos["per_session"].values()),
        "launches": launches["chaos"], **probe, "nvidia_smi": smi}
    shutil.rmtree(work, ignore_errors=True)
    total = {k: sum(v[k] for v in launches.values())
             for k in ("bank_apply", "specialized_call", "combine_fold")}
    emit({"phase": "sessions", "legs": legs, "launches": launches,
          "launches_total": total, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    return launches


# -- the lm phase: the language-model serving stack -------------------------

# `python -m repro_torch.launch.serve --arch qwen2.5-3b` at the published
# widths (src/repro/configs/qwen2_5_3b.py), the reference's other defaults
LM_ARGV = ["--arch", "qwen2.5-3b", "--no-reduced", "--batch", "4",
           "--prompt-len", "32", "--new-tokens", "16", "--cache-len", "256"]
LM_FULL_ARCHS = ("mamba2-370m", "recurrentgemma-2b")  # SSD, RG-LRU
LM_FULL_NEW_TOKENS = 8
LM_REDUCED_DECODE_STEPS = 4
# decode logits against the teacher-forced forward, max |difference| over
# max |logit|.  bf16 compute: two evaluation orders of one bf16 model;
# the recurrent archs carry their decode state in bf16 step by step where
# the forward sums a chunk at once, so theirs drift further.  float32
# with TF32 off: the attention bound of the reduced archs' card-against-
# CPU leg, and for the recurrent archs the reference's SSD tolerance
# (tests/test_ssd_rglru.py:32, chunked prefill against stepwise decode)
LM_BF16_REL, LM_BF16_REC_REL = 0.05, 0.25
LM_F32_REL, LM_F32_REC_REL = 1e-4, 2e-3
# `quantize_param_tree`'s rule (src/repro/core/serve_quant.py:55-57, 27-28)
QUANT_MIN_SIZE, QUANT_GROUP = 4096, 32


def quantized_leaf_count(decls) -> int:
    """The leaves the reference's `quantize_param_tree` quantizes, from
    the stacked shapes alone: float, ≥ 2 dims, ≥ 4,096 elements, no
    "norm" in the key path, and a contraction axis (−2) that is a
    multiple of the 32-weight group."""
    import math

    from repro_torch.nn import flatten_tree

    return sum(1 for name, d in flatten_tree(decls).items()
               if len(d.shape) >= 2 and math.prod(d.shape) >= QUANT_MIN_SIZE
               and "norm" not in name.lower() and d.dtype.is_floating_point
               and d.shape[-2] % QUANT_GROUP == 0)


def logit_gap(got, want) -> dict:
    """Max |got − want|, over max |want|, and how often their argmax
    agrees, on (..., V) logits."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return {"max_abs": diff, "scale": scale, "rel": diff / scale,
            "argmax_agree": agree}


def teacher_check(eng, prompts, tokens, steps, bound: float, what: str):
    """Each emitted token's logits (``steps``: the prefill's last row,
    then every decode step's) against one forward over the prompt and the
    generated prefix, in the engine's compute dtype."""
    import numpy as np
    import torch

    full = np.concatenate([prompts, tokens[:, :-1]], axis=1)
    logits, _ = eng.prefill(full)
    s = prompts.shape[1]
    gap = logit_gap(torch.stack(steps, 1), logits[:, s - 1:])
    check(gap["rel"] <= bound, f"{what}: decode logits {gap['rel']:.3g} of "
                               f"the scale from the teacher-forced forward, "
                               f"bound {bound}")
    return {**gap, "bound_rel": bound, "steps": len(steps)}


def lm_times(eng, prompts, decode_steps: int, new_tokens: int) -> dict:
    """Prefill and decode steps by CUDA events (each from an idle card,
    ended by a synchronise), and a warm `generate` by host clock."""
    import statistics

    import torch

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        return res, a.elapsed_time(b)

    pre = []
    for _ in range(3):
        (logits, state), ms = timed(lambda: eng.prefill(prompts))
        pre.append(ms)
    tok = logits[:, -1].argmax(-1)
    dec = []
    for _ in range(decode_steps):
        (logits, state), ms = timed(lambda: eng.decode(tok, state))
        dec.append(ms)
        tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, new_tokens).cpu()
    gen_s = time.perf_counter() - t0
    return {"prefill_ms": statistics.median(pre), "prefill_ms_all": pre,
            "decode_ms_median": statistics.median(dec),
            "decode_ms_all": dec, "generate_s_warm": gen_s,
            "tokens_per_s_warm": prompts.shape[0] * new_tokens / gen_s}


def param_bytes(tree) -> int:
    from repro_torch.nn import flatten_tree

    return sum(t.numel() * t.element_size()
               for t in flatten_tree(tree).values())


def free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def lm_leg(dev, smi) -> dict:
    """The language-model serving stack on the card (see the module
    notes); returns the phase's numbers and the four kernels' launches
    during it (zeroed just before)."""
    import numpy as np
    import torch

    from repro_torch.configs import all_configs, get_config
    from repro_torch.launch.serve import parser, serve_lm
    from repro_torch.nn import count_params, init_params, model_decls
    from repro_torch.serving import ServeEngine

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    bmm = importlib.import_module("repro_torch.kernels.blmac_matmul")
    # float32 means float32: no TF32 in any float32 leg below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    bf.reset_launch_counts()
    bmm.pulse_matmul.launches = 0
    t_leg = time.perf_counter()

    # -- 1. qwen2.5-3b at full width through the launcher ------------------
    t0 = time.perf_counter()
    run = serve_lm(parser().parse_args(LM_ARGV))
    launch_s = time.perf_counter() - t0
    cfg, eng, prompts = run.cfg, run.engine, run.prompts
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size) ==
          (36, 2048, 16, 2, 128, 11008, 151936) and cfg.tie_embeddings
          and cfg.attn_bias, f"not qwen2.5-3b's published widths: {cfg}")
    n_params = count_params(model_decls(cfg))
    nbytes = param_bytes(eng.params)
    check(nbytes == 4 * n_params, f"{nbytes} parameter bytes for "
                                  f"{n_params} float32 parameters")
    check(run.tokens.shape == (4, 16) and run.tokens.dtype == np.int32
          and run.tokens.min() >= 0 and run.tokens.max() < cfg.vocab_size,
          f"tokens {run.tokens.shape} {run.tokens.dtype}")
    toks, steps = eng.generate(prompts, 16, with_logits=True)
    toks = toks.cpu().numpy()
    tf_bf16 = teacher_check(eng, prompts, toks, steps, LM_BF16_REL,
                            "qwen2.5-3b bf16")
    zero = eng.generate(prompts, 0)
    check(tuple(zero.shape) == (4, 0) and zero.dtype == torch.int32,
          f"max_new_tokens=0 gave {tuple(zero.shape)} {zero.dtype}")
    times = lm_times(eng, prompts, 15, 16)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng32 = ServeEngine(cfg32, eng.params, cache_len=256, device=dev)
    toks32, steps32 = eng32.generate(prompts, 16, with_logits=True)
    toks32 = toks32.cpu().numpy()
    tf_f32 = teacher_check(eng32, prompts, toks32, steps32, LM_F32_REL,
                           "qwen2.5-3b float32")
    pre16, _ = eng.prefill(prompts)
    pre32, _ = eng32.prefill(prompts)
    bf16_vs_f32 = {"prefill": logit_gap(pre16, pre32),
                   "greedy_token_agreement": float((toks == toks32).mean())}
    times32 = lm_times(eng32, prompts, 15, 16)
    del eng32, pre16, pre32, steps, steps32
    state = {}

    def decode_step_fn():
        if not state or state["n"] >= 100:
            logits, state["s"] = eng.prefill(prompts)
            state["tok"], state["n"] = logits[:, -1].argmax(-1), 0
        logits, state["s"] = eng.decode(state["tok"], state["s"])
        state["tok"] = logits[:, -1].argmax(-1)
        state["n"] += 1

    decode_step_fn()
    idle = profile_step(decode_step_fn, 0, None, steps=5, reps=10)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # a float32 weight cast at use: read 4 bytes, write 2, read those 2
    cast_bound_ms = 2 * bound_ms
    qwen = {
        "argv": LM_ARGV, "params": n_params, "param_bytes": nbytes,
        "launcher_s": launch_s, "launcher_generate_s": run.seconds,
        "launcher_tokens_per_s": 4 * 16 / run.seconds,
        "tokens_shape": list(run.tokens.shape),
        "tokens_dtype": str(run.tokens.dtype),
        "repeat_tokens_equal": bool(np.array_equal(toks, run.tokens)),
        "decode_vs_teacher_bf16": tf_bf16,
        "decode_vs_teacher_f32": tf_f32, "bf16_vs_f32": bf16_vs_f32,
        "zero_new_tokens": [list(zero.shape), str(zero.dtype)],
        "bf16": times, "f32": times32,
        "decode_bound_ms_bytes": bound_ms,
        "decode_bound_ms_with_cast": cast_bound_ms,
        # the traced steps' float32 → bf16 weight casts, device ms a step
        "decode_cast_ms_per_step": sum(
            r["device_us"] for n, r in idle["kernels"].items()
            if "bfloat16_copy" in n) / 1e3 / idle["traced_steps"],
        "decode_share_of_bound": bound_ms / times["decode_ms_median"],
        "decode_idle": {k: v for k, v in idle.items() if k != "kernels"},
        "decode_kernels_top": sorted(
            ({"name": n[:80], **r} for n, r in idle["kernels"].items()),
            key=lambda r: -r["device_us"])[:8],
        "tf32": tf32, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi}
    emit({"phase": "lm_qwen", **qwen})
    tokens1 = run.tokens
    del run, eng, state
    free_cuda()

    # -- 2. the same model, CSD-4 fake-quantized ---------------------------
    runq = serve_lm(parser().parse_args(LM_ARGV + ["--quant-planes", "4"]))
    want_q = quantized_leaf_count(model_decls(runq.cfg))
    check(runq.quant_stats["n_quantized"] == want_q,
          f"{runq.quant_stats['n_quantized']} leaves quantized, the "
          f"reference's rule gives {want_q}")
    quant = {"n_quantized": want_q, "stats": runq.quant_stats,
             "quantize_s": runq.quant_seconds,
             "generate_s": runq.seconds,
             "greedy_token_agreement_vs_leg1": float(
                 (runq.tokens == tokens1).mean()),
             "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "lm_quant", **quant})
    del runq
    free_cuda()

    # -- 3. the SSD and RG-LRU paths at full width -------------------------
    full = {}
    for arch in LM_FULL_ARCHS:
        c = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(model_decls(c), gen, device=dev)
        pr = np.random.default_rng(0).integers(
            0, c.vocab_size, (4, 32)).astype(np.int32)
        row = {"params": count_params(model_decls(c))}
        for dt, bound in (("bfloat16", LM_BF16_REC_REL),
                          ("float32", LM_F32_REC_REL)):
            e = ServeEngine(dataclasses.replace(c, compute_dtype=dt), params,
                            cache_len=256, device=dev)
            tk, st = e.generate(pr, LM_FULL_NEW_TOKENS, with_logits=True)
            tk = tk.cpu().numpy()
            row[dt] = {"decode_vs_teacher": teacher_check(
                e, pr, tk, st, bound, f"{arch} {dt}"),
                **lm_times(e, pr, 7, LM_FULL_NEW_TOKENS)}
            row[dt]["prefill_logits"], _ = e.prefill(pr)
            row[dt]["tokens"] = tk
            del e, st
        pre = row["bfloat16"].pop("prefill_logits")
        pre32 = row["float32"].pop("prefill_logits")
        row["bf16_vs_f32"] = {
            "prefill": logit_gap(pre, pre32),
            "greedy_token_agreement": float(
                (row["bfloat16"].pop("tokens")
                 == row["float32"].pop("tokens")).mean())}
        full[arch] = {**row, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}
        del params, pre, pre32
        free_cuda()
    emit({"phase": "lm_full_recurrent", "tf32": tf32, **full})

    # -- 4. every arch reduced: the card against the CPU, float32 ----------
    reduced = {}
    for arch in sorted(all_configs()):
        c = get_config(arch).reduced(compute_dtype="float32")
        if c.input_kind == "embeds":
            c = dataclasses.replace(c, input_kind="tokens")
        params = init_params(model_decls(c),
                             torch.Generator().manual_seed(0), device="cpu")
        pr = np.random.default_rng(1).integers(
            0, c.vocab_size, (2, 16)).astype(np.int32)
        n = 1 + LM_REDUCED_DECODE_STEPS
        tc, lc = ServeEngine(c, params, 64, device="cpu").generate(
            pr, n, with_logits=True)
        tg, lg = ServeEngine(c, params, 64, device=dev).generate(
            pr, n, with_logits=True)
        gap = logit_gap(torch.stack(lg, 1).cpu(), torch.stack(lc, 1))
        same = bool(torch.equal(tg.cpu(), tc))
        check(gap["rel"] <= LM_F32_REL and same,
              f"{arch} reduced: card vs CPU {gap['rel']:.3g} of the scale "
              f"(bound {LM_F32_REL}), tokens equal {same}")
        reduced[arch] = {"rel": gap["rel"], "max_abs": gap["max_abs"],
                         "tokens_equal": same}
    emit({"phase": "lm_reduced_card_vs_cpu", "bound_rel": LM_F32_REL,
          "decode_steps": LM_REDUCED_DECODE_STEPS, "archs": reduced,
          "tf32": tf32})

    launches = {"bank_apply": bf.bank_apply.launches,
                "specialized_call": bf.specialized_call.launches,
                "combine_fold": bf.combine_fold.launches,
                "pulse_matmul": bmm.pulse_matmul.launches}
    check(not any(launches.values()),
          f"the lm path launched the FIR or pulse kernels: {launches}")
    return {"launches": launches, "wall_s": time.perf_counter() - t_leg,
            "qwen_decode_ms": times["decode_ms_median"],
            "qwen_prefill_ms": times["prefill_ms"]}


LEG_RESULT = "LEG_RESULT "
LM_LAUNCH_KEYS = {"blmac_bank_kernel": "bank_apply",
                  "blmac_specialized_kernel": "specialized_call",
                  "blmac_combine_kernel": "combine_fold",
                  K3_KERNEL: "pulse_matmul"}


def leg_child(flag: str) -> dict:
    """A phase in a fresh process on the card (``--lm-leg``,
    ``--train-leg``, ``--mesh-leg``): its timings free of this process's
    profiler phases, its tens of GB freed at its exit.  Its phase lines
    are printed here."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True, timeout=900,
                         cwd=HERE)
    out = res.stdout.splitlines()
    for ln in out:
        if not ln.startswith(LEG_RESULT):
            print(ln, flush=True)
    check(res.returncode == 0, f"{flag} exited {res.returncode}: "
                               f"{res.stderr[-3000:]}")
    got = [ln for ln in out if ln.startswith(LEG_RESULT)]
    check(len(got) == 1, f"{flag} printed no result")
    return json.loads(got[0][len(LEG_RESULT):])


# -- the train phase -----------------------------------------------------------
# `python -m repro_torch.launch.train --full-config`'s defaults for
# qwen2.5-3b (src/repro/launch/train.py): B = 16, S = 256
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 256, 5
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (data sheet)
TRAIN_LOSS_REL = 1e-3  # step 0's loss against a forward-only loss_fn
TRAIN_CARD_CPU_REL = 1e-4
TRAIN_LAUNCHER_ARGV = ["-m", "repro_torch.launch.train", "--arch",
                       "qwen2.5-3b", "--steps", "20"]
TRAIN_EXAMPLE_ARGV = ["examples/port_train_lm.py", "--size", "100m",
                      "--steps", "50"]
DP_SLOTS, DP_REL, DP_GRAD_REL = 4, 0.02, 0.05  # tests/test_collectives.py


def run_fresh(argv, what: str) -> list[str]:
    """``python argv`` in a fresh process from the repo root, the port on
    its path; its stdout lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    res = subprocess.run([sys.executable] + argv, env=env, cwd=HERE,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"{what} exited {res.returncode}: "
                               f"{res.stderr[-3000:]}")
    return [ln for ln in res.stdout.splitlines() if ln.strip()]


def train_full_width(dev, smi) -> dict:
    """qwen2.5-3b at its published widths: 5 AdamW steps on one repeated
    markov batch (see the module notes)."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.nn import (ShardCtx, count_params, init_params, loss_fn,
                                model_decls)
    from repro_torch.training import (OptHParams, TrainHParams,
                                      make_positions, make_train_step,
                                      train_state_init)
    from repro_torch.training.optimizer import (clip_by_global_norm,
                                                make_optimizer)
    from repro_torch.training.train_step import make_grad_fn

    cfg = get_config("qwen2.5-3b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
           cfg.compute_dtype, cfg.param_dtype, cfg.remat, cfg.optimizer) ==
          (36, 2048, 11008, 151936, "bfloat16", "float32", "full", "adamw"),
          f"not qwen2.5-3b's published training config: {cfg}")
    n_params = count_params(model_decls(cfg))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    t0 = time.perf_counter()
    params = init_params(model_decls(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                    kind="markov"))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.global_batch_at(0).items()}
    with torch.no_grad():
        fwd_loss, _ = loss_fn(params, batch, cfg, ShardCtx(
            positions=make_positions(batch), compute_dtype=torch.bfloat16))
    fwd_loss = fwd_loss.item()
    hp = TrainHParams(opt=OptHParams(learning_rate=TRAIN_LR,
                                     warmup_steps=TRAIN_WARMUP,
                                     total_steps=TRAIN_STEPS))
    state = train_state_init(params, cfg)
    step = make_train_step(cfg, hp)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, gnorms = [], [], []
    for _ in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + gnorms)),
          f"full width: loss {losses}, grad_norm {gnorms}")
    rel0 = abs(losses[0] - fwd_loss) / abs(fwd_loss)
    check(rel0 <= TRAIN_LOSS_REL, f"full width: step 0's loss {losses[0]} "
                                  f"vs forward-only {fwd_loss}")
    check(losses[-1] < losses[0], f"full width: loss {losses} does not fall "
                                  f"on one repeated batch")
    step_ms = statistics.median(ms[1:])
    flops_bound_ms = 8 * n_params * tokens / BF16_TC_FLOPS_PER_S * 1e3
    # the optimizer reads g, m, v, p and writes m, v, p: 7 float32 passes
    opt_bound_ms = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3

    # the step's three parts by CUDA events, each from an idle card, then
    # each traced alone, then a whole step traced: the same functions the
    # step composes, on its state
    _, opt_update = make_optimizer(cfg.optimizer)
    grad_fn = make_grad_fn(cfg, hp)
    parts = {}

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b), (time.perf_counter() - t) * 1e3

    (_, _, grads), parts["grads_ms"], parts["grads_host_ms"] = timed(
        lambda: grad_fn(state["params"], batch))
    _, parts["clip_ms"], parts["clip_host_ms"] = timed(
        lambda: clip_by_global_norm(grads, hp.opt.grad_clip))
    with torch.no_grad():
        _, parts["opt_ms"], parts["opt_host_ms"] = timed(lambda: opt_update(
            grads, state["opt"], state["params"], state["step"], hp.opt))

    def summary(trace):
        return {k: trace[k] for k in ("idle_share", "kernels_seen",
                                      "device_busy_us_per_step",
                                      "span_us_median")}

    traced = {
        "clip": summary(profile_step(
            lambda: clip_by_global_norm(grads, hp.opt.grad_clip), 0, None,
            steps=1, reps=1)),
        "optimizer": summary(profile_step(
            lambda: opt_update(grads, state["opt"], state["params"],
                               state["step"], hp.opt), 0, None, steps=1,
            reps=1))}
    del grads
    free_cuda()
    traced["grads"] = summary(profile_step(
        lambda: grad_fn(state["params"], batch), 0, None, steps=1, reps=1))

    def whole():
        step(state, batch)

    trace = profile_step(whole, 0, None, steps=2, reps=1)
    top = sorted(({"name": n[:80], **r} for n, r in trace["kernels"].items()),
                 key=lambda r: -r["device_us"])[:8]
    out = {
        "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "tokens_per_step": tokens, "steps": TRAIN_STEPS,
        "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP, "optimizer": "adamw",
        "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
        "remat": cfg.remat, "init_s": init_s,
        "forward_only_loss": fwd_loss, "step0_loss_rel": rel0,
        "losses": losses, "grad_norms": gnorms, "step_ms": ms,
        "step_ms_median_1_4": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "mfu": 6 * n_params * tokens / (step_ms * 1e-3 * BF16_TC_FLOPS_PER_S),
        "flops_bound_ms": flops_bound_ms, "optimizer_bytes_bound_ms":
        opt_bound_ms, "share_of_flops_bound": flops_bound_ms / step_ms,
        "peak_bytes": peak, "state_bytes": param_bytes(
            {"p": state["params"], "o": state["opt"]}),
        "checkpoint_bytes_not_written": param_bytes(state),
        "parts": parts, "parts_traced": traced,
        "step_traced": {k: v for k, v in trace.items() if k != "kernels"},
        "step_kernels_top": top,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    del state, params, batch, step
    free_cuda()
    return out


def train_loop_legs(dev) -> dict:
    """The launcher and the example in fresh processes, the launcher's
    checkpoint restored, and `TrainLoop`'s crash → resume on the card."""
    import torch

    from repro_torch.checkpoint import all_steps, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import SimulatedFailure, TrainLoop
    from repro_torch.nn import flatten_tree, model_decls
    from repro_torch.training import (OptHParams, TrainHParams,
                                      abstract_train_state)

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train") as d:
        t0 = time.perf_counter()
        lines = run_fresh(TRAIN_LAUNCHER_ARGV + ["--ckpt-dir", d],
                          "the train launcher")
        out["launcher_s"] = time.perf_counter() - t0
        last = lines[-1]
        check(last.startswith("[train] qwen2.5-3b: step 0 loss ")
              and " -> step 19 loss " in last, f"launcher said {last!r}")
        l0 = float(last.split("step 0 loss ")[1].split(" ")[0])
        l19 = float(last.split("step 19 loss ")[1].split(";")[0])
        check(l19 < l0, f"launcher: loss {l0} -> {l19}")
        cfg = get_config("qwen2.5-3b").reduced()
        state, step = restore_checkpoint(
            d, abstract_train_state(cfg, model_decls(cfg)), device=dev)
        leaves = flatten_tree(state)
        check(step == 20 and int(state["step"]) == 20 and all(
            t.device == dev and bool(torch.isfinite(t).all())
            for t in leaves.values()), "launcher checkpoint restore")
        out.update(launcher_line=last, launcher_loss=[l0, l19],
                   checkpoints=all_steps(d), restored_leaves=len(leaves))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example") as d:
        t0 = time.perf_counter()
        lines = run_fresh(TRAIN_EXAMPLE_ARGV + ["--ckpt-dir", d],
                          "examples/port_train_lm.py")
        out["example_s"] = time.perf_counter() - t0
        summary = [ln for ln in lines if ln.startswith("step 0: loss ")]
        check(len(summary) == 1, f"example said {lines!r}")
        first, last = (float(x.split("loss ")[1]) for x in
                       summary[0].split("  ->  "))
        check(last < first, f"example said {summary[0]!r}")
        out.update(example_lines=lines, example_loss=[first, last])

    # crash → resume, as tests/test_fault.py, on the card
    def mk(path):
        c = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=128,
                                             d_model=64, d_ff=128)
        hp = TrainHParams(opt=OptHParams(learning_rate=3e-3, warmup_steps=5,
                                         total_steps=40))
        return TrainLoop(c, hp, TokenPipeline(DataConfig(128, 8, 32, seed=1)),
                         path, ckpt_every=5, device=dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_crash") as d:
        a = mk(os.path.join(d, "a"))
        a.run(20)
        b = mk(os.path.join(d, "b"))
        try:
            b.run(20, fail_at=13)
            check(False, "the injected failure did not raise")
        except SimulatedFailure:
            pass
        b2 = mk(os.path.join(d, "b"))
        check(b2.step == 10, f"resumed at {b2.step}, want 10")
        b2.run(20)
        pa, pb = flatten_tree(a.state), flatten_tree(b2.state)
        same = [k for k in pa if torch.equal(pa[k], pb[k])]
        check(len(same) == len(pa), f"crash-resume: {len(pa) - len(same)} "
                                    f"leaves differ from the uninterrupted "
                                    f"run")
        out["crash_resume"] = {"bit_exact_leaves": len(same),
                               "losses_tail": [h["loss"] for h in
                                               b2.metrics_history[-3:]]}
    return out


def train_card_vs_cpu(dev) -> dict:
    """Every arch reduced, float32 with TF32 off, two steps on the card
    and on the CPU from one parameter tree (the first at the schedule's
    lr 0, the second at its peak): metrics, params and optimizer state
    within 1e-4 (`tests/torch_differential.py` `train_card_vs_cpu`, which
    the card tests run too; Adam's amplified rounding counted within its
    limits, as the CPU tests count it against the reference)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_differential import train_card_vs_cpu as card_vs_cpu

    from repro_torch.configs import all_configs

    out = card_vs_cpu(sorted(all_configs()), dev, bound=TRAIN_CARD_CPU_REL)
    bad = {arch: r for arch, r in out.items() if not r["ok"]}
    check(not bad, f"card vs CPU train step: {bad}")
    return out


def train_dp_allreduce(dev) -> dict:
    """`compressed_psum` and `make_compressed_dp_grad_fn` on four slots of
    the card against the exact mean and gradient (the reference's
    bounds)."""
    import numpy as np
    import torch

    from repro_torch.distributed import (compressed_psum,
                                         make_compressed_dp_grad_fn)

    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_normal((DP_SLOTS, 1 << 20)),
                     dtype=torch.float32, device=dev)
    got = compressed_psum(list(g))
    exact = g.mean(0)
    rel = max(float((x - exact).abs().max()) for x in got) / float(
        exact.abs().max())
    check(rel < DP_REL and all(x.device == dev for x in got),
          f"compressed_psum on {DP_SLOTS} card slots: {rel}")
    w = torch.tensor(rng.standard_normal((16, 4)), dtype=torch.float32,
                     device=dev)
    x = torch.tensor(rng.standard_normal((32, 16)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.standard_normal((32, 4)), dtype=torch.float32,
                     device=dev)

    def loss(w, batch):
        xx, yy = batch
        return torch.mean((xx @ w - yy) ** 2)

    _, gq = make_compressed_dp_grad_fn(loss, [dev] * DP_SLOTS)(w, (x, y))
    wt = w.clone().requires_grad_(True)
    ge, = torch.autograd.grad(loss(wt, (x, y)), wt)
    grel = float((gq - ge).abs().max() / ge.abs().max())
    check(grel < DP_GRAD_REL, f"compressed DP grads: {grel}")
    return {"slots": DP_SLOTS, "elements": g.shape[1], "psum_rel": rel,
            "bound": DP_REL, "dp_grad_rel": grel, "grad_bound": DP_GRAD_REL}


def train_leg(dev, smi) -> dict:
    """The language model's training half on the card (see the module
    notes); returns the phase's numbers and the four kernels' launches
    during it (zeroed just before)."""
    import torch

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    bmm = importlib.import_module("repro_torch.kernels.blmac_matmul")
    bf.reset_launch_counts()
    bmm.pulse_matmul.launches = 0
    t_leg = time.perf_counter()
    full = train_full_width(dev, smi)
    emit({"phase": "train_full_width", **full})
    loops = train_loop_legs(dev)
    emit({"phase": "train_loop", **loops, "nvidia_smi": smi})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cvc = train_card_vs_cpu(dev)
    emit({"phase": "train_reduced_card_vs_cpu",
          "bound_rel": TRAIN_CARD_CPU_REL, "steps": 2, "archs": cvc,
          "tf32": {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}})
    dp = train_dp_allreduce(dev)
    emit({"phase": "train_dp_allreduce", **dp, "nvidia_smi": smi})
    launches = {"bank_apply": bf.bank_apply.launches,
                "specialized_call": bf.specialized_call.launches,
                "combine_fold": bf.combine_fold.launches,
                "pulse_matmul": bmm.pulse_matmul.launches}
    check(not any(launches.values()),
          f"the train path launched the FIR or pulse kernels: {launches}")
    return {"launches": launches, "wall_s": time.perf_counter() - t_leg,
            "step_ms": full["step_ms_median_1_4"],
            "peak_bytes": full["peak_bytes"]}


# -- the mesh phase -----------------------------------------------------------
# a (2, 4) mesh of the card's slots; the full-width legs take the train
# phase's shape (B 16 × S 256, AdamW, bf16, remat) and the lm phase's
# (B 4, prompt 32, 16 new tokens, cache 256)
MESH_SHAPE, MESH_AXES = (2, 4), ("data", "model")
MESH_STEPS = TRAIN_STEPS
# two bf16 runs differ where bf16 rounding of a data slot's half of a
# gradient flips the sign of a near-zero element, and Adam turns each
# flip into an update of order lr (the first chip run found 0.265% of
# the elements so flipped after one update, over 1% of some layers'
# biases), so the bf16 params are not held element by element: each
# step's loss and grad norm are held to the unsharded run's (1e-3; two
# runs read at most 2.1e-4), and the direction of step 1's update (the
# first at a nonzero lr: the sign of each element's first moment) must
# agree in all but MESH_SIGN_FLIP_SHARE of the elements.  The params are
# held element by element in float32 (TF32 off), two steps (the
# schedule's lr 0, then its peak), at full width cut to
# MESH_CHECK_LAYERS layers so that both runs' states stay on the card:
# params and moments within 1e-4 of each layer's scale, under
# `train_tree_gap`'s limits; the reduced archs the same way
MESH_BF16_METRIC_REL = 1e-3
MESH_SIGN_FLIP_SHARE = 0.01
MESH_CHECK_STEPS, MESH_CHECK_LAYERS = 2, 8
MESH_TRAIN_REL = TRAIN_CARD_CPU_REL
MESH_LOSS_REL = TRAIN_LOSS_REL
MESH_SERVE_BATCH, MESH_PROMPT, MESH_NEW, MESH_CACHE = 4, 32, 16, 256
MESH_DECODE_TIMED = 8
MESH_REDUCED_REL = 1e-4


def _events_ms(fn):
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _layer_slices(tree: dict, cfg) -> dict:
    """A flat tree's stacked stage leaves cut into one leaf a layer, keyed
    ``…/stage<i>/<r>/<rest>`` (the leaf name stays last)."""
    from repro_torch.nn import stage_plan

    plan = stage_plan(cfg)
    out = {}
    for k, t in tree.items():
        parts = k.split("/")
        at = next((j for j, p in enumerate(parts) if p.startswith("stage")),
                  None)
        if at is None:
            out[k] = t
            continue
        pre, rest = "/".join(parts[:at + 1]), "/".join(parts[at + 1:])
        for r in range(plan[int(parts[at][5:])].repeat):
            out[f"{pre}/{r}/{rest}"] = t[r]
    return out


def _decode_ms(eng, prompts, n: int) -> list:
    """``n`` decode steps after a prefill, each by CUDA events."""
    logits, st = eng.prefill(prompts)
    tok = logits[:, -1].argmax(-1)
    ms = []
    for _ in range(n):
        (logits, st), t = _events_ms(lambda: eng.decode(tok, st))
        ms.append(t)
        tok = logits[:, -1].argmax(-1)
    return ms


def _qwen_train_setup(dev, compute_dtype, n_layers=None):
    """qwen2.5-3b's published config in ``compute_dtype`` (its depth cut
    to ``n_layers`` when given), its declarations, the train phase's
    hyperparameters and batch on ``dev``, and an init from a CUDA
    generator with seed 0."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.nn import init_params, model_decls
    from repro_torch.training import OptHParams, TrainHParams

    cfg = get_config("qwen2.5-3b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
           cfg.compute_dtype, cfg.param_dtype, cfg.remat, cfg.optimizer) ==
          (36, 2048, 11008, 151936, "bfloat16", "float32", "full", "adamw"),
          f"not qwen2.5-3b's published training config: {cfg}")
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                              n_layers=n_layers or cfg.n_layers)
    decls = model_decls(cfg)
    hp = TrainHParams(opt=OptHParams(learning_rate=TRAIN_LR,
                                     warmup_steps=TRAIN_WARMUP,
                                     total_steps=MESH_STEPS))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                    kind="markov"))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.global_batch_at(0).items()}

    def init():
        return init_params(decls, torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    return cfg, decls, hp, batch, init


def _mesh_state(cfg, decls, init, mesh, rules):
    """The train state of a fresh init placed on the mesh, leaf by leaf
    from the unplaced params (never two whole copies of the state)."""
    import torch

    from repro_torch.distributed import device_put, sanitized_shardings
    from repro_torch.nn import param_pspecs
    from repro_torch.training import train_state_init

    params = init()
    placed = device_put(params, sanitized_shardings(
        mesh, param_pspecs(decls, rules), params))
    del params
    free_cuda()
    state = train_state_init(placed, cfg)
    torch.cuda.synchronize()
    return state


def _m_signs(state, dev):
    """(leaf, the sign of each element of its first moment as int8 on
    ``dev``), one leaf at a time (a placed leaf gathered first)."""
    import torch

    from repro_torch.distributed import gather
    from repro_torch.nn import flatten_tree

    for k, t in flatten_tree(state["opt"]).items():
        if k.startswith("m/"):
            yield k, torch.sign(gather(t, dev)).to(torch.int8)


def _collective_totals() -> dict:
    """`COLLECTIVES` summed by kind over slots and groups."""
    from repro_torch.distributed.placement import COLLECTIVES

    out: dict = {}
    for (kind, _, _), rec in COLLECTIVES.items():
        mine = out.setdefault(kind, dict.fromkeys(rec, 0))
        for f, v in rec.items():
            mine[f] += v
    return out


def mesh_train_full(dev, smi, mesh) -> dict:
    """qwen2.5-3b at full width in bf16, 5 AdamW steps unsharded and then
    on the mesh from the same init, each by CUDA events; each step's
    loss and grad norm, and the direction of step 1's update, held to
    the unsharded run's (see the module notes)."""
    import statistics

    import torch

    from repro_torch.distributed import (TRAFFIC, batch_shardings,
                                         device_put, make_rules,
                                         reset_traffic)
    from repro_torch.distributed.placement import placed_bytes
    from repro_torch.nn import count_params
    from repro_torch.training import make_train_step, train_state_init

    cfg, decls, hp, batch, init = _qwen_train_setup(dev, "bfloat16")
    n_params = count_params(decls)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    traffic, coll = {}, {}

    def run(step, state, b, after_step1):
        ms, losses, gnorms = [], [], []
        reset_traffic()
        for i in range(MESH_STEPS):
            (state, m), t = _events_ms(lambda: step(state, b))
            ms.append(t)
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
            if i == 0:  # the bytes one step moved
                traffic.update(TRAFFIC)
                coll.clear()
                coll.update(_collective_totals())
            if i == 1:
                after_step1(state)
        return state, ms, losses, gnorms

    # the unsharded run: its step-1 update directions kept on the host
    # (its traced step is the train phase's `step_traced`: the same step)
    u_signs = {}
    walls = {}
    t_start = time.perf_counter()
    state = train_state_init(init(), cfg)
    ustep = make_train_step(cfg, hp)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    state, u_ms, u_loss, u_gn = run(ustep, state, batch, lambda st: (
        u_signs.update((k, v.cpu()) for k, v in _m_signs(st, dev))))
    u_peak = torch.cuda.max_memory_allocated()
    del state, ustep
    free_cuda()
    walls["unsharded"] = time.perf_counter() - t_start

    flips = {}

    def count_flips(st):
        for k, v in _m_signs(st, dev):
            flips[k] = (int((v != u_signs[k].to(dev)).sum()), v.numel())
        free_cuda()

    rules = make_rules(mesh, "train")
    t0 = time.perf_counter()
    state = _mesh_state(cfg, decls, init, mesh, rules)
    place_s = time.perf_counter() - t0
    sb = placed_bytes({"params": state["params"], "opt": state["opt"]})
    mbatch = device_put(batch, batch_shardings(mesh, rules, batch))
    step = make_train_step(cfg, hp, mesh, rules)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    state, m_ms, m_loss, m_gn = run(step, state, mbatch, count_flips)
    m_peak = torch.cuda.max_memory_allocated()
    walls["mesh"] = time.perf_counter() - t_start - walls["unsharded"]
    tr = profile_step(lambda: step(state, mbatch), 0, None, steps=1, reps=1)
    # one more step under `FlopCounterMode`: the FLOPs the dry run of
    # this cell must count (the `dryrun` phase)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step(state, mbatch)
    torch.cuda.synchronize()
    flops_counted = fc.get_total_flops()
    m_trace = {**{k: tr[k] for k in ("idle_share", "kernels_seen",
                                     "device_busy_us_per_step",
                                     "span_us_median", "wall_us_unprofiled")},
               "kernels_top": sorted(
                   ({"name": n[:80], **r} for n, r in tr["kernels"].items()),
                   key=lambda r: -r["device_us"])[:6]}
    del state, mbatch, step, u_signs, tr
    free_cuda()
    walls["traced_step"] = (time.perf_counter() - t_start
                            - walls["unsharded"] - walls["mesh"])
    u_med, m_med = statistics.median(u_ms[1:]), statistics.median(m_ms[1:])
    rel0 = abs(m_loss[0] - u_loss[0]) / abs(u_loss[0])
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(m_loss, u_loss)]
    gn_rel = [abs(a - b) / abs(b) for a, b in zip(m_gn, u_gn)]
    n_flip = sum(f for f, _ in flips.values())
    n_all = sum(n for _, n in flips.values())
    worst_flips = sorted(((k[2:], f / n) for k, (f, n) in flips.items()),
                         key=lambda kv: -kv[1])[:6]
    out = {
        "arch": cfg.name, "params": n_params, "mesh": dict(mesh.shape),
        "slot_devices": sorted({str(d) for d in mesh.devices.flat}),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MESH_STEPS,
        "lr": TRAIN_LR, "compute_dtype": cfg.compute_dtype,
        "remat": cfg.remat,
        "unsharded": {"step_ms": u_ms, "step_ms_median_1_4": u_med,
                      "losses": u_loss, "grad_norms": u_gn,
                      "peak_bytes": u_peak,
                      "tokens_per_s": tokens / u_med * 1e3,
                      "traced": "train_full_width's step_traced"},
        "mesh_run": {"step_ms": m_ms, "step_ms_median_1_4": m_med,
                     "losses": m_loss, "grad_norms": m_gn,
                     "peak_bytes": m_peak,
                     "tokens_per_s": tokens / m_med * 1e3,
                     "traced": m_trace},
        "mesh_over_unsharded": m_med / u_med,
        "step0_loss_rel": rel0, "loss_bound_rel": MESH_LOSS_REL,
        "loss_rel_by_step": loss_rel, "grad_norm_rel_by_step": gn_rel,
        "metrics_bound_rel": MESH_BF16_METRIC_REL,
        "step1_update_sign_flips": {
            "elements": n_all, "flipped": n_flip, "share": n_flip / n_all,
            "bound_share": MESH_SIGN_FLIP_SHARE,
            "worst_leaves": worst_flips},
        "state_bytes_total": sb["total"],
        "state_bytes_per_slot": sb["per_slot"],
        "gather_bytes_per_step": traffic["gather_bytes"],
        "reduce_scatter_bytes_per_step": traffic["reduce_scatter_bytes"],
        "collectives_per_step": coll,
        "flops_counted_step": flops_counted,
        "place_s": place_s, "wall_s": walls,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "mesh_train_full", **out})
    check(all(map(math.isfinite, m_loss + m_gn + u_loss + u_gn)),
          f"loss {u_loss} / {m_loss}, grad_norm {u_gn} / {m_gn}")
    check(rel0 <= MESH_LOSS_REL, f"mesh: step 0's loss {m_loss[0]} vs "
                                 f"unsharded {u_loss[0]}")
    check(max(loss_rel + gn_rel) <= MESH_BF16_METRIC_REL,
          f"mesh bf16 loss / grad norm vs unsharded by step: {loss_rel} / "
          f"{gn_rel}, bound {MESH_BF16_METRIC_REL}")
    check(n_flip <= MESH_SIGN_FLIP_SHARE * n_all,
          f"mesh bf16 step 1's update direction differs from the unsharded "
          f"run's in {n_flip} of {n_all} elements (worst {worst_flips})")
    check(m_loss[-1] < m_loss[0], f"mesh: loss {m_loss} does not fall")
    return out


# the dry run of the mesh phase's train cell, held against its measured
# step: FLOPs and the collectives' bytes exactly, the memory of every
# slot on one card within DRYRUN_MEM_REL of the card's peak (and the
# one-slot trace's upper bound on it within DRYRUN_ONE_SLOT_OVER); the launcher
# as a user runs it, one production cell
DRYRUN_MEM_REL = 0.10
# the one-slot trace's figure for the same memory (every per-device
# figure comes from that trace) is an upper bound on it, at most this
# far above (tests/test_torch_dryrun_slots.py's MEM_OVER for a train step)
DRYRUN_ONE_SLOT_OVER = 1.35
# the launcher's cell: decode (a train_4k cell traces each of its 16
# model slots' attention and takes minutes of host)
DRYRUN_ARGV = ["-m", "repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
               "--shape", "decode_32k"]


def mesh_dryrun(dev, smi, train) -> dict:
    """The port's dry run (`repro_torch.launch.dryrun`) of
    `mesh_train_full`'s cell — qwen2.5-3b at full width, B 16 × 256,
    bf16, remat, AdamW, a (2, 4) mesh — on ``meta`` slots with every slot
    traced, against that phase's measured step on the card's slots: its
    FLOPs against `FlopCounterMode`'s count of a real step, its
    all-gather and reduce-scatter bytes against `TRAFFIC`, its
    all-reduces (the tensor-parallel products' over ``model``, the
    clip's) against the step's `COLLECTIVES`, the memory of
    every slot on one device against the peak the card allocated, its
    ops against the traced step's kernels and its terms against the
    step's milliseconds (printed, not held); then ``python -m
    repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k`` in
    a fresh process (its wall seconds and lines), and the card's memory
    beside the constant the dry run prices against."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import CARD, run_cell
    from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                         PEAK_FLOPS_BF16)

    cfg, _, hp, _, _ = _qwen_train_setup(dev, "bfloat16")
    t0 = time.perf_counter()
    dry = run_cell(cfg.name, ShapeSpec("mesh_train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"),
                   mesh_shape=MESH_SHAPE, hp=hp, all_slots=True,
                   out_dir=None)
    host_s = time.perf_counter() - t0
    run = train["mesh_run"]
    raw = dry["collective_raw_total"]
    gathered = raw["all-gather"]["result_bytes"]
    scattered = raw["reduce-scatter"]["operand_bytes"]
    reduced = raw.get("all-reduce", {})
    step_reduced = train["collectives_per_step"].get("all-reduce", {})
    peak = run["peak_bytes"]
    step_ms = run["step_ms_median_1_4"]
    kernels = run["traced"]["kernels_seen"]
    # the whole mesh on one card: its totals against the card's rates
    one_card = {"compute_s": dry["op_flops_total"] / PEAK_FLOPS_BF16,
                "memory_fused_s": dry["op_hbm_bytes_total"] / HBM_BW,
                "memory_eager_s": dry["kernel_bytes_total"] / HBM_BW}
    t0 = time.perf_counter()
    lines = run_fresh(DRYRUN_ARGV, "python -m repro_torch.launch.dryrun")
    cli_s = time.perf_counter() - t0
    props = torch.cuda.get_device_properties(0)
    out = {
        "cell": {"arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                 "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
                 "optimizer": cfg.optimizer},
        "dryrun_host_s": host_s, "dryrun_trace_s": dry["trace_s"],
        "dryrun_trace_all_slots_s": dry["trace_all_slots_s"],
        "flops": {"dryrun": dry["op_flops_total"],
                  "flop_counter_mode": train["flops_counted_step"]},
        "gather_bytes": {"dryrun": gathered,
                         "traffic": train["gather_bytes_per_step"]},
        "reduce_scatter_bytes": {"dryrun": scattered,
                                 "traffic":
                                 train["reduce_scatter_bytes_per_step"]},
        "all_reduce": {"dryrun": reduced, "collectives": step_reduced},
        "mem_one_device_bytes": {"dryrun": dry["mem_one_device_bytes"],
                                 "max_memory_allocated": peak,
                                 "rel": dry["mem_one_device_bytes"] / peak
                                 - 1, "bound_rel": DRYRUN_MEM_REL,
                                 "one_slot_trace":
                                 dry["mem_one_device_bytes_one_slot"],
                                 "one_slot_rel":
                                 dry["mem_one_device_bytes_one_slot"]
                                 / peak - 1,
                                 "one_slot_bound": DRYRUN_ONE_SLOT_OVER},
        "ops_vs_launches": {"dryrun_ops": dry["ops_total"],
                            "traced_kernels": kernels,
                            "ratio": dry["ops_total"] / kernels},
        "terms_vs_step": {"step_ms": step_ms,
                          "per_device": {k: dry[f"{k}_term_s"] for k in
                                         ("compute", "memory", "collective")},
                          "one_card": one_card,
                          "step_over_largest_one_card_term":
                          step_ms / 1e3 / max(one_card.values())},
        "per_device": {k: dry[k] for k in (
            "op_flops_per_dev", "op_hbm_bytes_per_dev",
            "collective_bytes_per_dev", "ops_per_dev",
            "kernel_bytes_per_dev", "mem_per_device_bytes", "dominant")},
        "launcher": {"argv": DRYRUN_ARGV, "wall_s": cli_s, "lines": lines},
        "card_total_memory_bytes": props.total_memory,
        "hbm_bytes_constant": HBM_BYTES, "nvlink_bw_constant": NVLINK_BW,
        "priced_against": CARD,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "mesh_dryrun", **out})
    check(dry["op_flops_total"] == train["flops_counted_step"],
          f"dry run FLOPs {dry['op_flops_total']} vs FlopCounterMode's "
          f"{train['flops_counted_step']}")
    check(gathered == train["gather_bytes_per_step"]
          and scattered == train["reduce_scatter_bytes_per_step"],
          f"dry run collective bytes {gathered} / {scattered} vs TRAFFIC "
          f"{train['gather_bytes_per_step']} / "
          f"{train['reduce_scatter_bytes_per_step']}")
    check(reduced and reduced == step_reduced,
          f"dry run all-reduce {reduced} vs the step's COLLECTIVES "
          f"{step_reduced}")
    check(abs(out["mem_one_device_bytes"]["rel"]) <= DRYRUN_MEM_REL,
          f"dry run memory {dry['mem_one_device_bytes']} vs the card's "
          f"peak {peak}")
    one_slot = dry["mem_one_device_bytes_one_slot"]
    check(peak <= one_slot <= DRYRUN_ONE_SLOT_OVER * peak,
          f"the one-slot trace's memory {one_slot} is not an upper bound "
          f"within {DRYRUN_ONE_SLOT_OVER}x on the card's peak {peak}")
    check(any(ln.startswith("[dryrun] OK   qwen2.5-3b × decode_32k")
              for ln in lines), f"the dry run's launcher printed {lines}")
    return out


def mesh_train_check(dev, smi, mesh) -> dict:
    """qwen2.5-3b at full width cut to MESH_CHECK_LAYERS layers, float32
    (TF32 off), two steps unsharded and two on the mesh from the same
    init, both states on the card: the metrics, and the params and
    optimizer state a layer at a time (a stacked leaf's layer is a leaf
    of its own here, its scale the layer's), against the unsharded run's
    (`train_tree_gap`; the largest gap held to the bound with its
    headroom, the loose elements' largest, the amplified elements' count
    and share by layer)."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_differential import adam_drift_bound, train_tree_gap

    from repro_torch.distributed import (batch_shardings, device_put,
                                         gather, make_rules)
    from repro_torch.nn import count_params, flatten_tree
    from repro_torch.training import make_train_step, train_state_init

    cfg, decls, hp, batch, init = _qwen_train_setup(dev, "float32",
                                                    MESH_CHECK_LAYERS)
    ref = train_state_init(init(), cfg)
    step = make_train_step(cfg, hp)
    u_met = []
    for _ in range(MESH_CHECK_STEPS):
        ref, m = step(ref, batch)
        u_met.append({k: v.item() for k, v in m.items()})
    del step
    free_cuda()
    rules = make_rules(mesh, "train")
    state = _mesh_state(cfg, decls, init, mesh, rules)
    mbatch = device_put(batch, batch_shardings(mesh, rules, batch))
    step = make_train_step(cfg, hp, mesh, rules)
    m_met = []
    for _ in range(MESH_CHECK_STEPS):
        state, m = step(state, mbatch)
        m_met.append({k: v.item() for k, v in m.items()})
    del step, mbatch
    free_cuda()
    met_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2)
                  for a, b in zip(m_met, u_met) for k in b)
    t0 = time.perf_counter()
    drift = adam_drift_bound(hp.opt, range(MESH_CHECK_STEPS))
    gp = {"worst": 0.0, "worst_leaf": None, "loose_worst": 0.0,
          "loose_worst_leaf": None, "amplified": 0, "amplified_max": 0.0}
    by_layer = {}
    go = {"worst": 0.0, "worst_leaf": None}
    mine = _layer_slices(flatten_tree(
        {"params": state["params"], "opt": state["opt"]}), cfg)
    theirs = _layer_slices(flatten_tree(
        {"params": ref["params"], "opt": ref["opt"]}), cfg)
    for key, t in mine.items():
        if not key.startswith("params/"):
            continue
        leaf = key[len("params/"):]
        moms = {f"{mom}/{leaf}": f"opt/{mom}/{leaf}" for mom in ("m", "v")}
        mo = {k: gather(mine[v], dev) for k, v in moms.items()}
        ro = {k: theirs[v] for k, v in moms.items()}
        g = train_tree_gap({leaf: gather(t, dev)}, {leaf: theirs[key]},
                           MESH_TRAIN_REL, opt=(mo, ro), drift=drift)
        o = train_tree_gap(mo, ro, MESH_TRAIN_REL)
        for acc, new, w in ((gp, g, "worst"), (gp, g, "loose_worst"),
                            (go, o, "worst")):
            if new[w] > acc[w]:
                acc[w], acc[f"{w}_leaf"] = new[w], new[f"{w}_leaf"]
        gp["amplified"] += g["amplified"]
        gp["amplified_max"] = max(gp["amplified_max"], g["amplified_max"])
        by_layer.update(g["amplified_by_leaf"])
    compare_s = time.perf_counter() - t0
    del state, ref, mine, theirs
    free_cuda()
    out = {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
           "n_layers": cfg.n_layers, "params": count_params(decls),
           "steps": MESH_CHECK_STEPS, "bound_rel": MESH_TRAIN_REL,
           "losses_unsharded": [m["loss"] for m in u_met],
           "losses_mesh": [m["loss"] for m in m_met], "metrics_rel": met_rel,
           "params_gap": {**gp, "drift": drift, "compared_per": "layer",
                          "headroom": MESH_TRAIN_REL / max(gp["worst"],
                                                           1e-30),
                          "amplified_layers": len(by_layer),
                          "amplified_by_layer": {
                              k: [n, share] for k, (n, share)
                              in sorted(by_layer.items())}},
           "opt_gap": go, "compare_s": compare_s, "nvidia_smi": smi}
    emit({"phase": "mesh_train_check", **out})
    check(met_rel <= MESH_TRAIN_REL and gp["worst"] <= MESH_TRAIN_REL
          and go["worst"] <= MESH_TRAIN_REL,
          f"float32 mesh vs unsharded: metrics {met_rel}, params {gp}, "
          f"optimizer state {go}")
    return out


def _serve_vs(cfg, params, mesh, prompts, cache_check, dev) -> dict:
    """``cfg`` served on the mesh in decode rules, bf16 and float32,
    against the unsharded engine on the card: the mesh's prefill and
    MESH_NEW − 1 decode steps teacher-forced by the unsharded engine's
    greedy tokens, each decode step by CUDA events (where every argmax
    agrees, the mesh's own greedy tokens are those tokens), the logits
    within 5% / 1e-4 of their scale, every float32 argmax equal;
    ``cache_check(state)`` looks at the prefill's placed caches."""
    import statistics

    import torch

    from repro_torch.distributed import make_rules
    from repro_torch.serving import ServeEngine

    rules = make_rules(mesh, "decode", prompts.shape[0])
    out = {"mesh": dict(mesh.shape), "rules": {
        k: rules[k] for k in ("batch", "cache_seq", "kv_heads", "d_model")},
        "batch": prompts.shape[0], "prompt": prompts.shape[1],
        "new_tokens": MESH_NEW, "cache_len": MESH_CACHE}
    for dtype, bound in (("bfloat16", LM_BF16_REL), ("float32", LM_F32_REL)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        plain = ServeEngine(c, params, MESH_CACHE, device=dev)
        ptok, plog = plain.generate(prompts, MESH_NEW, with_logits=True)
        p_ms = _decode_ms(plain, prompts, MESH_DECODE_TIMED)
        del plain
        eng = ServeEngine(c, params, MESH_CACHE, mesh=mesh, rules=rules)
        logits, st = eng.prefill(prompts)
        cache_check(st)
        steps, m_ms = [logits[:, -1]], []
        for i in range(MESH_NEW - 1):  # teacher-forced by plain's tokens
            (logits, st), t = _events_ms(lambda: eng.decode(ptok[:, i], st))
            m_ms.append(t)
            steps.append(logits[:, -1])
        gap = logit_gap(torch.stack(steps, 1), torch.stack(plog, 1))
        check(gap["rel"] <= bound, f"{cfg.name} mesh {dtype} decode logits "
                                   f"{gap['rel']:.3g} of the scale from the "
                                   f"unsharded engine's, bound {bound}")
        agree = gap["argmax_agree"]
        if dtype == "float32":
            check(agree == 1.0, f"{cfg.name} mesh float32 greedy tokens "
                                f"differ: {agree}")
        del st, logits, steps, eng
        free_cuda()
        out[dtype] = {"logits_vs_unsharded": {**gap, "bound_rel": bound},
                      "argmax_agreement_teacher_forced": agree,
                      "decode_ms_median": statistics.median(m_ms),
                      "decode_ms_all": m_ms,
                      "unsharded_decode_ms_median": statistics.median(p_ms),
                      "unsharded_decode_ms_all": p_ms}
    return out


def mesh_serve_full(dev, smi, mesh) -> dict:
    """qwen2.5-3b at full width served on the mesh in decode rules (the
    batch over data, the caches' ring over model), bf16 and float32,
    against the unsharded engine on the card (`_serve_vs`)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn import init_params, model_decls

    cfg = get_config("qwen2.5-3b")
    params = init_params(model_decls(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_SERVE_BATCH, MESH_PROMPT)).astype(np.int32)

    def ring(st):
        k = st["caches"][0][0]["k"]
        check(len(k.groups()) == 8 and k.spec[3] == "model",
              f"decode caches not split over the ring: {k.spec}")

    out = {"arch": cfg.name, **_serve_vs(cfg, params, mesh, prompts, ring,
                                         dev)}
    del params
    free_cuda()
    return {**out, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi}


# the second half of item 8d on the card: each block kind at its
# published widths, its depth cut so that the unsharded and the mesh
# runs' states fit the card one after the other (float32 master
# weights, bf16 compute, remat, the arch's own optimizer), two train
# steps of the train phase's shape each way and the serve check
MESH_BLOCK_CELLS = {
    "mixtral-8x22b": {"n_layers": 1},  # 8 experts over model, 2 a slot
    "deepseek-v3-671b": {"n_layers": 3},  # its 3 dense layers: MLA
    "recurrentgemma-2b": {"n_layers": 3},  # one (R, R, A) pattern
    "mamba2-370m": {"n_layers": 8},  # SSD: 32 heads, 8 a slot
}
MESH_BLOCK_STEPS = 2
MESH_WORST_LEAVES = 4  # the leaves a cell names, most flipped first
# cells whose step-1 update direction is held in float32 (TF32 off),
# both runs' bf16 directions reported beside it: bf16 rounding that the
# unsharded run cannot share moves more than 1% of the directions there
# while the float32 runs agree to 1e-6 (H100 80GB HBM3, 700 W; this
# script and benchmarks/port_mesh_flips.py): mixtral's top-k routes
# 0.51% of the routed slots to other experts (1.66% flipped, every layer
# below the FFN); mamba2's SSD backward amplifies its row-parallel
# out_proj's bf16 partial sums, the only part of its forward that
# differs (1.40% flipped on (1, 4) and (2, 4) slots, 0.15% on (2, 1):
# data parallelism alone)
MESH_DIRECTION_F32 = ("mixtral-8x22b", "mamba2-370m")


def _update_signs(params, decls, dev):
    """(leaf, the sign of each element's step-1 update as int8 on
    ``dev``), one leaf at a time: the params after step 1 (gathered when
    placed) less the init they started from (step 0 runs at lr 0), the
    init drawn again leaf by leaf from the CUDA generator's seed 0 as
    `init_params` draws it."""
    import torch

    from repro_torch.distributed import gather
    from repro_torch.nn import flatten_tree
    from repro_torch.nn.common import _draw

    gen = torch.Generator(device=dev).manual_seed(0)
    now = flatten_tree(params)
    for k, d in flatten_tree(decls).items():
        p0 = _draw(d, gen, dev)
        yield k, torch.sign(gather(now[k], dev) - p0).to(torch.int8)
        del p0


def _cell_steps(step, state, batch, after_step1) -> tuple:
    """MESH_BLOCK_STEPS steps (each by CUDA events, the peak memory from
    a reset), then one more under `FlopCounterMode` and `torch.profiler`:
    (state, ms, losses, grad norms, peak bytes, the one step's FLOPs and
    kernels, the `COLLECTIVES` and `TRAFFIC` of the first step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import TRAFFIC, reset_traffic

    ms, losses, gnorms, coll, traffic = [], [], [], {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_traffic()
    for i in range(MESH_BLOCK_STEPS):
        (state, m), t = _events_ms(lambda: step(state, batch))
        ms.append(t)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        if i == 0:
            coll.update(_collective_totals())
            traffic.update(TRAFFIC)
        if i == 1:
            after_step1(state)
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as fc, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return (state, ms, losses, gnorms, peak, fc.get_total_flops(), kernels,
            coll, traffic)


@contextlib.contextmanager
def _routes():
    """A list the MoE's top-k appends each forward's routed experts to
    (a recompute's and a traced step's too)."""
    import torch

    from repro_torch.nn import moe

    seen, real = [], moe.top_k

    def spy(x, k):
        v, i = real(x, k)
        if torch.is_grad_enabled():
            seen.append(i.detach().reshape(-1, k).sort(-1).values)
        return v, i

    moe.top_k = spy
    try:
        yield seen
    finally:
        moe.top_k = real


def _train_pair(cfg, decls, dev, mesh, batch) -> dict:
    """MESH_BLOCK_STEPS train steps of ``cfg`` unsharded and then on the
    mesh from the same init (`_cell_steps` each), and where step 1's
    update direction (`_update_signs`) differs; for an MoE config, the
    share of the first step's routed slots whose experts differ (the
    first MoE layer's forward: the unsharded run's groups against the
    data slots' in order)."""
    import torch

    from repro_torch.distributed import (batch_shardings, device_put,
                                         make_rules)
    from repro_torch.distributed.placement import data_slots
    from repro_torch.nn import init_params, stage_plan
    from repro_torch.training import (OptHParams, TrainHParams,
                                      make_train_step, train_state_init)

    hp = TrainHParams(opt=OptHParams(learning_rate=TRAIN_LR,
                                     warmup_steps=TRAIN_WARMUP,
                                     total_steps=MESH_BLOCK_STEPS + 1))

    def init():
        return init_params(decls, torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    u_signs, flips = {}, {}
    with _routes() as u_routes:
        state = train_state_init(init(), cfg)
        free_cuda()
        u = _cell_steps(make_train_step(cfg, hp), state, batch,
                        lambda st: u_signs.update(
                            (k, v.cpu()) for k, v in _update_signs(
                                st["params"], decls, dev)))
    u_first = u_routes[:1]
    del state, u_routes
    u = u[1:]
    free_cuda()

    def count_flips(st):
        for k, v in _update_signs(st["params"], decls, dev):
            flips[k] = (int((v != u_signs[k].to(dev)).sum()), v.numel())
        free_cuda()

    rules = make_rules(mesh, "train")
    with _routes() as m_routes:
        state = _mesh_state(cfg, decls, init, mesh, rules)
        mbatch = device_put(batch, batch_shardings(mesh, rules, batch))
        step = make_train_step(cfg, hp, mesh, rules)
        free_cuda()
        m = _cell_steps(step, state, mbatch, count_flips)
    # a forward records its MoE layers in order, the mesh's data slot
    # by data slot: the first layer's of each
    n_moe = sum(st.repeat * sum(mt.ffn == "moe" for mt in st.metas)
                for st in stage_plan(cfg))
    rerouted = None
    if u_first:
        a = u_first[0]
        b = torch.cat([m_routes[d * n_moe] for d in range(len(data_slots(
            mesh, rules, TRAIN_BATCH)))]).to(a.device)
        rerouted = float((a != b).any(-1).float().mean())
    specs = {k: tuple(x.spec) for k, x in _mixer_leaves(m[0]["params"])}
    del state, mbatch, step, m_routes
    m = m[1:]
    free_cuda()
    n_flip = sum(f for f, _ in flips.values())
    n_all = sum(n for _, n in flips.values())
    keys = ("step_ms", "losses", "grad_norms", "peak_bytes",
            "flops_a_step", "kernels_a_step")
    return {"unsharded": dict(zip(keys, u[:6])),
            "mesh_run": dict(zip(keys, m[:6])),
            "collectives_first_step": m[6], "traffic_first_step": m[7],
            "loss_rel_by_step": [abs(a - b) / abs(b)
                                 for a, b in zip(m[1], u[1])],
            "grad_norm_rel_by_step": [abs(a - b) / abs(b)
                                      for a, b in zip(m[2], u[2])],
            "step1_update_sign_flips": {
                "elements": n_all, "flipped": n_flip,
                "share": n_flip / n_all,
                "bound_share": MESH_SIGN_FLIP_SHARE,
                "worst_leaves": sorted(
                    ((k, f / n) for k, (f, n) in flips.items()),
                    key=lambda kv: -kv[1])[:MESH_WORST_LEAVES]},
            "routed_slots_rerouted_step0": rerouted,
            "mixer_specs_train": specs}


def mesh_block_cell(dev, smi, mesh, arch: str) -> dict:
    """``arch`` at its published widths cut to MESH_BLOCK_CELLS' depth:
    MESH_BLOCK_STEPS bf16 train steps unsharded and then on the mesh from
    the same init (the train phase's batch and schedule, `_train_pair`),
    every step's loss and grad norm held to the unsharded run's (1e-3)
    and the direction of step 1's update agreeing in all but 1% of the
    elements, in float32 for MESH_DIRECTION_F32's cells (bf16's reported
    beside it).  Then served on the mesh against the
    unsharded engine (`_serve_vs`), its caches checked cut over model.
    Each run's step and decode ms, kernels a step and peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.nn import count_params, init_params, model_decls

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **MESH_BLOCK_CELLS[arch])
    decls = model_decls(cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                    kind="markov"))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.global_batch_at(0).items()}
    bf = _train_pair(cfg, decls, dev, mesh, batch)
    f32 = _train_pair(dataclasses.replace(cfg, compute_dtype="float32"),
                      decls, dev, mesh, batch) \
        if arch in MESH_DIRECTION_F32 else None
    held = (f32 or bf)["step1_update_sign_flips"]
    train_s = time.perf_counter() - t_start

    params = init_params(decls, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_SERVE_BATCH, MESH_PROMPT)).astype(np.int32)

    def where(st):  # each layer's cache cut over model as the rules say
        for stage in st["caches"]:
            for slot in stage:
                for k, x in slot.items():
                    if k in ("state", "h", "conv_tail", "c_kv", "k", "v"):
                        check("model" in tuple(x.spec), f"{arch} cache "
                              f"{k} {tuple(x.spec)} not cut over model")

    t0 = time.perf_counter()
    serve = _serve_vs(cfg, params, mesh, prompts, where, dev)
    del params
    free_cuda()
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "params": count_params(decls), "mesh": dict(mesh.shape),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "optimizer":
           cfg.optimizer, "compute_dtype": cfg.compute_dtype, **bf,
           "metrics_bound_rel": MESH_BF16_METRIC_REL,
           "update_direction_held_in": "float32" if f32 else "bfloat16",
           "float32": None if f32 is None else {
               k: f32[k] for k in ("step1_update_sign_flips",
                                   "routed_slots_rerouted_step0",
                                   "loss_rel_by_step",
                                   "grad_norm_rel_by_step")},
           "serve": serve, "wall_s": {"train": train_s,
                                      "serve": time.perf_counter() - t0},
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "mesh_block_cell", **out})
    u, m = bf["unsharded"], bf["mesh_run"]
    check(all(map(math.isfinite, m["losses"] + m["grad_norms"]
                  + u["losses"] + u["grad_norms"])),
          f"{arch}: loss {u['losses']} / {m['losses']}, grad_norm "
          f"{u['grad_norms']} / {m['grad_norms']}")
    worst = max(bf["loss_rel_by_step"] + bf["grad_norm_rel_by_step"])
    check(worst <= MESH_BF16_METRIC_REL,
          f"{arch} mesh bf16 loss / grad norm vs unsharded: {worst}, bound "
          f"{MESH_BF16_METRIC_REL}")
    check(held["flipped"] <= MESH_SIGN_FLIP_SHARE * held["elements"],
          f"{arch} mesh step 1's update direction "
          f"({out['update_direction_held_in']}) differs from the "
          f"unsharded run's in {held['flipped']} of {held['elements']} "
          f"elements ({held['worst_leaves']})")
    return out


def _mixer_leaves(params):
    """The placed mixer and FFN weights of the first stage's first slot,
    and of an MoE FFN wherever it is."""
    from repro_torch.nn import flatten_tree

    return [(k, x) for k, x in flatten_tree(params).items()
            if (k.startswith("stage0/slot0/") or "/ffn/" in k and "gate" in k)
            and "norm" not in k]


def mesh_block_dryrun(cell: dict) -> dict:
    """The dry run of the mixtral cell (1 layer, its experts over
    ``model``) on (2, 4) ``meta`` slots, every slot traced, against its
    measured mesh step: FLOPs equal to `FlopCounterMode`'s count of a
    real step, and every collective kind's calls, operand and result
    bytes equal to the step's `COLLECTIVES` (its all-gathers and
    reduce-scatters the weights' `TRAFFIC`)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.training import OptHParams, TrainHParams

    arch = cell["arch"]
    cfg = dataclasses.replace(get_config(arch), **MESH_BLOCK_CELLS[arch])
    hp = TrainHParams(opt=OptHParams(learning_rate=TRAIN_LR,
                                     warmup_steps=TRAIN_WARMUP,
                                     total_steps=MESH_BLOCK_STEPS + 1))
    t0 = time.perf_counter()
    dry = run_cell(arch, ShapeSpec("mesh_block", TRAIN_SEQ, TRAIN_BATCH,
                                   "train"), mesh_shape=MESH_SHAPE, hp=hp,
                   all_slots=True, out_dir=None, cfg=cfg)
    raw = dry["collective_raw_total"]
    coll, traffic = cell["collectives_first_step"], cell["traffic_first_step"]
    out = {"arch": arch, "host_s": time.perf_counter() - t0,
           "flops": {"dryrun": dry["op_flops_total"],
                     "flop_counter_mode": cell["mesh_run"]["flops_a_step"]},
           "collectives": {"dryrun": raw, "step": coll},
           "traffic": {"dryrun_all_gather_result":
                       raw.get("all-gather", {}).get("result_bytes"),
                       "dryrun_reduce_scatter_operand":
                       raw.get("reduce-scatter", {}).get("operand_bytes"),
                       "step": traffic},
           "mem_one_device_bytes": {
               "dryrun": dry["mem_one_device_bytes"],
               "max_memory_allocated": cell["mesh_run"]["peak_bytes"]},
           "ops_total": dry["ops_total"],
           "kernels_a_step": cell["mesh_run"]["kernels_a_step"],
           "per_device": {k: dry[k] for k in (
               "op_flops_per_dev", "collective_bytes_per_dev",
               "mem_per_device_bytes", "dominant")}}
    emit({"phase": "mesh_block_dryrun", **out})
    check(dry["op_flops_total"] == cell["mesh_run"]["flops_a_step"],
          f"{arch} dry run FLOPs {dry['op_flops_total']} vs "
          f"FlopCounterMode's {cell['mesh_run']['flops_a_step']}")
    want = {k: {f: int(v) for f, v in r.items()} for k, r in coll.items()}
    check(raw == want, f"{arch} dry run collectives {raw} vs the step's "
                       f"COLLECTIVES {want}")
    check(out["traffic"]["dryrun_all_gather_result"]
          == traffic["gather_bytes"]
          and out["traffic"]["dryrun_reduce_scatter_operand"]
          == traffic["reduce_scatter_bytes"],
          f"{arch} dry run gather / reduce-scatter bytes vs TRAFFIC "
          f"{traffic}")
    return out


def mesh_checkpoint(dev, mesh) -> dict:
    """A reduced qwen2.5-3b train state written sharded on the (2, 4)
    mesh (one file a slot), restored on (4, 1), written again and
    restored on (2, 4): bit-exact (`torch.equal`) each way."""
    import json as _json

    import torch

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import (device_put, gather, make_mesh,
                                         make_rules, sanitized_shardings)
    from repro_torch.nn import flatten_tree, init_params, model_decls
    from repro_torch.training import (abstract_train_state, train_state_init,
                                      train_state_pspecs)

    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256,
                                           d_model=128, d_ff=256)
    decls = model_decls(cfg)
    state = train_state_init(init_params(
        decls, torch.Generator().manual_seed(0), device=dev), cfg)
    want = {k: t.cpu() for k, t in flatten_tree(state).items()}

    def shardings(m, like):
        return sanitized_shardings(m, train_state_pspecs(
            cfg, decls, make_rules(m, "train")), like)

    def same(tree, what):
        got = {k: t.cpu() for k, t in flatten_tree(gather(tree, dev)).items()}
        check(all(torch.equal(got[k], want[k]) for k in want),
              f"checkpoint {what} not bit-exact")

    def shard_files(d, step):
        with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
            return len(_json.load(f)["leaves"][
                "params__stage0__slot0__mixer__wq"]["shards"])

    m41 = make_mesh((4, 1), MESH_AXES, devices=[dev] * 4)
    placed = device_put(state, shardings(mesh, state))
    like = abstract_train_state(cfg, decls)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt") as d:
        save_checkpoint(d, 1, placed, sharded=True)
        on41, _ = restore_checkpoint(d, like, shardings=shardings(m41, like))
        same(on41, "(2, 4) -> (4, 1)")
        save_checkpoint(d, 2, on41, sharded=True)
        back, _ = restore_checkpoint(d, placed)
        same(back, "(4, 1) -> (2, 4)")
        files = {"(2, 4)": shard_files(d, 1), "(4, 1)": shard_files(d, 2)}
    check(files == {"(2, 4)": 8, "(4, 1)": 4}, f"shard files {files}")
    return {"leaves": len(want), "shard_files_of_wq": files,
            "bit_exact": True}


def mesh_leg(dev, smi) -> dict:
    """The language model on a (2, 4) mesh of the card's slots (see the
    module notes); returns the phase's numbers and the four kernels'
    launches during it (zeroed just before)."""
    import torch

    from repro_torch.configs import all_configs
    from repro_torch.distributed import make_mesh

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_differential import mesh_vs

    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    bmm = importlib.import_module("repro_torch.kernels.blmac_matmul")
    bf.reset_launch_counts()
    bmm.pulse_matmul.launches = 0
    t_leg = time.perf_counter()
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    mesh = make_mesh(MESH_SHAPE, MESH_AXES, devices=[dev] * 8)
    train = timed("train_full", lambda: mesh_train_full(dev, smi, mesh))
    timed("dryrun", lambda: mesh_dryrun(dev, smi, train))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed("train_check", lambda: mesh_train_check(dev, smi, mesh))
    serve = timed("serve_full", lambda: mesh_serve_full(dev, smi, mesh))
    emit({"phase": "mesh_serve_full", **serve})
    cells = {}
    for arch in MESH_BLOCK_CELLS:
        cells[arch] = timed(f"cell_{arch}", lambda: mesh_block_cell(
            dev, smi, mesh, arch))
    timed("cell_dryrun", lambda: mesh_block_dryrun(cells["mixtral-8x22b"]))
    reduced = timed("reduced", lambda: {
        arch: mesh_vs(arch, [dev] * 8, dev, bound=MESH_REDUCED_REL)
        for arch in sorted(all_configs())})
    bad = {a: r for a, r in reduced.items() if not r["ok"]}
    check(not bad, f"reduced archs on the mesh vs unsharded: {bad}")
    emit({"phase": "mesh_reduced_vs_unsharded", "bound_rel":
          MESH_REDUCED_REL, "train_steps": 2, "archs": reduced})
    ckpt = timed("checkpoint", lambda: mesh_checkpoint(dev, mesh))
    emit({"phase": "mesh_checkpoint", **ckpt})
    emit({"phase": "mesh_wall_s", **walls})
    launches = {"bank_apply": bf.bank_apply.launches,
                "specialized_call": bf.specialized_call.launches,
                "combine_fold": bf.combine_fold.launches,
                "pulse_matmul": bmm.pulse_matmul.launches}
    check(not any(launches.values()),
          f"the mesh path launched the FIR or pulse kernels: {launches}")
    return {"launches": launches, "wall_s": time.perf_counter() - t_leg,
            "step_ms": train["mesh_run"]["step_ms_median_1_4"],
            "step_kernels_traced":
            train["mesh_run"]["traced"]["kernels_seen"],
            "peak_bytes": train["mesh_run"]["peak_bytes"],
            "block_cells": {a: {
                "step_ms": c["mesh_run"]["step_ms"],
                "unsharded_step_ms": c["unsharded"]["step_ms"],
                "decode_ms_bf16": c["serve"]["bfloat16"]["decode_ms_median"],
                "unsharded_decode_ms_bf16":
                c["serve"]["bfloat16"]["unsharded_decode_ms_median"],
                "kernels_a_step": c["mesh_run"]["kernels_a_step"],
                "unsharded_kernels_a_step": c["unsharded"]["kernels_a_step"],
                "peak_bytes": c["mesh_run"]["peak_bytes"],
                "unsharded_peak_bytes": c["unsharded"]["peak_bytes"]}
                for a, c in cells.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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

    # -- the session server, after the kernels' and the engine's timings
    # (so those run where earlier versions of this script ran them) ------
    session_launches = sessions_leg(dev, smi, serve_prog)["launcher"]
    for row, key in ((kernels[0], "bank_apply"),
                     (kernels[1], "specialized_call")):
        row["launches"] += session_launches[key]
        row["launches_by_leg"]["sessions"] = session_launches[key]

    fold_row["launches_by_leg"] = {"cse": fold_row["launches"],
                                   "machine": machine_launches["combine_fold"],
                                   "sharded": sharded_launches["combine_fold"]}
    fold_row["launches"] += (machine_launches["combine_fold"]
                             + sharded_launches["combine_fold"])
    kernels.append(fold_row)
    k3_row = pulse_matmul_leg(dev, smi)
    k3_row["launches_by_leg"] = {"pulse_matmul": k3_row["launches"]}
    kernels.append(k3_row)

    # -- the lm phase, in a fresh process: none of the four kernels runs on
    # the language-model path (the reference's reaches no Pallas kernel) --
    free_cuda()
    legs_wall_s = {}
    for leg in ("lm", "train", "mesh"):
        t_leg = time.perf_counter()
        res = leg_child(f"--{leg}-leg")
        legs_wall_s[leg] = time.perf_counter() - t_leg
        for row in kernels:
            n = res["launches"][LM_LAUNCH_KEYS[row["name"]]]
            row.setdefault("launches_by_leg", {})[leg] = n
            row["launches"] += n

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start,
          "legs_wall_s": legs_wall_s, "device": kind, "nvidia_smi": smi})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


LEGS = {"--lm-leg": lm_leg, "--train-leg": train_leg,
        "--mesh-leg": mesh_leg}


def leg_main(flag: str) -> int:
    """``--lm-leg``, ``--train-leg`` or ``--mesh-leg``: that phase alone,
    its result on a line of its own (read by `leg_child`)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = LEGS[flag](dev, nvidia_smi_line())
    print(LEG_RESULT + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    # the cost model's fitted constants go to a directory of this run only
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache") as cache_dir:
        os.environ["REPRO_TORCH_CACHE_DIR"] = cache_dir
        args = sys.argv[1:]
        sys.exit(leg_main(args[0]) if len(args) == 1 and args[0] in LEGS
                 else main())
