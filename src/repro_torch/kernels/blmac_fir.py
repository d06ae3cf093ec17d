"""BLMAC FIR filtering on the GPU: single filters and whole banks.

The port of `repro.kernels.blmac_fir`.  Three hand-written CUDA kernels
carry it, each with a plain PyTorch version of the same function beside
it:

  * **bank** (`bank_apply`, kernel ``csrc/blmac_bank.cu``) — one launch
    for every tile group of a `BankSchedule` on the int8 tensor cores: B
    filters × C channels over framed signal tiles, written straight into
    the caller's (B, C, n_out) order.  The host's tables (`BankTerms`:
    digit runs of span ≤ 7 as s8 wgmma fragments, the Horner terms of run
    × sample byte plane) are built once per schedule and device
    (`bank_terms`); `bank_term_walk` is their arithmetic in numpy and
    `bank_call_plain` the plain version of one group.  Replaces the TPU
    kernel `_fir_kernel_bank`.
  * **specialized** (`specialized_call`, kernels
    ``csrc/blmac_specialized.cu``) — one launch for every filter and
    channel of a call, of one of two designs that `specialized_route`
    picks by the launch's shape: on a grid that fills the card (up to 255
    taps), the int8 tensor cores over each run of the filter's CSD digits
    as a Toeplitz matrix (`toeplitz_tables`; `specialized_toeplitz_walk`
    is its arithmetic in numpy); elsewhere a CUDA-core walk of the pulse
    lists as tap-major device tables (`pulse_table`), 4 outputs a thread
    on a grid too small to fill the card (`specialized_outs`, each
    filter's walk then split into segments of taps, `pulse_segments`), 16
    past 255 taps.  One filter's tables are cached in the
    `specialized_program` LRU.  Replaces `_fir_kernel_specialized`.
  * **combine fold** (`combine_fold`, kernel ``csrc/blmac_combine.cu``) —
    a CSE-optimized bank's shared rows folded into its real rows in place,
    ``y[r] += Σ_s combine[r, s] · y[n_real + s]``: a block stages a span
    of the shared rows in shared memory and walks the real rows in pairs
    that share shared rows, from a host table (`combine_table`, built once
    per combine matrix and device, one `CombineLayout` per number of row
    groups; `combine_walk` is its arithmetic in numpy); `combine_plain` is
    its plain version.  Replaces `_combine_shared`
    (an XLA program, no Pallas kernel) and the reference engine's host
    fold.

The tensor's device chooses: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel (or raises — there is no fallback).  Each
wrapper counts its launches in a plain int attribute (``.launches``);
`reset_launch_counts` zeroes them.

Arithmetic is int32 modulo 2**32 end to end, as in the reference: the
§2.1 bound (16-bit coefficients × 8-bit samples × ≤255 taps fits 32
bits) is asserted once at compile time, and wider samples wrap exactly
as the reference's int32 lanes do.

Host-side layout (framing, pulse tuples, schedule planning) follows the
reference function for function, so the tests compare frames, plans and
outputs directly.
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.cache import STATS
from ..compiler.program import compile_packed
from ..compiler.schedule import (BankSchedule, MERGE_DEFAULT,
                                 plan_bank_schedule)
from ..core.csd import csd_digits, pack_trits, unpack_trits
from ..tracing import span, spanned

__all__ = [
    "BankTerms",
    "FAST_PATH_MAX",
    "LANE",
    "CombineLayout",
    "CombineTable",
    "a_fragments",
    "bank_apply",
    "bank_call_plain",
    "bank_k",
    "bank_output",
    "bank_schedule_apply",
    "bank_term_walk",
    "bank_terms",
    "bank_work",
    "blmac_fir_bank",
    "blmac_fir_dynamic",
    "blmac_fir_specialized",
    "combine_fold",
    "combine_plain",
    "combine_table",
    "combine_walk",
    "digit_runs",
    "f32_dot_safe",
    "fragment_rows",
    "frame_signal",
    "frame_signal_batch",
    "group_terms",
    "pair_rows",
    "pulses_from_packed",
    "pulse_table",
    "pulse_segments",
    "pulse_table_walk",
    "pulse_tables",
    "pulses_msb_first",
    "reset_launch_counts",
    "sample_planes",
    "schedule_layers",
    "specialized_bank",
    "specialized_call",
    "specialized_geometry",
    "specialized_outs",
    "specialized_plain",
    "specialized_program",
    "specialized_route",
    "specialized_segments",
    "specialized_toeplitz_walk",
    "specialized_walk",
    "term_table",
    "toeplitz_image",
    "toeplitz_k",
    "toeplitz_rows",
    "toeplitz_runs",
    "toeplitz_tables",
]

LANE = 128
TRITS_PER_WORD = 16
FAST_PATH_MAX = 1  # banks up to this size dispatch to specialized programs

# the plain bank version contracts in float64 on the GPU (torch has no
# integer matmul there): exact while |u| <= 2 * 2**7, i.e. 8-bit samples
F64_SAMPLE_LIMIT = 128

# float32 mantissa: integers of magnitude < 2**24 are exactly
# representable, and sums/products that stay under the bound are exact
F32_EXACT_BOUND = 1 << 24


def f32_dot_safe(m_pad: int, parts) -> bool:
    """Whether one superlayer's contraction is exact in float32 (the
    reference's test, which its cost model reads): with 8-bit samples the
    folded window entries obey ``|u_j| <= 2**8`` and the superlayer digit
    ``|d_j| <= sum(2**rel)``; when ``m_pad * bound(d) * 2**8 <= 2**24``
    every partial sum is an integer below the float32 mantissa limit."""
    bound = sum(1 << rel for _, rel in parts)
    return m_pad * bound * 256 <= F32_EXACT_BOUND


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _on_device(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of a (possibly read-only) numpy array on ``device``."""
    return torch.tensor(np.ascontiguousarray(arr), device=device)


# ---------------------------------------------------------------------------
# host-side framing (overlap-save layout)
# ---------------------------------------------------------------------------

def frame_signal_batch(
    x: torch.Tensor, taps: int, tile: int
) -> tuple[torch.Tensor, int]:
    """(C, T) → (C, n_tiles, frame_len) overlapping frames per channel;
    returns the frames and the number of valid output samples.

    ``frame_len`` is ``tile + taps − 1`` padded up to a multiple of
    `LANE`, as in the reference.  The frames are a strided view of the
    zero-padded signal (stride ``tile`` between frames), not a copy: the
    kernels read them through their strides.
    """
    t = x.shape[-1]
    n_out = t - taps + 1
    if n_out <= 0:
        raise ValueError("signal shorter than the filter")
    n_tiles = -(-n_out // tile)
    frame_len = _pad_to(tile + taps - 1, LANE)
    pad = (n_tiles - 1) * tile + frame_len - t  # >= 0: n_tiles * tile >= n_out
    xp = F.pad(x, (0, pad)) if pad else x.contiguous()
    return xp.unfold(-1, frame_len, tile), n_out


def frame_signal(x: torch.Tensor, taps: int, tile: int):
    """(T,) → (n_tiles, frame_len) overlapping frames; returns the frames
    and the number of valid output samples."""
    frames, n_out = frame_signal_batch(x[None, :], taps, tile)
    return frames[0], n_out


def _check_frames(frames: torch.Tensor, ndim: int, taps: int, tile: int):
    if frames.dtype != torch.int32 or frames.ndim != ndim:
        raise ValueError(f"frames must be int32 with {ndim} dims, got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if frames.stride(-1) != 1 or frames.shape[-1] < tile + taps - 1:
        raise ValueError("frames need unit stride along the frame and at "
                         "least tile + taps - 1 samples")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K2: the pulse-specialized kernel
# ---------------------------------------------------------------------------

def pulses_msb_first(qcoeffs: np.ndarray) -> tuple[tuple[int, int, int], ...]:
    """Static MSB-first pulse tuple ``(layer, j, sign)`` from quantized
    symmetric coefficients."""
    taps = qcoeffs.shape[0]
    digits = csd_digits(np.asarray(qcoeffs[: taps // 2 + 1], np.int64))
    out = []
    for layer in range(digits.shape[1] - 1, -1, -1):
        for j in np.nonzero(digits[:, layer])[0]:
            out.append((int(layer), int(j), int(digits[j, layer])))
    return tuple(out)


def pulses_from_packed(packed_row: np.ndarray, taps: int):
    """(n_layers, n_words) packed trits → MSB-first static pulse tuple
    (the bridge from the bank operand format to the specialized kernel)."""
    half = taps // 2
    digits = unpack_trits(packed_row, half + 1)  # (L, M) int8
    out = []
    for layer in range(digits.shape[0] - 1, -1, -1):
        for j in np.nonzero(digits[layer])[0]:
            out.append((int(layer), int(j), int(digits[layer, j])))
    return tuple(out)


def pulse_table(pulses, taps: int) -> np.ndarray:
    """One filter's table for the specialized kernel K2, tap-major.

    Layout (int32)::

        [n_steps, (n_j, m_1 .. m_n_j) for j = 0 .. n_steps − 1,
         n_c, m_1 .. m_n_c]

    the taps below the centre in order, up to the last that carries
    pulses (``n_steps = 0`` when none does), then the centre tap ``c =
    taps // 2``; each pulse ``(layer, j, sign)`` (MSB first, as in the
    pulse tuple) is stored as its multiplier ``m = sign · 2**layer``
    modulo 2**32.  Every add and shift of the reference's Horner walk is
    kept, regrouped by tap: the kernel walks the taps in order, folds the
    sample pair ``u_j[t] = x[t+j] + x[t+taps-1-j]`` once per output where
    ``n_j > 0``, takes the centre's sample ``x[t+c]`` alone, and adds
    ``u_j · m`` for each of the tap's pulses — the pulse's shift done as
    a multiply by its signed power of two, never by the collapsed
    coefficient.  Int32 arithmetic modulo 2**32 is a commutative ring, so
    this order gives the reference's bits.

    `pulse_table_walk` is the plain walk of this layout (the kernel's
    loop, tap by tap, in numpy); `pulse_tables` concatenates several
    filters' tables behind an offset array."""
    half = taps // 2
    by_tap: dict = {}
    for layer, j, sign in pulses:
        if not 0 <= j <= half:
            raise ValueError(f"tap {j} outside the folded half of {taps}")
        by_tap.setdefault(int(j), []).append(int(sign) << int(layer))
    n_steps = max([j + 1 for j in by_tap if j < half], default=0)
    v = [n_steps]
    for j in [*range(n_steps), half]:
        v += [len(by_tap.get(j, ())), *by_tap.get(j, ())]
    words = np.asarray([m & 0xFFFFFFFF for m in v], np.uint32)
    return words.view(np.int32)


def pulse_tables(schedules, taps: int) -> tuple[np.ndarray, np.ndarray]:
    """Several filters' `pulse_table`s concatenated: the int32 table and
    its int32 offsets, filter ``f`` at ``table[offsets[f]:offsets[f + 1]]``
    (the layout one K2 launch reads for all its filters)."""
    tabs = [pulse_table(p, taps) for p in schedules]
    offsets = np.cumsum([0] + [t.size for t in tabs]).astype(np.int32)
    table = np.concatenate(tabs) if tabs else np.zeros(0, np.int32)
    return table, offsets


def pulse_table_walk(frames, table: np.ndarray, offsets: np.ndarray,
                     taps: int, tile: int, segments=None) -> np.ndarray:
    """Plain walk of `pulse_tables`' layout, in numpy uint32 (which wraps
    modulo 2**32 as the kernel's registers do): (..., n_tiles,
    frame_len) int32 frames → (F, ..., n_tiles, tile) int32 — the kernel's
    loop, tap by tap, fold then one multiply-add per pulse.  With
    ``segments`` (`pulse_segments`) each filter is walked segment by
    segment from each segment's own table index, the centre tap in the
    last, and the partial sums added, as the kernel's small grids do."""
    x = np.asarray(frames, np.int32).view(np.uint32)
    words = np.asarray(table, np.int32).view(np.uint32)
    half = taps // 2
    out = []
    for f in range(len(offsets) - 1):
        t = words[offsets[f]:offsets[f + 1]]
        n_steps = int(t[0])
        segs = [(0, 1)] if segments is None else \
            [tuple(map(int, sg)) for sg in segments[f]]
        acc = np.zeros(x.shape[:-1] + (tile,), np.uint32)
        for k, (j0, p) in enumerate(segs):
            last = k + 1 == len(segs)
            j1 = n_steps if last else segs[k + 1][0]
            for j in [*range(j0, j1), *([half] if last else [])]:
                n = int(t[p])
                p += 1
                if n:
                    u = x[..., j:j + tile]
                    if j != half:
                        u = u + x[..., taps - 1 - j:taps - 1 - j + tile]
                    for m in t[p:p + n]:
                        acc += u * m
                    p += n
        out.append(acc.view(np.int32))
    return np.stack(out) if out else np.zeros(
        (0,) + x.shape[:-1] + (tile,), np.int32)


def pulse_segments(table: np.ndarray, offsets: np.ndarray, n_segs: int,
                   step: int) -> np.ndarray:
    """Each filter's tap walk cut into ``n_segs`` segments for K2's small
    grids: int32 (F, n_segs, 2), segment s's first tap ``j0`` and the
    index, in the filter's table, of that tap's count ``n_j`` (of the
    centre's ``n_c`` where ``j0`` is past the walk).  Segments start at
    multiples of ``step`` (the kernel's outputs a thread, so each starts
    its register rings in the same slots) and are balanced by their table
    reads, the chain a thread waits on (one a tap for ``n_j``, one a
    pulse); the last also takes the centre tap.  Some may be empty."""
    words = np.asarray(table, np.int32)
    out = np.zeros((len(offsets) - 1, n_segs, 2), np.int32)
    for f in range(len(offsets) - 1):
        t = words[offsets[f]:offsets[f + 1]]
        n_steps = int(t[0])
        starts, cost, p = [], [], 1
        for _ in range(n_steps):
            starts.append(p)
            n = int(t[p])
            cost.append(1 + n)
            p += 1 + n
        starts.append(p)  # the centre's entry
        bounds = list(range(0, n_steps, step)) + [n_steps]
        cum = np.concatenate([[0], np.cumsum(cost)])[bounds]
        cuts, prev = [0], 0
        for k in range(1, n_segs):
            target = cum[-1] * k / n_segs
            b = prev + int(np.argmin(np.abs(cum[prev:] - target)))
            cuts.append(b)
            prev = b
        for k, b in enumerate(cuts):
            out[f, k] = (bounds[b], starts[bounds[b]])
    return out


# K2's launch geometry (``kOuts`` and the block limits in the .cu source):
# each thread keeps OUTS_PER_THREAD outputs of one tile in registers
# (SMALL_GRID_OUTS where a launch would give the card fewer than
# SMALL_GRID_WARPS_PER_SM warps an SM, each filter's walk then split into
# up to SMALL_GRID_SEGMENTS segments of taps); the threads over a tile's
# columns are at most SPECIALIZED_MAX_THREADS, a block at most
# SMALL_GRID_MAX_THREADS with its segments
OUTS_PER_THREAD = 16
SMALL_GRID_OUTS = 4
SMALL_GRID_WARPS_PER_SM = 4
SMALL_GRID_SEGMENTS = 4
SPECIALIZED_MAX_THREADS = 256
SMALL_GRID_MAX_THREADS = 512
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use


def specialized_geometry(tile: int, taps: int, table_len: int,
                         outs: int = OUTS_PER_THREAD):
    """K2's block for one launch: ``(threads, columns, tab_pad,
    smem_bytes)``.  Enough warps to cover the tile (at most
    `SPECIALIZED_MAX_THREADS` threads), each thread ``outs`` (16 or 4)
    consecutive columns; the shared memory holds the longest filter table
    (padded to 4 words) and the ``columns + taps − 1`` samples, one pad
    word every 32.  Raises ``ValueError`` when that does not fit a block
    (no fallback)."""
    if outs not in (OUTS_PER_THREAD, SMALL_GRID_OUTS):
        raise ValueError(f"K2 keeps {OUTS_PER_THREAD} or {SMALL_GRID_OUTS} "
                         f"outputs a thread, not {outs}")
    warps = min(SPECIALIZED_MAX_THREADS // 32, -(-tile // (32 * outs)))
    threads = 32 * warps
    cols = threads * outs
    tab_pad = _pad_to(table_len, 4)
    n_x = cols + taps - 1  # samples, one pad word every 32 in shared memory
    smem = 4 * (tab_pad + n_x + n_x // 32 + 1)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the specialized kernel needs {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")
    return threads, cols, tab_pad, smem


def specialized_outs(n_filters: int, n_chan: int, n_tiles: int, tile: int,
                     sms: int) -> int:
    """Outputs a thread of K2 keeps for one launch: `OUTS_PER_THREAD`,
    or `SMALL_GRID_OUTS` when that launch would give the ``sms`` SMs of
    the card fewer than `SMALL_GRID_WARPS_PER_SM` warps each (then a
    thread's walk, not the integer pipe, sets its time)."""
    threads, cols, _, _ = specialized_geometry(tile, 1, 0)
    warps = (n_filters * n_chan * n_tiles * -(-tile // cols)
             * threads // 32)
    return (SMALL_GRID_OUTS if warps < SMALL_GRID_WARPS_PER_SM * sms
            else OUTS_PER_THREAD)


def specialized_walk(n_filters: int, n_chan: int, n_tiles: int, tile: int,
                     sms: int, taps: int, pulses: float) -> float:
    """Adds one thread of a K2 launch makes for a filter of ``pulses``
    pulses: its outputs a thread (`specialized_outs`) × the filter's
    folds and pulses, over the segments of its walk
    (`specialized_segments`) — what sets the launch's time on a small
    grid."""
    outs = specialized_outs(n_filters, n_chan, n_tiles, tile, sms)
    threads = specialized_geometry(tile, 1, 0, outs)[0]
    return outs * (taps // 2 + pulses) / specialized_segments(outs, threads)


def specialized_segments(outs: int, threads: int) -> int:
    """Segments of taps K2 splits each filter's walk into: 1 at
    `OUTS_PER_THREAD` outputs a thread; on a small grid
    (`SMALL_GRID_OUTS`) `SMALL_GRID_SEGMENTS`, as far as a block of
    ``threads`` (the threads over a tile's columns) times the segments
    stays within `SMALL_GRID_MAX_THREADS`."""
    if outs == OUTS_PER_THREAD:
        return 1
    return max(1, min(SMALL_GRID_SEGMENTS, SMALL_GRID_MAX_THREADS // threads))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def specialized_plain(
    frames: torch.Tensor, pulses, taps: int, tile: int
) -> torch.Tensor:
    """Plain version of the specialized kernel for one filter: (...,
    n_tiles, frame_len) int32 frames → (..., n_tiles, tile) int32, one
    vector add per pulse and one shift per layer boundary (the
    reference's Horner walk, adds and shifts only, on any device)."""
    half = taps // 2
    u = {}
    for j in sorted({j for (_, j, _) in pulses}):
        if j == half:
            u[j] = frames[..., half:half + tile]
        else:
            u[j] = (frames[..., j:j + tile]
                    + frames[..., taps - 1 - j:taps - 1 - j + tile])
    acc = torch.zeros(frames.shape[:-1] + (tile,), dtype=torch.int32,
                      device=frames.device)
    layer_of = None
    for layer, j, sign in pulses:  # MSB layer first, grouped by layer
        if layer_of is not None and layer_of > layer:
            acc = acc << (layer_of - layer)
        layer_of = layer
        acc = acc + u[j] if sign > 0 else acc - u[j]
    if layer_of:
        acc = acc << layer_of
    return acc


# K2's tensor-core design (``blmac_specialized_kernel_wgmma`` in the .cu
# source): outputs in windows of TOEPLITZ_PHASES (the wgmma's N), a block's
# unit TOEPLITZ_UNIT outputs (two chains of 64 windows), each run's B tile
# 64 phase rows of K bytes in column blocks of TOEPLITZ_CHUNK bytes (64 rows
# of 128)
TOEPLITZ_PHASES = 64
TOEPLITZ_UNIT = 8192
TOEPLITZ_CHUNK = 8192


def toeplitz_k(taps: int) -> int:
    """The tensor-core K2's contraction depth: the samples a window of 64
    outputs reads, ``64 + taps − 1``, padded to a multiple of 64."""
    return _pad_to(TOEPLITZ_PHASES + taps - 1, 64)


def toeplitz_runs(pulses, taps: int) -> tuple[np.ndarray, list[int]]:
    """A filter's unfolded coefficients as digit runs: (R, taps) int8
    ``d`` and the runs' lowest layers, ``q[k] == Σ_r d[r, k] · 2**lo_r``
    modulo 2**32.  The coefficients (each pulse at tap ``j`` and its mirror
    ``taps − 1 − j``, the centre ``taps // 2`` once, as `specialized_plain`
    reads them) are reduced modulo 2**32, recoded in CSD, and their layers
    split MSB first into runs of span ≤ 7 (K1's `digit_runs`), so every
    digit fits s8."""
    half = taps // 2
    coeff = [0] * taps
    for layer, j, sign in pulses:
        v = int(sign) << int(layer)
        coeff[j] += v
        if j != half:
            coeff[taps - 1 - j] += v
    q = np.asarray([(v + (1 << 31)) % (1 << 32) - (1 << 31) for v in coeff],
                   np.int64)
    digits = csd_digits(q).astype(np.int16)  # (taps, n) LSB first
    layers = [lay for lay in range(min(digits.shape[1], 32))
              if digits[:, lay].any()]
    runs = digit_runs(layers)
    lows = [min(layers[i] for i in run) for run in runs]
    d = np.zeros((len(runs), taps), np.int16)
    for r, (run, lo) in enumerate(zip(runs, lows)):
        for i in run:
            d[r] += digits[:, layers[i]] << (layers[i] - lo)
    return d.astype(np.int8), lows


def toeplitz_image(d: np.ndarray, k: int) -> np.ndarray:
    """The B tiles of one filter's runs ``d`` (R, taps) as the kernel holds
    them in shared memory: int8 (n_chunks · 8192,), each run a (64 phase, K)
    Toeplitz matrix, row ``i`` = the run shifted by ``i`` (``B[i, m] =
    d[m − i]``), the runs side by side along K, cut into column blocks of
    128 bytes (`TOEPLITZ_CHUNK` each: 64 rows of 128 bytes, 128-byte
    swizzle: 16-byte chunk ``c`` of row ``i`` at ``c ^ (i % 8)``)."""
    n_runs, taps = d.shape
    padded = np.zeros((n_runs, TOEPLITZ_PHASES + k), np.int8)
    padded[:, TOEPLITZ_PHASES:TOEPLITZ_PHASES + taps] = d
    rows = padded[:, TOEPLITZ_PHASES + np.arange(k)[None, :]
                  - np.arange(TOEPLITZ_PHASES)[:, None]]  # (R, 64, K)
    n_chunks = -(-n_runs * k // 128)
    flat = np.zeros((TOEPLITZ_PHASES, n_chunks * 128), np.int8)
    flat[:, :n_runs * k] = rows.transpose(1, 0, 2).reshape(TOEPLITZ_PHASES, -1)
    v = _swizzled(flat.reshape(TOEPLITZ_PHASES, n_chunks, 8, 16))
    return np.ascontiguousarray(v.transpose(1, 0, 2, 3)).reshape(-1)


def _swizzled(v: np.ndarray) -> np.ndarray:
    """(64, chunks, 8, 16) phase rows with each row's 16-byte chunks
    permuted by the 128-byte swizzle, chunk ``c`` of row ``i`` to ``c ^
    (i % 8)`` (its own inverse)."""
    i = np.arange(TOEPLITZ_PHASES)[:, None, None]
    return v[i, np.arange(v.shape[1])[None, :, None],
             np.arange(8)[None, None, :] ^ (i % 8)]


def toeplitz_rows(image: np.ndarray, n_runs: int, k: int) -> np.ndarray:
    """Inverse of `toeplitz_image`: (R, 64, K) int8, run ``r``'s phase rows."""
    v = np.asarray(image, np.int8).reshape(-1, TOEPLITZ_PHASES, 8, 16)
    flat = _swizzled(v.transpose(1, 0, 2, 3))  # (phase, chunk, 16 B, byte)
    flat = flat.reshape(TOEPLITZ_PHASES, -1)[:, :n_runs * k]
    return np.ascontiguousarray(
        flat.reshape(TOEPLITZ_PHASES, n_runs, k).transpose(1, 0, 2))


def toeplitz_tables(schedules, taps: int):
    """The tensor-core K2's tables for several filters: ``(image, index,
    terms, b_bytes)``.  ``image`` int8, every filter's `toeplitz_image`
    concatenated; ``terms`` int32 (n, 4): for each filter, four lists of
    its `term_table` rows (run, plane, shift, 0), shift high first — those
    of planes below 1, 2, 3 and 4, the walk of a unit whose highest live
    plane is 0, 1, 2 or 3; ``index`` int32 (F, 8): a filter's offset and
    size in ``image`` in 16-byte units, its first term, the four lists'
    lengths, 0; ``b_bytes`` the largest filter's tiles (at least one column
    block)."""
    k = toeplitz_k(taps)
    images, index, terms = [], [], []
    off = first = 0
    for pulses in schedules:
        d, lows = toeplitz_runs(pulses, taps)
        img = toeplitz_image(d, k)
        tab = term_table(lows)
        lists = [tab[tab[:, 1] < n] for n in range(1, SAMPLE_PLANES + 1)]
        images.append(img)
        terms += lists
        index.append((off // 16, img.size // 16, first,
                      *[len(t) for t in lists], 0))
        off += img.size
        first += sum(len(t) for t in lists)
    b_bytes = max([img.size for img in images] + [TOEPLITZ_CHUNK])
    return (np.concatenate(images) if off else np.zeros(16, np.int8),
            np.asarray(index, np.int32).reshape(-1, 8),
            (np.concatenate(terms) if first else np.zeros((1, 4), np.int32)),
            b_bytes)


def specialized_toeplitz_walk(frames, image: np.ndarray, index: np.ndarray,
                              terms: np.ndarray, taps: int,
                              tile: int) -> np.ndarray:
    """The tensor-core K2's arithmetic in numpy, from the tables
    `toeplitz_tables` builds: (..., n_tiles, frame_len) int32 frames → (F,
    ..., n_tiles, tile) int32.  Splits the samples into s8 planes
    (`sample_planes`), cuts each frame's outputs into windows of 64, and for
    each filter walks its terms as the kernel does — ``acc <<= previous
    shift − shift; acc += S_plane · B_run`` modulo 2**32, B read back from
    the image's swizzled rows, S the windows' Hankel rows of the plane —
    in the list of the planes up to the highest that is not zero across
    the samples (the kernel picks it per unit: the same sum)."""
    x = np.asarray(frames, np.int32)
    k = toeplitz_k(taps)
    n_win = -(-tile // TOEPLITZ_PHASES)
    need = TOEPLITZ_PHASES * (n_win - 1) + k
    pad = max(0, need - x.shape[-1])
    xp = np.pad(x[..., :need], [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    planes = sample_planes(xp).astype(np.int64)
    n_planes = max([p + 1 for p in range(SAMPLE_PLANES) if planes[p].any()],
                   default=0)
    at = (TOEPLITZ_PHASES * np.arange(n_win)[:, None]
          + np.arange(k)[None, :])
    mask = np.int64(0xFFFFFFFF)
    out = []
    for off, size, first, *counts, _ in np.asarray(index, np.int64):
        n_runs = size * 16 // (k * TOEPLITZ_PHASES)
        rows = toeplitz_rows(image[16 * off:16 * (off + size)], n_runs,
                             k).astype(np.int64) if size else None
        acc = np.zeros(x.shape[:-1] + (n_win, TOEPLITZ_PHASES), np.int64)
        first += sum(counts[:max(n_planes - 1, 0)])
        count = counts[n_planes - 1] if n_planes else 0
        prev = None
        for run, plane, shift, _ in terms[first:first + count]:
            if prev is not None:
                acc = (acc << (prev - shift)) & mask
            acc = (acc + planes[plane][..., at] @ rows[run].T) & mask
            prev = shift
        if prev:
            acc = (acc << prev) & mask
        acc = acc.reshape(x.shape[:-1] + (-1,))[..., :tile]
        out.append(acc.astype(np.uint32).view(np.int32))
    return np.stack(out) if out else np.zeros(
        (0,) + x.shape[:-1] + (tile,), np.int32)


def specialized_route(n_filters: int, n_chan: int, n_tiles: int, tile: int,
                      sms: int, taps: int) -> str:
    """K2's design for one launch, by its shape alone: ``"wgmma"`` (the
    int8 tensor cores) where the launch fills the card — `specialized_outs`
    keeps `OUTS_PER_THREAD` outputs a thread — and the filter has at most
    `BANK_MAX_TAPS` taps; ``"walk"`` (the CUDA-core walk, 4 outputs a
    thread on a small grid, 16 past `BANK_MAX_TAPS`) everywhere else."""
    return _route(specialized_outs(n_filters, n_chan, n_tiles, tile, sms),
                  taps)


def _route(outs: int, taps: int) -> str:
    """`specialized_route` from the launch's outputs a thread."""
    return ("wgmma" if outs == OUTS_PER_THREAD and taps <= BANK_MAX_TAPS
            else "walk")


class SpecializedProgram:
    """Compiled BLMAC programs of one or more filters for K2: their pulse
    tuples and, on a CUDA device, their concatenated tables (`pulse_tables`)
    resident there, so every call is one launch for all filters and
    channels.  Up to `BANK_MAX_TAPS` taps it also holds the tensor-core
    design's tables (`toeplitz_tables`: ``toeplitz`` on the host,
    ``toeplitz_tensors`` on a CUDA device), built here once."""

    def __init__(self, schedules, taps: int, tile: int, device: torch.device):
        self.schedules = tuple(schedules)
        self.taps = taps
        self.tile = tile
        self.device = device
        table, offsets = pulse_tables(self.schedules, taps)
        self.table_len = int(np.diff(offsets).max(initial=0))
        # the launch geometry for each choice of outputs a thread (both
        # checked here, so a launch cannot be refused for its size)
        self.geometries = {
            outs: specialized_geometry(tile, taps, self.table_len, outs)
            for outs in (OUTS_PER_THREAD, SMALL_GRID_OUTS)}
        self.geometry = self.geometries[OUTS_PER_THREAD]
        # each width's segments of the filters' walks (`pulse_segments`)
        self.segments = {}
        for outs, (threads, _, _, _) in self.geometries.items():
            n_segs = specialized_segments(outs, threads)
            self.segments[outs] = _on_device(
                pulse_segments(table, offsets, n_segs, outs), device)
        self.table = _on_device(table, device)
        self.offsets = _on_device(offsets, device)
        self.toeplitz = self.toeplitz_tensors = None
        if taps <= BANK_MAX_TAPS:
            self.toeplitz = toeplitz_tables(self.schedules, taps)
            if torch.device(device).type == "cuda":
                self.toeplitz_tensors = tuple(
                    _on_device(a, device) for a in self.toeplitz[:3])

    @property
    def n_filters(self) -> int:
        return len(self.schedules)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(T,) or (C, T) samples on this program's device → (F, T − taps
        + 1) or (F, C, T − taps + 1) int32."""
        with span("frame"):
            xb = x.to(torch.int32)
            frames, n_out = frame_signal_batch(
                xb[None] if x.ndim == 1 else xb, self.taps, self.tile)
        y = specialized_call(frames, self)
        with span("frame"):  # the tiles back to n_out outputs
            y = y.reshape(y.shape[0], y.shape[1], -1)[:, :, :n_out]
            return y[:, 0] if x.ndim == 1 else y


@functools.lru_cache(maxsize=1024)
@spanned("build.specialized")
def specialized_program(pulses, taps: int, tile: int, device: str):
    """The compiled program for one pulse schedule on one device.

    LRU-cached on ``(pulses, taps, tile, device)``: reprogramming a filter
    seen before is a dict hit and reuses its device-resident pulse table —
    the software analogue of reloading the FPGA weight memory."""
    return SpecializedProgram((pulses,), taps, tile, torch.device(device))


@spanned("launch.k2")
def specialized_call(frames: torch.Tensor, prog: SpecializedProgram):
    """Run every filter of a `SpecializedProgram` over (C, n_tiles,
    frame_len) int32 frames → (F, C, n_tiles, tile) int32 (2-D frames:
    no channel axis in or out): the plain version for CPU frames, one
    CUDA launch for CUDA frames, of the design `specialized_route` picks
    (``.launches`` counts both, ``.wgmma_launches`` the tensor-core
    one's)."""
    if frames.ndim not in (2, 3):
        raise ValueError(f"frames must have 2 or 3 dims, got "
                         f"{tuple(frames.shape)}")
    _check_frames(frames, frames.ndim, prog.taps, prog.tile)
    dev = frames.device
    if dev.type == "cpu":
        f3 = frames[None] if frames.ndim == 2 else frames
        y = torch.zeros((0,) + f3.shape[:-1] + (prog.tile,), dtype=torch.int32)
        if prog.n_filters:
            y = torch.stack([specialized_plain(f3, p, prog.taps, prog.tile)
                             for p in prog.schedules])
        return y[:, 0] if frames.ndim == 2 else y
    if dev.type != "cuda" or dev != prog.table.device:
        raise ValueError(f"frames on {dev}, program on {prog.table.device}")
    lead = frames.shape[:-1]  # ([C,] n_tiles): 2-D frames are one channel
    out = torch.empty((prog.n_filters,) + lead + (prog.tile,),
                      dtype=torch.int32, device=dev)
    if prog.n_filters:
        n_chan = lead[0] if len(lead) == 2 else 1
        stride_c = frames.stride(0) if len(lead) == 2 else 0
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        outs = specialized_outs(prog.n_filters, n_chan, lead[-1], prog.tile,
                                sm_count(dev))
        if _route(outs, prog.taps) == "wgmma":
            image, index, terms = prog.toeplitz_tensors
            err = _specialized_library().blmac_specialized_wgmma_launch(
                frames.data_ptr(), stride_c, frames.stride(-2),
                image.data_ptr(), index.data_ptr(), terms.data_ptr(),
                prog.toeplitz[3], out.data_ptr(), prog.n_filters, n_chan,
                lead[-1], prog.tile, prog.taps, stream, dev.index)
            _raise_on(err, "blmac_specialized_kernel_wgmma")
            specialized_call.wgmma_launches += 1
        else:
            threads, _, tab_pad, _ = prog.geometries[outs]
            segs = prog.segments[outs]
            err = _specialized_library().blmac_specialized_launch(
                frames.data_ptr(), stride_c, frames.stride(-2),
                prog.table.data_ptr(), prog.offsets.data_ptr(),
                segs.data_ptr(), segs.shape[1], tab_pad, out.data_ptr(),
                prog.n_filters, n_chan, lead[-1],
                prog.tile, prog.taps, threads, outs, stream, dev.index,
            )
            _raise_on(err, "blmac_specialized_kernel")
        specialized_call.launches += 1
    return out


@functools.lru_cache(maxsize=1)
@spanned("build.library")
def _specialized_library():
    """K2's C library, built and loaded at the first launch."""
    from .build import library

    return library("blmac_specialized")


specialized_call.launches = 0
specialized_call.wgmma_launches = 0


def blmac_fir_specialized(
    x: torch.Tensor, pulses, taps: int, tile: int = 1024
) -> torch.Tensor:
    """Apply one pulse-specialized filter to (T,) or (C, T) samples on
    ``x``'s device → (T − taps + 1,) or (C, T − taps + 1) int32, in one
    launch; the program is built at most once per distinct (pulse
    schedule, taps, tile, device)."""
    return specialized_program(tuple(pulses), taps, tile, str(x.device))(x)[0]


def specialized_bank(x: torch.Tensor, pulses, taps: int,
                     tile: int = 1024) -> torch.Tensor:
    """A few filters' pulse tuples over (T,) or (C, T) samples on ``x``'s
    device → int32 (B, T − taps + 1) or (B, C, T − taps + 1): one K2
    launch a filter, each filter's program looked up in (or built into)
    the `specialized_program` LRU, the results stacked."""
    with span("plan"):
        progs = [specialized_program(tuple(p), taps, tile, str(x.device))
                 for p in pulses]
    ys = [prog(x) for prog in progs]  # one launch a filter
    with span("stack"):
        return torch.stack([yb[0] for yb in ys])


# ---------------------------------------------------------------------------
# K1: the bank kernel on the int8 tensor cores
# ---------------------------------------------------------------------------

# K1's geometry (the constants of ``csrc/blmac_bank.cu``): a tile of the
# bank is ROW_TILE rows (the wgmma's M), a block owns BANK_BN outputs (its
# N), and the kernel's tables hold digit runs of at most MAX_RUN_SPAN layers
# and SAMPLE_PLANES byte planes of a uint32 sample
ROW_TILE = 64
BANK_BN = 128
BANK_THREADS = 128
MAX_RUN_SPAN = 7  # |d| <= 2**7 - 1: a run's digit fits s8 for any trits
SAMPLE_PLANES = 4
BANK_MAX_TAPS = 255  # K = taps // 2 + 1 padded to 32 stays <= 128
BANK_ROW_ALIGN = 8  # int32 elements: rows of K1's result start on 32 bytes


def bank_k(taps: int) -> int:
    """K1's contraction depth: the folded taps ``taps // 2 + 1`` padded to
    a multiple of 32 (one wgmma k-step of s8 each)."""
    return _pad_to(taps // 2 + 1, 32)


def schedule_layers(schedule: tuple, tail_shift: int) -> list[int]:
    """The absolute bit layer of every selected layer (``sel_idx``) of a
    superlayer schedule: the last superlayer sits at ``tail_shift``, each
    one before it ``shift_in`` (of the one after it) higher."""
    layers: dict = {}
    lo = int(tail_shift)
    for shift_in, parts in reversed(schedule):
        for sel_idx, rel in parts:
            layers[int(sel_idx)] = lo + int(rel)
        lo += int(shift_in)
    return [layers[i] for i in range(len(layers))]


def digit_runs(layers: list[int]) -> list[list[int]]:
    """Greedy MSB-first runs of the selected layers (as ``sel_idx``), each
    spanning at most `MAX_RUN_SPAN` layers (``hi − lo < 7``)."""
    runs: list[list[int]] = []
    for i in sorted(range(len(layers)), key=lambda i: -layers[i]):
        if runs and layers[runs[-1][0]] - layers[i] < MAX_RUN_SPAN:
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def term_table(run_lows: list[int]) -> np.ndarray:
    """K1's terms for runs whose lowest layers are ``run_lows``: one
    ``(run, plane, shift, 0)`` row per run and byte plane with ``shift =
    lo + 8 · plane < 32`` (a term shifted by 32 or more vanishes modulo
    2**32), sorted by shift, high first (ties in run, then plane, order)
    — the order of the kernel's Horner chain."""
    rows = [(r, p, lo + 8 * p, 0) for r, lo in enumerate(run_lows)
            for p in range(SAMPLE_PLANES) if lo + 8 * p < 32]
    rows.sort(key=lambda v: -v[2])
    return np.asarray(rows, np.int32).reshape(-1, 4)


def sample_planes(u: np.ndarray) -> np.ndarray:
    """Balanced s8 byte planes of uint32 (or int32) values: ``(4,) +
    u.shape`` int8 with ``u == sum_p s_p · 2**(8p)`` modulo 2**32; ``s_p``
    is the low byte of what remains, read as s8, and the next plane takes
    ``(rest − s_p) >> 8`` (arithmetic).  8-bit samples folded (|u| ≤ 256)
    leave planes 2 and 3 zero."""
    v = np.asarray(u).astype(np.uint32)
    out = []
    for _ in range(SAMPLE_PLANES):
        s = (v & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
        out.append(s)
        v = ((v - s.astype(np.int32).view(np.uint32)).view(np.int32) >> 8) \
            .view(np.uint32)
    return np.stack(out)


def a_fragments(d: np.ndarray) -> np.ndarray:
    """(n · 64, K) int8 digit rows → (n, K / 32, 128, 16) int8: each 64-row
    tile and k-step in wgmma's A-fragment order, 16 bytes a thread of the
    warpgroup.  Thread ``32 w + 4 g + q`` holds rows ``16 w + g`` and ``16 w
    + g + 8`` and columns ``4 q .. 4 q + 3`` then ``16 + 4 q ..`` of the
    step, as four registers (row g, row g + 8, row g, row g + 8)."""
    rows, k = d.shape
    v = d.reshape(rows // ROW_TILE, 4, 2, 8, k // 32, 2, 4, 4)
    # (tile, w, h, g, ks, half, q, byte) → (tile, ks, w, g, q, half, h, byte)
    v = v.transpose(0, 4, 1, 3, 6, 5, 2, 7)
    return np.ascontiguousarray(v).reshape(rows // ROW_TILE, k // 32,
                                           BANK_THREADS, 16)


def fragment_rows(f: np.ndarray) -> np.ndarray:
    """Inverse of `a_fragments` for one tile: (K / 32, 128, 16) → (64, K)."""
    ks = f.shape[0]
    v = f.reshape(ks, 4, 8, 4, 2, 2, 4)  # (ks, w, g, q, half, h, byte)
    return np.ascontiguousarray(v.transpose(1, 5, 2, 0, 4, 3, 6)).reshape(
        ROW_TILE, 32 * ks)


class BankTerms:
    """K1's tables for one call's tile groups, built on the host once and
    kept on ``device`` (CUDA) for every launch.

    Host arrays (numpy; `bank_term_walk` reads these):

    * ``digits`` (n, 16) int8 — for each 64-row tile, run and k-step, the
      run's digit rows in A-fragment order (`a_fragments`);
    * ``tiles`` (n_row_tiles, 2) int32 — each tile's group and the offset
      of its fragments in 16-byte units;
    * ``groups`` (n_groups, 2) int32 — each group's first term and number
      of terms (0 for an all-zero group: its rows come out zero);
    * ``terms`` (n_terms, 4) int32 — `term_table` rows, group after group;
    * ``dest`` (n_row_tiles · 64,) int32 — the output row of every tile
      row, −1 for padding.

    ``parts`` lists each group as ``(packed (rows, n_sel, n_words), schedule,
    tail_shift, dest (rows,))``; a group's rows are padded to whole tiles.
    """

    def __init__(self, parts, n_rows: int, taps: int, device=None):
        self.taps = int(taps)
        self.k = bank_k(taps)
        self.n_rows = int(n_rows)
        half = taps // 2
        ks = self.k // 32
        frags, tiles, groups, terms, dest = [], [], [], [], []
        off = n_terms = 0
        for gi, (packed, schedule, tail_shift, rows_dest) in enumerate(parts):
            rows = packed.shape[0]
            n_t = -(-rows // ROW_TILE)
            layers = schedule_layers(schedule, tail_shift)
            runs = digit_runs(layers)
            lows = [min(layers[i] for i in run) for run in runs]
            tab = term_table(lows)
            groups.append((n_terms, len(tab)))
            terms.append(tab)
            n_terms += len(tab)
            if runs:
                trits = unpack_trits(np.asarray(packed).view(np.uint32),
                                     half + 1).astype(np.int16)
                d = np.zeros((len(runs), n_t * ROW_TILE, self.k), np.int16)
                for r, (run, lo) in enumerate(zip(runs, lows)):
                    for i in run:
                        d[r, :rows, :half + 1] += trits[:, i] << (layers[i] - lo)
                if np.abs(d).max(initial=0) > 127:
                    raise AssertionError("a digit run exceeds s8")
                f = np.stack([a_fragments(dr.astype(np.int8)) for dr in d], 1)
                frags.append(f.reshape(-1, 16))  # (tile, run, ks, thread)
            per_tile = len(runs) * ks * BANK_THREADS
            tiles += [(gi, off + t * per_tile) for t in range(n_t)]
            off += n_t * per_tile
            pad = np.full(n_t * ROW_TILE, -1, np.int32)
            pad[:rows] = rows_dest
            dest.append(pad)
        self.digits = (np.concatenate(frags) if frags
                       else np.zeros((1, 16), np.int8))
        self.tiles = np.asarray(tiles, np.int32).reshape(-1, 2)
        self.groups = np.asarray(groups, np.int32).reshape(-1, 2)
        self.terms = (np.concatenate(terms) if n_terms
                      else np.zeros((1, 4), np.int32))
        self.dest = np.concatenate(dest).astype(np.int32)
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.tensors = None
        if self.device.type == "cuda":
            self.tensors = tuple(
                _on_device(a, self.device) for a in
                (self.digits, self.tiles, self.groups, self.terms, self.dest))

    @property
    def n_row_tiles(self) -> int:
        return self.tiles.shape[0]


def sample_plane_count(sample_bits: int) -> int:
    """Byte planes K1 walks for folded samples of ``sample_bits``-bit
    inputs (|u| ≤ 2**sample_bits, `sample_planes`' balanced split): 2 for
    8-bit samples, 4 for full-range int32."""
    return min(SAMPLE_PLANES, -(-(sample_bits + 2) // 8))


def bank_work(schedule: BankSchedule,
              sample_bits: int = 8) -> list[tuple[int, int]]:
    """K1's work for a schedule, without building its tables: one
    ``(n_row_tiles, n_terms)`` pair per tile group — its 64-row tiles and
    the `term_table` rows each walks for ``sample_bits``-bit samples (the
    planes above `sample_plane_count` are zero and skipped).  The layers
    come back absolute (`schedule_layers`), so the work is the same for
    every ``merge``; the cost model's ``"cuda"`` lane reads it."""
    planes = sample_plane_count(sample_bits)
    out = []
    for g in schedule.groups:
        layers = schedule_layers(g.schedule, g.tail_shift)
        lows = [min(layers[i] for i in run) for run in digit_runs(layers)]
        tab = term_table(lows)
        out.append((-(-g.packed.shape[0] // ROW_TILE),
                    int((tab[:, 1] < planes).sum())))
    return out


def group_terms(packed, schedule: tuple, tail_shift: int, taps: int,
                device=None) -> BankTerms:
    """`BankTerms` of one tile group whose output rows are its own rows in
    order (``packed`` a numpy array or tensor, (rows, n_sel, n_words))."""
    p = packed.cpu().numpy() if torch.is_tensor(packed) else np.asarray(packed)
    return BankTerms([(p, schedule, tail_shift, np.arange(p.shape[0]))],
                     p.shape[0], taps, device)


_TERMS_CACHE: dict = {}
TERMS_CACHE_MAX = 32


def bank_terms(schedule: BankSchedule, taps: int, device) -> BankTerms:
    """`BankTerms` of a whole `BankSchedule`, every group's rows bound for
    the caller's filter order (padded row p → filter ``perm[p]``), cached
    per (schedule object, taps, device): a program's memoized schedule
    (`BlmacProgram.schedule`) builds and uploads its tables once, and the
    engine and `blmac_fir_bank` share them."""
    dev = torch.device(device)
    key = (id(schedule), int(taps), str(dev))
    hit = _TERMS_CACHE.get(key)
    if hit is not None and hit[0]() is schedule:
        STATS["terms"].hit()
        return hit[1]
    STATS["terms"].miss()
    with span("build.terms"):
        b_pad = sum(g.packed.shape[0] for g in schedule.groups)
        dest = np.full(b_pad, -1, np.int64)
        dest[:schedule.n_filters] = schedule.perm
        parts, row = [], 0
        for g in schedule.groups:
            rows = g.packed.shape[0]
            parts.append((g.packed, g.schedule, g.tail_shift,
                          dest[row:row + rows]))
            row += rows
        terms = BankTerms(parts, schedule.n_filters, taps, dev)
    _TERMS_CACHE[key] = (weakref.ref(schedule), terms)
    while len(_TERMS_CACHE) > TERMS_CACHE_MAX:
        del _TERMS_CACHE[next(iter(_TERMS_CACHE))]
    return terms


def bank_term_walk(frames, terms: BankTerms, tile: int,
                   n_out: int) -> np.ndarray:
    """K1's arithmetic in numpy, term by term and plane by plane: (C,
    n_tiles, frame_len) int32 frames → (B, C, n_out) int32.  Folds the
    sample pairs in uint32, splits them into `sample_planes`, and for each
    64-row tile walks its group's `term_table` as the kernel does — ``acc
    <<= previous shift − shift; acc += D_run · U_plane`` modulo 2**32, the
    digits read back from their fragment order — skipping a plane that is
    zero across the samples (the kernel skips it per block: the same sum),
    then scatters the rows to ``dest``."""
    x = np.ascontiguousarray(np.asarray(frames, np.int32)).view(np.uint32)
    n_chan, n_tiles, frame_len = x.shape
    taps, k, half = terms.taps, terms.k, terms.taps // 2
    j = np.arange(k)[None, :]
    t = np.arange(tile)[:, None]
    fwd = x[..., np.minimum(t + j, frame_len - 1)]
    rev = x[..., np.clip(t + taps - 1 - j, 0, frame_len - 1)]
    u = np.where(j < half, fwd + rev, np.where(j == half, fwd, np.uint32(0)))
    planes = sample_planes(u).reshape(SAMPLE_PLANES, -1, k).astype(np.int64)
    live = [bool(p.any()) for p in planes]
    mask = np.int64(0xFFFFFFFF)
    ks = k // 32
    y = np.zeros((terms.n_rows, planes.shape[1]), np.int64)
    for rt, (grp, off) in enumerate(terms.tiles):
        first, count = terms.groups[grp]
        acc = np.zeros((ROW_TILE, planes.shape[1]), np.int64)
        prev = None
        for run, plane, shift, _ in terms.terms[first:first + count]:
            if not live[plane]:
                continue
            lo = off + run * ks * BANK_THREADS
            d = fragment_rows(terms.digits[lo:lo + ks * BANK_THREADS]
                              .reshape(ks, BANK_THREADS, 16)).astype(np.int64)
            if prev is not None:
                acc = (acc << (prev - shift)) & mask
            acc = (acc + d @ planes[plane].T) & mask
            prev = shift
        if prev:
            acc = (acc << prev) & mask
        rows = terms.dest[rt * ROW_TILE:(rt + 1) * ROW_TILE]
        keep = rows >= 0
        y[rows[keep]] = acc[keep]
    y = y.astype(np.uint32).view(np.int32)
    return y.reshape(terms.n_rows, n_chan, n_tiles * tile)[:, :, :n_out]


def bank_call_plain(
    frames: torch.Tensor,  # (C, n_tiles, frame_len) int32
    packed: torch.Tensor,  # (rows, n_sel, n_words) int32, selected layers
    taps: int,
    schedule: tuple,
    tail_shift: int,
    tile: int,
) -> torch.Tensor:
    """Plain version of the bank kernel for one tile group, modelled on the
    reference's `_bank_call_xla`: the window matrix of every (channel,
    tile) cell at once, then one contraction per superlayer → (rows, C,
    n_tiles, tile) int32.

    On the CPU the contraction is an int32 ``torch.matmul``, which wraps
    modulo 2**32 like every other step.  Torch has no integer matmul on
    CUDA, so there it contracts in float64 — exact for 8-bit samples
    (|d| < 2**32, |u| <= 2**8, m_pad <= 128: every partial sum stays
    below 2**47 < 2**53) — accumulates in int64 and casts to int32, which
    keeps the residue modulo 2**32.  That route asserts 8-bit samples."""
    n_chan, n_tiles, frame_len = frames.shape
    rows, n_sel, n_words = packed.shape
    m_pad = n_words * TRITS_PER_WORD
    half = taps // 2
    dev = frames.device
    j = torch.arange(m_pad, device=dev)[:, None]
    t = torch.arange(tile, device=dev)[None, :]
    fwd = frames[..., torch.clamp(j + t, max=frame_len - 1)]
    rev = frames[..., torch.clamp(taps - 1 - j + t, 0, frame_len - 1)]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    u = torch.where(j < half, fwd + rev, torch.where(j == half, fwd, zero))
    u = u.permute(2, 0, 1, 3).reshape(m_pad, n_chan * n_tiles * tile)
    shifts = 2 * torch.arange(TRITS_PER_WORD, dtype=torch.int32, device=dev)

    def trit_layer(sel_idx: int) -> torch.Tensor:
        codes = (packed[:, sel_idx, :, None] >> shifts) & 3
        d = (codes == 1).to(torch.int32) - (codes == 3).to(torch.int32)
        return d.reshape(rows, m_pad)

    f64 = dev.type != "cpu"
    if f64:
        if n_chan * n_tiles and int(frames.abs().max()) > F64_SAMPLE_LIMIT:
            raise ValueError("the float64 plain bank route is exact only for "
                             "8-bit samples")
        u = u.to(torch.float64)
    acc = torch.zeros((rows, u.shape[1]),
                      dtype=torch.int64 if f64 else torch.int32, device=dev)
    for shift_in, parts in schedule:  # MSB → LSB over populated superlayers
        if shift_in:
            acc = acc << shift_in
        d = None
        for sel_idx, rel in parts:
            dl = trit_layer(sel_idx)
            if rel:
                dl = dl << rel
            d = dl if d is None else d + dl
        if f64:
            acc = acc + (d.to(torch.float64) @ u).to(torch.int64)
        else:
            acc = acc + d @ u
    if tail_shift:
        acc = acc << tail_shift
    return acc.to(torch.int32).reshape(rows, n_chan, n_tiles, tile)


def bank_output(n_rows: int, n_chan: int, n_out: int,
                device) -> torch.Tensor:
    """An uninitialised (B, C, n_out) int32 result whose rows start on 32
    bytes (`BANK_ROW_ALIGN` elements apart at least): a view of a (B, C,
    n_out padded to 8) buffer, so that K1's stores are whole 32-byte
    sectors of device memory, none shared by two blocks, sent by bulk
    copies (a row that does not start on 16 bytes takes thread
    stores)."""
    ld = _pad_to(n_out, BANK_ROW_ALIGN)
    return torch.empty((n_rows, n_chan, ld), dtype=torch.int32,
                       device=device)[:, :, :n_out]


def _row_strided(out: torch.Tensor, shape: tuple, device) -> bool:
    """``out`` is int32 ``shape`` on ``device`` with rows of unit stride,
    (filter, channel) rows ``out.stride(1)`` apart — the layouts K1
    writes (contiguous, or `bank_output`'s)."""
    return (tuple(out.shape) == shape and out.dtype == torch.int32
            and out.device == device and out.stride(2) == 1
            and out.stride(1) >= shape[2]
            and out.stride(0) == shape[1] * out.stride(1))


@spanned("launch.k1")
def bank_apply(
    frames: torch.Tensor,
    terms: BankTerms,
    tile: int,
    n_out: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 over every tile group of ``terms`` in one launch: (C, n_tiles,
    frame_len) int32 frames → (B, C, n_out) int32, each filter's row
    written straight at its output row (``terms.dest``), into ``out`` when
    given (contiguous, or rows further apart: `bank_output`, the
    default).  CPU frames take `bank_term_walk`; CUDA frames launch the
    kernel or raise."""
    _check_frames(frames, 3, terms.taps, tile)
    n_chan, n_tiles, _ = frames.shape
    if not 0 < n_out <= n_tiles * tile:
        raise ValueError(f"n_out {n_out} outside 1 .. {n_tiles * tile}")
    shape = (terms.n_rows, n_chan, n_out)
    if out is not None and not _row_strided(out, shape, frames.device):
        raise ValueError(f"out must be int32 {shape} on {frames.device}, "
                         f"rows of unit stride")
    dev = frames.device
    if dev.type == "cpu":
        y = torch.from_numpy(np.ascontiguousarray(
            bank_term_walk(frames.numpy(), terms, tile, n_out)))
        return y if out is None else out.copy_(y)
    if dev.type != "cuda" or terms.tensors is None or terms.device != dev:
        raise ValueError(f"frames on {dev}, bank tables on {terms.device}")
    if terms.taps > BANK_MAX_TAPS:
        raise ValueError(f"the bank kernel takes at most {BANK_MAX_TAPS} "
                         f"taps, got {terms.taps}")
    if out is None:
        out = bank_output(*shape, dev)
    digits, tiles, groups, table, dest = terms.tensors
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _bank_library().blmac_bank_launch(
            frames.data_ptr(), frames.stride(0), frames.stride(1), n_chan,
            n_tiles, tile, terms.taps, n_out, out.data_ptr(), out.stride(1),
            digits.data_ptr(), tiles.data_ptr(), groups.data_ptr(),
            table.data_ptr(), dest.data_ptr(), terms.n_row_tiles,
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _raise_on(err, "blmac_bank_kernel")
    bank_apply.launches += 1
    return out


bank_apply.launches = 0


@functools.lru_cache(maxsize=1)
@spanned("build.library")
def _bank_library():
    """K1's C library, built and loaded at the first launch."""
    from .build import library

    return library("blmac_bank")


# ---------------------------------------------------------------------------
# the combine fold of a CSE-optimized bank
# ---------------------------------------------------------------------------

# the plain fold's float64 route on the GPU splits the shared rows into
# 16-bit halves: exact while each row's sum of |coefficients| times 2**16
# stays below 2**53
F64_FOLD_ROW_LIMIT = 1 << 37


# the fold kernel's geometry (csrc/blmac_combine.cu): a block folds a span
# of COMBINE_SPAN samples of one channel for a group of real rows, having
# staged the span of every shared row the group uses; each of its
# COMBINE_WARPS warps walks a quad of COMBINE_QUAD row pairs at a time (8
# lanes a pair, 4 samples a lane)
COMBINE_SPAN = 32
COMBINE_WARPS = 16
COMBINE_QUAD = 4
# shared rows a block can stage (128 bytes each): 1,816
COMBINE_MAX_STAGED = SMEM_LIMIT // (4 * COMBINE_SPAN)
# a row flag in the quad table: one piece of a row with more nonzeros than
# a block can stage, added to the row with atomics
COMBINE_PIECE = 1 << 30
# coefficients in [-2**15, 2**15) share a 32-bit table word with their
# staged row (the compact layout); any other int32 takes the wide one
COMPACT_COEFF = 1 << 15
# rows paired at a time, by their overlaps (a dense block × block product)
COMBINE_PAIR_BLOCK = 1024
# 16-byte chunks of entries a lane loads at a time: the kernel reads up to
# this many past a quad's last, so the table's end is padded by as many
COMBINE_BATCH = 6


def _entries(starts, counts) -> np.ndarray:
    """The table positions of runs of ``counts`` entries from ``starts``."""
    counts = np.asarray(counts, np.int64)
    return (np.repeat(np.asarray(starts, np.int64) - np.cumsum(counts)
                      + counts, counts) + np.arange(counts.sum()))


def _snake(n: int, width: int) -> np.ndarray:
    """0 .. n-1 in rounds of ``width``, every other round reversed: quads
    sorted longest first and dealt so, warp w taking entries w, w +
    width, ..., give each warp about the same walk."""
    order = np.arange(n)
    for lo in range(width, n, 2 * width):
        order[lo:lo + width] = order[lo:lo + width][::-1]
    return order


def pair_rows(rows, row_ptr, cols, n_shared: int) -> np.ndarray:
    """Pair ``rows`` (real rows with nonzeros) so that the two rows of a
    pair share many shared rows: (P, 2) int64, -1 in the second column of
    a row left alone.  Rows sorted by their mean shared row, in blocks of
    `COMBINE_PAIR_BLOCK`: mutual best partners by shared columns are
    paired, round after round, then the rest in order."""
    rows = np.asarray(rows, np.int64)
    nnz = row_ptr[rows + 1] - row_ptr[rows]
    src = _entries(row_ptr[rows], nnz)
    which = np.repeat(np.arange(rows.size), nnz)
    mean = np.bincount(which, cols[src], rows.size) / np.maximum(nnz, 1)
    rows = rows[np.argsort(mean, kind="stable")]
    # at most 2**22 cells (16 MB) in a block's dense 0/1 matrix
    block = max(64, min(COMBINE_PAIR_BLOCK, (1 << 22) // max(n_shared, 1)))
    pairs = []
    for lo in range(0, rows.size, block):
        part = rows[lo:lo + block]
        m = part.size
        dense = np.zeros((m, n_shared), np.float32)
        n = row_ptr[part + 1] - row_ptr[part]
        dense[np.repeat(np.arange(m), n), cols[_entries(row_ptr[part], n)]] = 1
        ov = dense @ dense.T
        np.fill_diagonal(ov, -1)
        free = np.ones(m, bool)
        while True:
            ov[~free] = -1
            ov[:, ~free] = -1
            best = ov.argmax(1)
            val = ov[np.arange(m), best]
            cand = free & (val > 0)
            if not cand.any():
                break
            mutual = np.flatnonzero(cand & (best[best] == np.arange(m))
                                    & (np.arange(m) < best))
            if not mutual.size:  # no mutual best: the best pair of all
                i = int(np.argmax(np.where(cand, val, -1)))
                mutual = np.array([min(i, best[i])])
            for i in mutual:
                j = best[i]
                if free[i] and free[j]:
                    free[i] = free[j] = False
                    pairs.append((part[i], part[j]))
        rest = part[free]
        for i in range(0, rest.size - 1, 2):
            pairs.append((rest[i], rest[i + 1]))
        if rest.size % 2:
            pairs.append((rest[-1], -1))
    return np.asarray(pairs, np.int64).reshape(-1, 2)


class CombineLayout:
    """A combine matrix cut for the fold kernel at ``n_groups`` row
    groups (`CombineTable.layout`).

    * ``group_union`` (G + 1,) int32 — group g stages the shared rows
      ``ulist[group_union[g]:group_union[g + 1]]`` (sorted, each used by
      one of its rows; at most ``staged_max``, ``max_union`` the most of
      any group);
    * ``group_quads`` (G + 1,) int32 — its quads
      ``quads[group_quads[g]:group_quads[g + 1]]``, longest first in
      `_snake` order;
    * ``quads`` (Q, 12) int32 — a quad's first 16-byte word of
      ``table``, its chunks, two unused words, the first rows of its four
      pairs and their second rows (-1 for none; ORed with `COMBINE_PIECE`
      for a piece added atomically);
    * ``table`` (chunks × 4, 4) uint32 — chunk k of the quad's pair s at
      16-byte word ``first + 4k + s``.  An entry is a shared row the pair
      reads, as its place in shared memory (8 × its index among the
      group's staged rows: its first 16-byte word), with both rows'
      coefficients (0 for a row that does not use it): compact, two to a
      chunk, ``(c_first << 16) | place`` and ``c_second``; ``wide``, one,
      ``(place, c_first, c_second, 0)``.  Zero entries pad a pair shorter
      than its quad's longest, and `COMBINE_BATCH` zero chunks the end.

    Groups hold consecutive rows, balanced by nonzeros and split further
    until their union fits; a row with more nonzeros than a block can
    stage becomes pieces, one group each, unpaired.  Within a group rows
    are paired by `pair_rows` (``pair=False``: none).  ``tensors`` holds
    the device copies (`to`)."""

    def __init__(self, row_ptr, cols, coeffs, n_shared: int, n_groups: int,
                 wide: bool, staged_max: int = COMBINE_MAX_STAGED,
                 pair: bool = True):
        self.wide = bool(wide)
        per = 1 if wide else 2  # entries a 16-byte chunk
        nnz = np.diff(row_ptr)
        rows = np.flatnonzero(nnz)
        regular = rows[nnz[rows] <= staged_max]
        # each group: its positions' (first row, second row) and their
        # (start, count) runs of table entries
        groups = []
        if regular.size:
            cum = np.cumsum(nnz[regular])
            cuts = np.unique(np.searchsorted(
                cum, cum[-1] * np.arange(1, n_groups) / n_groups) + 1)
            chunks = [c for c in np.split(regular, cuts[cuts < regular.size])
                      if c.size]
            while chunks:
                c = chunks.pop(0)
                if c.size > 1 and np.unique(cols[_entries(
                        row_ptr[c], nnz[c])]).size > staged_max:
                    chunks[:0] = [c[:c.size // 2], c[c.size // 2:]]
                    continue
                pos = pair_rows(c, row_ptr, cols, n_shared) if pair else \
                    np.stack([c, np.full(c.size, -1)], 1)
                second = np.maximum(pos[:, 1], 0)
                groups.append((pos, row_ptr[pos[:, 0]], nnz[pos[:, 0]],
                               row_ptr[second],
                               np.where(pos[:, 1] >= 0, nnz[second], 0)))
        for r in rows[nnz[rows] > staged_max]:
            for lo in range(row_ptr[r], row_ptr[r + 1], staged_max):
                n = min(staged_max, row_ptr[r + 1] - lo)
                groups.append((np.array([[r | COMBINE_PIECE, -1]]),
                               np.array([lo]), np.array([n]),
                               np.array([0]), np.array([0])))
        if not groups:  # an all-zero matrix: one empty group, one launch
            groups.append((np.zeros((0, 2), np.int64),)
                          + (np.zeros(0, np.int64),) * 4)
        unions, quads, tables = [], [], []
        group_union, group_quads = [0], [0]
        first = 0  # 16-byte chunks of the table before this group's
        for pos, a_start, a_n, b_start, b_n in groups:
            src_a, src_b = _entries(a_start, a_n), _entries(b_start, b_n)
            union = np.unique(cols[np.concatenate([src_a, src_b])])
            # the pair's entries: its shared rows in order, both
            # coefficients (keys: position × n_shared + shared row)
            keys = np.concatenate([
                np.repeat(np.arange(len(pos)), a_n) * n_shared + cols[src_a],
                np.repeat(np.arange(len(pos)), b_n) * n_shared + cols[src_b]])
            ent, inv = np.unique(keys, return_inverse=True)
            c_a = np.zeros(ent.size, np.uint32)
            c_b = np.zeros(ent.size, np.uint32)
            c_a[inv[:src_a.size]] = coeffs[src_a].view(np.uint32)
            c_b[inv[src_a.size:]] = coeffs[src_b].view(np.uint32)
            e_pos = ent // max(n_shared, 1)
            counts = np.bincount(e_pos, minlength=len(pos))
            # a staged row's place: its first 16-byte word in shared memory
            place = (8 * np.searchsorted(union, ent % max(n_shared, 1))) \
                .astype(np.uint32)
            order = np.argsort(-counts, kind="stable")
            pad = -len(order) % COMBINE_QUAD
            q_pos = np.concatenate([order, np.full(pad, -1)]) \
                .reshape(-1, COMBINE_QUAD)
            q_pos = q_pos[_snake(len(q_pos), COMBINE_WARPS)]
            q_counts = np.where(q_pos >= 0, counts[q_pos], 0)
            q_chunks = -(-q_counts.max(1) // per)
            q_first = np.cumsum(q_chunks) - q_chunks
            words = np.zeros((int(q_chunks.sum()), COMBINE_QUAD, 4), np.uint32)
            # every entry's quad and slot, and its place in its pair's run
            slot_of = np.full(len(pos), 0)
            slot_of[q_pos[q_pos >= 0]] = np.flatnonzero(q_pos.ravel() >= 0)
            slot = slot_of[e_pos]
            j = np.arange(ent.size) - (np.cumsum(counts) - counts)[e_pos]
            chunk = q_first[slot // COMBINE_QUAD] + j // per
            s = slot % COMBINE_QUAD
            if wide:
                words[chunk, s, 0] = place
                words[chunk, s, 1] = c_a
                words[chunk, s, 2] = c_b
            else:
                words[chunk, s, 2 * (j % per)] = (c_a << 16) | place
                words[chunk, s, 2 * (j % per) + 1] = c_b
            rows_q = np.where(q_pos[..., None] >= 0,
                              pos[np.maximum(q_pos, 0)], -1)
            quads.append(np.concatenate([
                np.stack([4 * (first + q_first), q_chunks,
                          np.zeros_like(q_chunks), np.zeros_like(q_chunks)],
                         1), rows_q[..., 0], rows_q[..., 1]], 1))
            tables.append(words.reshape(-1, 4))
            unions.append(union)
            first += words.shape[0]
            group_union.append(group_union[-1] + union.size)
            group_quads.append(group_quads[-1] + len(q_pos))
        self.n_groups = len(groups)
        self.group_union = np.asarray(group_union, np.int32)
        self.group_quads = np.asarray(group_quads, np.int32)
        self.ulist = np.concatenate(unions).astype(np.int32)
        self.quads = np.concatenate(quads).astype(np.int32)
        self.table = np.concatenate(
            tables + [np.zeros((COMBINE_QUAD * COMBINE_BATCH, 4), np.uint32)])
        self.max_union = int(np.diff(self.group_union).max())
        # entries the kernel walks, padding included: its work a sample
        self.entries = per * (self.table.shape[0] - COMBINE_QUAD
                              * COMBINE_BATCH)
        self.tensors = None

    def to(self, device) -> "CombineLayout":
        """Upload the arrays to ``device`` (a CUDA device) once."""
        if self.tensors is None:
            self.tensors = tuple(
                _on_device(a if a.size else np.zeros(4, np.int32), device)
                for a in (self.group_quads, self.group_union, self.ulist,
                          self.quads, self.table.view(np.int32)))
        return self


class CombineTable:
    """A combine matrix as the fold kernel reads it, built on the host
    once and kept on ``device`` for every launch.

    Its CSR form, per real row its nonzeros in column order:

    * ``row_ptr`` (n_real + 1,) int32 — row ``r``'s entries are
      ``row_ptr[r] .. row_ptr[r + 1]``;
    * ``cols`` (nnz,) int32 — the shared row each entry reads;
    * ``coeffs`` (nnz,) int32 — its coefficient modulo 2**32;

    and, cut from it for the kernel, a `CombineLayout` for each number of
    row groups a launch asks for (`layout`, built and uploaded at first
    use).  ``wide`` says whether a coefficient leaves the compact entry's
    16 bits.  ``combine`` keeps the int64 matrix for `combine_plain`."""

    def __init__(self, combine, device=None):
        c = np.ascontiguousarray(np.asarray(combine), np.int64)
        if c.ndim != 2:
            raise ValueError(f"combine must be 2-D, got {c.shape}")
        self.combine = c
        self.n_real, self.n_shared = c.shape
        rows, cols = np.nonzero(c)  # row-major: grouped by row
        self.row_ptr = np.searchsorted(
            rows, np.arange(self.n_real + 1)).astype(np.int32)
        self.cols = cols.astype(np.int32)
        vals = c[rows, cols]
        self.coeffs = (vals & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        self.wide = bool(vals.size) and not (
            -COMPACT_COEFF <= vals.min() and vals.max() < COMPACT_COEFF)
        self.live_rows = int(np.count_nonzero(np.diff(self.row_ptr)))
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self._layouts: dict = {}

    @property
    def nnz(self) -> int:
        return int(self.cols.size)

    def layout(self, n_groups: int) -> CombineLayout:
        """The `CombineLayout` at ``n_groups`` row groups, cached; on a
        CUDA table its arrays are on the device."""
        hit = self._layouts.get(n_groups)
        if hit is None:
            hit = CombineLayout(self.row_ptr, self.cols, self.coeffs,
                                self.n_shared, n_groups, self.wide)
            if self.device.type == "cuda":
                hit.to(self.device)
            self._layouts[n_groups] = hit
        return hit

    def groups_for(self, n_chan: int, n_out: int, sms: int) -> int:
        """Row groups for a launch over ``n_chan`` × ``n_out``: one, unless
        the spans of all channels leave SMs idle; then the largest power
        of two that keeps the blocks within ``sms``, each group at least a
        quad for every warp of a block."""
        spans = -(-n_out // COMBINE_SPAN) * n_chan
        g = 1
        while (2 * g * spans <= sms
               and 2 * g * COMBINE_QUAD * COMBINE_WARPS <= self.live_rows):
            g *= 2
        return g


def combine_walk(y, layout: CombineLayout, n_real: int) -> np.ndarray:
    """The fold kernel's arithmetic in numpy, read back from its table:
    ``y`` int32 (rows, C, n) → the (n_real, C, n) int32 real rows after
    the fold.  Group by group it stages the union rows, and for each pair
    of each quad decodes its chunks as the kernel does (compact or wide
    entries; a zero entry reads staged row 0 and adds 0), sums each row's
    coefficient × staged row modulo 2**32 and adds it to the row (a piece
    to what earlier pieces left there)."""
    yy = np.asarray(y, np.int32).view(np.uint32).astype(np.uint64)
    out = yy[:n_real].copy()
    words = layout.table
    for g in range(layout.n_groups):
        staged = yy[n_real + layout.ulist[layout.group_union[g]:
                                          layout.group_union[g + 1]]]
        for q in layout.quads[layout.group_quads[g]:
                              layout.group_quads[g + 1]]:
            first, n_chunks = q[0], q[1]
            quad = words[first:first + 4 * n_chunks].reshape(
                n_chunks, COMBINE_QUAD, 4)
            for s in range(COMBINE_QUAD):
                e = quad[:, s]
                if layout.wide:
                    place, c_a, c_b = e[:, 0], e[:, 1], e[:, 2]
                else:
                    e = e.reshape(-1, 2)
                    place = e[:, 0] & 0xFFFF
                    c_a = (e[:, 0].view(np.int32) >> 16).view(np.uint32)
                    c_b = e[:, 1]
                rows = staged[place // 8]
                for row, coef in ((q[4 + s], c_a), (q[8 + s], c_b)):
                    if row >= 0:
                        out[row & (COMBINE_PIECE - 1)] += np.tensordot(
                            coef.astype(np.uint64), rows, axes=1)
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


_COMBINE_CACHE: dict = {}


def combine_table(combine, device) -> CombineTable:
    """The `CombineTable` of a combine matrix on ``device``, cached per
    (matrix object, device): an optimized program's frozen ``combine``
    builds and uploads its table once, shared by its engines and calls."""
    dev = torch.device(device)
    key = (id(combine), str(dev))
    hit = _COMBINE_CACHE.get(key)
    if hit is not None and hit[0]() is combine:
        return hit[1]
    table = CombineTable(combine, dev)
    _COMBINE_CACHE[key] = (weakref.ref(combine), table)
    while len(_COMBINE_CACHE) > TERMS_CACHE_MAX:
        del _COMBINE_CACHE[next(iter(_COMBINE_CACHE))]
    return table


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2**32 (two's complement), on any device."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def combine_plain(y: torch.Tensor, combine, n_real: int) -> torch.Tensor:
    """Plain version of the fold: ``y[:n_real] + combine @ y[n_real:]``
    over the leading axis of ``y`` (int32 (rows, ...)), in int64 with a
    wrapping cast to int32 — the residue modulo 2**32 of the reference's
    int32 GEMM (`_combine_shared`) and host fold (`_host_combine_i32`).
    Returns a new (n_real, ...) tensor.  Torch has no integer matmul on
    CUDA: there the shared rows are split into 16-bit halves, each
    contracted exactly in float64 (rows whose |coefficients| sum to
    2**37 or more raise)."""
    c = (combine.to(y.device, torch.int64) if torch.is_tensor(combine)
         else torch.tensor(np.asarray(combine, np.int64), device=y.device))
    if c.shape != (n_real, y.shape[0] - n_real):
        raise ValueError(f"combine {tuple(c.shape)} does not fold "
                         f"{y.shape[0]} rows into {n_real}")
    real = y[:n_real].to(torch.int64)
    shared = y[n_real:]
    if y.device.type == "cpu":
        return _wrap_i32(real + torch.tensordot(c, shared.to(torch.int64),
                                                dims=1))
    if c.numel() and int(c.abs().sum(1).max()) >= F64_FOLD_ROW_LIMIT:
        raise ValueError("the float64 plain fold is exact only for rows "
                         "whose |coefficients| sum below 2**37")
    cf = c.to(torch.float64)
    lo = torch.tensordot(cf, (shared & 0xFFFF).to(torch.float64), dims=1)
    hi = torch.tensordot(cf, (shared >> 16).to(torch.float64), dims=1)
    return _wrap_i32(real + lo.to(torch.int64)
                     + ((hi.to(torch.int64) & 0xFFFF) << 16))


@spanned("launch.fold")
def combine_fold(y: torch.Tensor, table: CombineTable) -> torch.Tensor:
    """Fold a CSE-optimized bank's shared rows into its real rows, in
    place: ``y`` is int32 (n_real + n_shared, C, n) with rows of unit
    stride (K1's `bank_output` view or a contiguous buffer); each real
    row becomes ``y[r] + Σ_s combine[r, s] · y[n_real + s]`` modulo
    2**32, and the first ``n_real`` rows are returned as a view.  CPU
    tensors take `combine_plain`; CUDA tensors launch the kernel over the
    table's `CombineLayout` for this grid (`CombineTable.groups_for`) or
    raise."""
    n_rows = table.n_real + table.n_shared
    if (y.dtype != torch.int32 or y.ndim != 3 or y.shape[0] != n_rows
            or y.stride(2) != 1):
        raise ValueError(f"y must be int32 ({n_rows}, C, n) with rows of "
                         f"unit stride, got {y.dtype} {tuple(y.shape)}")
    dev = y.device
    if dev.type == "cpu":
        y[:table.n_real] = combine_plain(y, table.combine, table.n_real)
        return y[:table.n_real]
    if dev.type != "cuda" or table.device != dev:
        raise ValueError(f"y on {dev}, combine table on {table.device}")
    n_chan, n_out = y.shape[1], y.shape[2]
    if table.n_real and n_chan and n_out:
        lay = table.layout(table.groups_for(n_chan, n_out, sm_count(dev)))
        group_quads, group_union, ulist, quads, words = lay.tensors
        with torch.cuda.device(dev):
            err = _combine_library().blmac_combine_launch(
                y.data_ptr(), y.stride(0), y.stride(1), table.n_real,
                n_chan, n_out, lay.n_groups, lay.max_union,
                group_quads.data_ptr(), group_union.data_ptr(),
                ulist.data_ptr(), quads.data_ptr(), words.data_ptr(),
                int(lay.wide), torch._C._cuda_getCurrentRawStream(dev.index),
            )
        _raise_on(err, "blmac_combine_kernel")
        combine_fold.launches += 1
    return y[:table.n_real]


combine_fold.launches = 0


@functools.lru_cache(maxsize=1)
@spanned("build.library")
def _combine_library():
    """The fold's C library, built and loaded at the first launch."""
    from .build import library

    return library("blmac_combine")


def reset_launch_counts() -> None:
    """Zero the FIR kernels' launch counters (K1, K2 and its tensor-core
    route, the fold)."""
    bank_apply.launches = 0
    specialized_call.launches = 0
    specialized_call.wgmma_launches = 0
    combine_fold.launches = 0


def _as_table(combine, n_real, device) -> CombineTable | None:
    """``combine`` (a matrix, whose table for ``device`` is cached, or a
    `CombineTable`) as a table; checks ``n_real`` against it."""
    if combine is None:
        return None
    table = combine if isinstance(combine, CombineTable) \
        else combine_table(np.asarray(combine), device)
    if n_real is not None and int(n_real) != table.n_real:
        raise ValueError(f"n_real {n_real} but combine has {table.n_real} "
                         f"rows")
    return table


def bank_schedule_apply(
    frames: torch.Tensor,  # (C, n_tiles, frame_len) int32 framed signal
    schedule: BankSchedule,
    taps: int,
    tile: int,
    n_out: int | None = None,
    terms: BankTerms | None = None,
    combine=None,
    n_real: int | None = None,
) -> torch.Tensor:
    """Run every tile group of a `BankSchedule` over pre-framed signal →
    (B, C, n_out) int32 in the caller's filter order (``n_out`` defaults
    to ``n_tiles · tile``).

    On CUDA frames: one K1 launch for all groups, all-zero ones included
    (their rows come out zero), each row written straight at its output
    row — no reorder, no slice copy.  ``terms`` supplies the schedule's
    tables already on that device; by default `bank_terms` builds them
    once per schedule and device.  On CPU frames: the plain version per
    group with populated layers, zeros for the rest, then the reorder.

    ``combine`` (a matrix or its `CombineTable`) and ``n_real`` run a
    CSE-optimized program's shared-row layout, as the reference does:
    rows past ``n_real`` are shared partial sums, folded into the real
    rows afterwards (`combine_fold`: one more launch, in place), and the
    result is the first ``n_real`` rows."""
    n_chan, n_tiles, _ = frames.shape
    n_out = n_tiles * tile if n_out is None else int(n_out)
    dev = frames.device
    table = _as_table(combine, n_real, dev)
    if dev.type != "cpu":
        if terms is None:
            with span("plan"):
                terms = bank_terms(schedule, taps, dev)
        y = bank_apply(frames, terms, tile, n_out)
        return y if table is None else combine_fold(y, table)
    with span("launch.k1"):
        parts = []
        for g in schedule.groups:
            if g.sel_layers:
                parts.append(bank_call_plain(
                    frames, _on_device(g.packed.view(np.int32), dev), taps,
                    g.schedule, g.tail_shift, tile))
            else:  # all-zero tile group
                parts.append(torch.zeros((g.packed.shape[0], n_chan, n_tiles,
                                          tile), dtype=torch.int32))
        y = torch.cat(parts).reshape(-1, n_chan, n_tiles * tile)
        y = y.index_select(0, torch.as_tensor(schedule.inv))[:, :, :n_out]
    return y if table is None else combine_fold(y, table)


def blmac_fir_bank(
    x: torch.Tensor,  # (C, T) or (T,)
    packed: np.ndarray,  # (B, n_layers, n_words) uint32 packed trits
    taps: int,
    tile: int = 1024,
    bank_tile: int | None = None,
    merge: int = MERGE_DEFAULT,
    schedule: BankSchedule | None = None,
    fast_path: bool = True,
    combine=None,
    n_real: int | None = None,
) -> torch.Tensor:
    """Apply a B-filter bank to a C-channel signal on ``x``'s device with
    the scheduled bank kernel (one launch for the whole bank).

    Returns int32 (B, C, T − taps + 1), or (B, T − taps + 1) for 1-D
    ``x``; bit-exact against `fir_bit_layers_batch`.  ``fast_path``
    routes banks of ≤ `FAST_PATH_MAX` filters to the specialized kernel
    (`specialized_bank`, the pulse tuples unpacked from ``packed``).
    Pass a precomputed ``schedule`` to skip planning on the hot path (a
    program's memoized schedule also reuses its kernel tables).
    ``combine``/``n_real`` run a CSE-optimized shared-row bank (see
    `bank_schedule_apply`); the result then has ``n_real`` rows."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    packed = np.asarray(packed)
    n_filters = packed.shape[0]
    if (fast_path and schedule is None and combine is None
            and n_filters <= FAST_PATH_MAX):
        with span("plan"):
            pulses = [pulses_from_packed(packed[b], taps)
                      for b in range(n_filters)]
        y = specialized_bank(x, pulses, taps, tile)
        return y[:, 0, :] if squeeze else y
    if schedule is None:
        with span("plan"):
            schedule = plan_bank_schedule(packed, bank_tile, merge)
    # framed before `bank_schedule_apply` first uploads K1's tables: with
    # two outputs of a large bank in flight the card is nearly full, and
    # in the other order the frames' cached block is later taken, so the
    # frames split a freed output's and the next output does not fit
    with span("frame"):
        frames, n_out = frame_signal_batch(x.to(torch.int32), taps, tile)
    y = bank_schedule_apply(frames, schedule, taps, tile, n_out,
                            combine=combine, n_real=n_real)
    return y[:, 0] if squeeze else y


def blmac_fir_dynamic(
    x: torch.Tensor,
    trits: np.ndarray,  # (n_layers, M_pad) int8, layer-major, {-1,0,1}
    taps: int,
    n_layers: int,
    tile: int = 1024,
) -> torch.Tensor:
    """Single-filter runtime-trit entry point: a B=1 scheduled bank call.

    The trits are wrapped as a content-addressed `BlmacProgram`
    (`compile_packed`), which asserts the §2.1 int32 bound and memoizes
    the B=1 superlayer schedule."""
    trits = np.asarray(trits)
    half = taps // 2
    packed = pack_trits(trits[None, :n_layers, : half + 1])  # (1, L, W)
    prog = compile_packed(packed, taps)
    return blmac_fir_bank(
        x, prog.packed, taps, tile, fast_path=False,
        schedule=prog.schedule(bank_tile=1),
    )[0]
