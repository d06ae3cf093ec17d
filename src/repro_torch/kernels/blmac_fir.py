"""BLMAC FIR filtering on the GPU: single filters and whole banks.

The port of `repro.kernels.blmac_fir`.  Two hand-written CUDA kernels
carry it, each with a plain PyTorch version of the same function beside
it:

  * **bank** (`bank_call`, kernel ``csrc/blmac_bank.cu``) — one launch
    per occupancy tile group of a `BankSchedule`: B filters × C channels
    over framed signal tiles, the superlayer schedule passed as a small
    runtime table.  Replaces the TPU kernel `_fir_kernel_bank`.
  * **specialized** (`specialized_call`, kernel
    ``csrc/blmac_specialized.cu``) — the filters' CSD pulse lists as
    tap-major device tables (`pulse_table`), one launch for every filter
    and channel of a call; one filter's table is cached in the
    `specialized_program` LRU.  Replaces `_fir_kernel_specialized`.

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

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.program import compile_packed
from ..compiler.schedule import (BankSchedule, MERGE_DEFAULT,
                                 plan_bank_schedule)
from ..core.csd import csd_digits, pack_trits, unpack_trits

__all__ = [
    "FAST_PATH_MAX",
    "LANE",
    "bank_call",
    "bank_call_plain",
    "bank_schedule_apply",
    "blmac_fir_bank",
    "blmac_fir_dynamic",
    "blmac_fir_specialized",
    "frame_signal",
    "frame_signal_batch",
    "pulses_from_packed",
    "pulse_table",
    "pulse_table_walk",
    "pulse_tables",
    "pulses_msb_first",
    "reset_launch_counts",
    "schedule_table",
    "specialized_call",
    "specialized_geometry",
    "specialized_plain",
    "specialized_program",
]

LANE = 128
TRITS_PER_WORD = 16
FAST_PATH_MAX = 1  # banks up to this size dispatch to specialized programs

# the plain bank version contracts in float64 on the GPU (torch has no
# integer matmul there): exact while |u| <= 2 * 2**7, i.e. 8-bit samples
F64_SAMPLE_LIMIT = 128


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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
                     taps: int, tile: int) -> np.ndarray:
    """Plain walk of `pulse_tables`' layout, in numpy uint32 (which wraps
    modulo 2**32 as the kernel's registers do): (..., n_tiles,
    frame_len) int32 frames → (F, ..., n_tiles, tile) int32 — the kernel's
    loop, tap by tap, fold then one multiply-add per pulse."""
    x = np.asarray(frames, np.int32).view(np.uint32)
    words = np.asarray(table, np.int32).view(np.uint32)
    half = taps // 2
    out = []
    for f in range(len(offsets) - 1):
        t = words[offsets[f]:offsets[f + 1]]
        acc = np.zeros(x.shape[:-1] + (tile,), np.uint32)
        p = 1
        for j in [*range(int(t[0])), half]:
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


# K2's launch geometry (``kOuts`` and the block limit in the .cu source):
# each thread keeps OUTS_PER_THREAD outputs of one tile in registers, and a
# block has at most SPECIALIZED_MAX_THREADS threads
OUTS_PER_THREAD = 16
SPECIALIZED_MAX_THREADS = 256
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use


def specialized_geometry(tile: int, taps: int, table_len: int):
    """K2's block for one launch: ``(threads, columns, tab_pad,
    smem_bytes)``.  Enough warps to cover the tile (at most
    `SPECIALIZED_MAX_THREADS` threads), each thread `OUTS_PER_THREAD`
    consecutive columns; the shared memory holds the longest filter table
    (padded to 4 words) and the ``columns + taps − 1`` samples, one pad
    word every 32.  Raises ``ValueError`` when that does not fit a block
    (no fallback)."""
    warps = min(SPECIALIZED_MAX_THREADS // 32,
                -(-tile // (32 * OUTS_PER_THREAD)))
    threads = 32 * warps
    cols = threads * OUTS_PER_THREAD
    tab_pad = _pad_to(table_len, 4)
    n_x = cols + taps - 1  # samples, one pad word every 32 in shared memory
    smem = 4 * (tab_pad + n_x + n_x // 32 + 1)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the specialized kernel needs {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")
    return threads, cols, tab_pad, smem


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


class SpecializedProgram:
    """Compiled BLMAC programs of one or more filters for K2: their pulse
    tuples and, on a CUDA device, their concatenated tables (`pulse_tables`)
    resident there, so every call is one launch for all filters and
    channels."""

    def __init__(self, schedules, taps: int, tile: int, device: torch.device):
        self.schedules = tuple(schedules)
        self.taps = taps
        self.tile = tile
        self.device = device
        table, offsets = pulse_tables(self.schedules, taps)
        self.table_len = int(np.diff(offsets).max(initial=0))
        self.geometry = specialized_geometry(tile, taps, self.table_len)
        self.table = _on_device(table, device)
        self.offsets = _on_device(offsets, device)

    @property
    def n_filters(self) -> int:
        return len(self.schedules)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(T,) or (C, T) samples on this program's device → (F, T − taps
        + 1) or (F, C, T − taps + 1) int32."""
        xb = x.to(torch.int32)
        frames, n_out = frame_signal_batch(xb[None] if x.ndim == 1 else xb,
                                           self.taps, self.tile)
        y = specialized_call(frames, self)
        y = y.reshape(y.shape[0], y.shape[1], -1)[:, :, :n_out]
        return y[:, 0] if x.ndim == 1 else y


@functools.lru_cache(maxsize=1024)
def specialized_program(pulses, taps: int, tile: int, device: str):
    """The compiled program for one pulse schedule on one device.

    LRU-cached on ``(pulses, taps, tile, device)``: reprogramming a filter
    seen before is a dict hit and reuses its device-resident pulse table —
    the software analogue of reloading the FPGA weight memory."""
    return SpecializedProgram((pulses,), taps, tile, torch.device(device))


def specialized_call(frames: torch.Tensor, prog: SpecializedProgram):
    """Run every filter of a `SpecializedProgram` over (C, n_tiles,
    frame_len) int32 frames → (F, C, n_tiles, tile) int32 (2-D frames:
    no channel axis in or out): the plain version for CPU frames, one
    CUDA launch for CUDA frames."""
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
        threads, _, tab_pad, _ = prog.geometry
        err = _specialized_library().blmac_specialized_launch(
            frames.data_ptr(), frames.stride(0) if len(lead) == 2 else 0,
            frames.stride(-2), prog.table.data_ptr(), prog.offsets.data_ptr(),
            tab_pad, out.data_ptr(), prog.n_filters,
            lead[0] if len(lead) == 2 else 1, lead[-1], prog.tile, prog.taps,
            threads, torch._C._cuda_getCurrentRawStream(dev.index), dev.index,
        )
        _raise_on(err, "blmac_specialized_kernel")
        specialized_call.launches += 1
    return out


@functools.lru_cache(maxsize=1)
def _specialized_library():
    """K2's C library, built and loaded at the first launch."""
    from .build import library

    return library("blmac_specialized")


specialized_call.launches = 0


def blmac_fir_specialized(
    x: torch.Tensor, pulses, taps: int, tile: int = 1024
) -> torch.Tensor:
    """Apply one pulse-specialized filter to (T,) or (C, T) samples on
    ``x``'s device → (T − taps + 1,) or (C, T − taps + 1) int32, in one
    launch; the program is built at most once per distinct (pulse
    schedule, taps, tile, device)."""
    return specialized_program(tuple(pulses), taps, tile, str(x.device))(x)[0]


# ---------------------------------------------------------------------------
# K1: the scheduled bank kernel
# ---------------------------------------------------------------------------

def schedule_table(schedule: tuple, tail_shift: int) -> np.ndarray:
    """Flatten one tile group's superlayer schedule into the bank
    kernel's runtime table: ``[n_super, tail_shift, (shift_in, n_parts,
    (sel_idx, rel) * n_parts) * n_super]`` as int32."""
    v = [len(schedule), int(tail_shift)]
    for shift_in, parts in schedule:
        v += [int(shift_in), len(parts)]
        for sel_idx, rel in parts:
            v += [int(sel_idx), int(rel)]
    return np.asarray(v, np.int32)


def bank_call_plain(
    frames: torch.Tensor,  # (C, n_tiles, frame_len) int32
    packed: torch.Tensor,  # (rows, n_sel, n_words) int32, selected layers
    taps: int,
    schedule: tuple,
    tail_shift: int,
    tile: int,
) -> torch.Tensor:
    """Plain version of the bank kernel, modelled on the reference's
    `_bank_call_xla`: the window matrix of every (channel, tile) cell at
    once, then one contraction per superlayer → (rows, C, n_tiles, tile)
    int32.

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


def bank_call(
    frames: torch.Tensor,
    packed: torch.Tensor,
    taps: int,
    schedule: tuple,
    tail_shift: int,
    tile: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Run one tile group: (C, n_tiles, frame_len) int32 frames and its
    (rows, n_sel, n_words) int32 packed operand → (rows, C, n_tiles,
    tile) int32, written into ``out`` when given.  The plain version for
    CPU frames, the CUDA kernel for CUDA frames."""
    _check_frames(frames, 3, taps, tile)
    n_chan, n_tiles, _ = frames.shape
    rows, n_sel, n_words = packed.shape
    if packed.dtype != torch.int32 or packed.device != frames.device:
        raise ValueError(f"packed must be int32 on {frames.device}, got "
                         f"{packed.dtype} on {packed.device}")
    shape = (rows, n_chan, n_tiles, tile)
    if out is not None and (tuple(out.shape) != shape or not
                            out.is_contiguous() or out.dtype != torch.int32
                            or out.device != frames.device):
        raise ValueError(f"out must be contiguous int32 {shape} on "
                         f"{frames.device}")
    if frames.device.type == "cpu":
        y = bank_call_plain(frames, packed, taps, schedule, tail_shift, tile)
        return y if out is None else out.copy_(y)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    from .build import library

    packed = packed.contiguous()
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=frames.device)
    table = schedule_table(schedule, tail_shift)
    with torch.cuda.device(frames.device):
        err = library("blmac_bank").blmac_bank_launch(
            frames.data_ptr(), frames.stride(0), frames.stride(1),
            packed.data_ptr(), out.data_ptr(), rows, n_chan, n_tiles, tile,
            taps, n_sel, n_words, table.ctypes.data, table.size,
            _stream(frames.device),
        )
    _raise_on(err, "blmac_bank_kernel")
    bank_call.launches += 1
    return out


bank_call.launches = 0


def reset_launch_counts() -> None:
    """Zero both kernels' launch counters."""
    bank_call.launches = 0
    specialized_call.launches = 0


def bank_schedule_apply(
    frames: torch.Tensor,  # (C, n_tiles, frame_len) int32 framed signal
    schedule: BankSchedule,
    taps: int,
    tile: int,
    device_groups: list | None = None,
) -> torch.Tensor:
    """Run every tile group of a `BankSchedule` over pre-framed signal and
    reassemble rows in the caller's filter order → (B, C, n_tiles*tile).

    One kernel launch per group with populated layers, each writing its
    rows of one output buffer; all-zero groups are filled with zeros and
    launch nothing.  The reorder ``y[inv]`` (dropping pad rows) runs on
    the frames' device.  ``device_groups`` optionally supplies the
    groups' packed operands already on that device (int32 view, None for
    all-zero groups), so a streaming caller uploads the bank once."""
    n_chan, n_tiles, _ = frames.shape
    dev = frames.device
    b_pad = sum(g.packed.shape[0] for g in schedule.groups)
    y = torch.empty((b_pad, n_chan, n_tiles, tile), dtype=torch.int32,
                    device=dev)
    row = 0
    for gi, g in enumerate(schedule.groups):
        rows = g.packed.shape[0]
        part = y[row:row + rows]
        row += rows
        if not g.sel_layers:  # all-zero tile group: no kernel at all
            part.zero_()
            continue
        op = (
            device_groups[gi] if device_groups is not None
            else _on_device(g.packed.view(np.int32), dev)
        )
        bank_call(frames, op, taps, g.schedule, g.tail_shift, tile, out=part)
    inv = torch.as_tensor(schedule.inv, device=dev)
    return y.reshape(b_pad, n_chan, n_tiles * tile).index_select(0, inv)


def blmac_fir_bank(
    x: torch.Tensor,  # (C, T) or (T,)
    packed: np.ndarray,  # (B, n_layers, n_words) uint32 packed trits
    taps: int,
    tile: int = 1024,
    bank_tile: int | None = None,
    merge: int = MERGE_DEFAULT,
    schedule: BankSchedule | None = None,
    fast_path: bool = True,
) -> torch.Tensor:
    """Apply a B-filter bank to a C-channel signal on ``x``'s device with
    the scheduled bank kernel (one launch per occupancy tile group).

    Returns int32 (B, C, T − taps + 1), or (B, T − taps + 1) for 1-D
    ``x``; bit-exact against `fir_bit_layers_batch`.  ``fast_path``
    routes banks of ≤ `FAST_PATH_MAX` filters to the specialized kernel.
    Pass a precomputed ``schedule`` to skip planning on the hot path."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    packed = np.asarray(packed)
    n_filters = packed.shape[0]
    xi = x.to(torch.int32)
    if fast_path and schedule is None and n_filters <= FAST_PATH_MAX:
        y = torch.stack([  # one launch per filter, all channels
            blmac_fir_specialized(xi, pulses_from_packed(packed[b], taps),
                                  taps, tile)
            for b in range(n_filters)
        ])
        return y[:, 0, :] if squeeze else y
    if schedule is None:
        schedule = plan_bank_schedule(packed, bank_tile, merge)
    frames, n_out = frame_signal_batch(xi, taps, tile)
    y = bank_schedule_apply(frames, schedule, taps, tile)
    return y[:, 0, :n_out] if squeeze else y[:, :, :n_out]


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
