"""BLMAC FIR filtering on the GPU: single filters and whole banks.

The port of `repro.kernels.blmac_fir`.  Two hand-written CUDA kernels
carry it, each with a plain PyTorch version of the same function beside
it:

  * **bank** (`bank_call`, kernel ``csrc/blmac_bank.cu``) — one launch
    per occupancy tile group of a `BankSchedule`: B filters × C channels
    over framed signal tiles, the superlayer schedule passed as a small
    runtime table.  Replaces the TPU kernel `_fir_kernel_bank`.
  * **specialized** (`specialized_call`, kernel
    ``csrc/blmac_specialized.cu``) — one filter's MSB-first CSD pulse
    list, held as a device table in the `specialized_program` LRU.
    Replaces `_fir_kernel_specialized`.

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
    "pulses_msb_first",
    "reset_launch_counts",
    "schedule_table",
    "specialized_call",
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
# K2: the pulse-specialized single-filter kernel
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


def pulse_table(pulses, taps: int) -> tuple[np.ndarray, int]:
    """The specialized kernel's operand: int32 (n_pulses, 4) rows
    ``(shift_before, j, j_mirror or -1 at the centre, sign)`` and the
    final shift down to layer 0 — the Horner walk of the reference
    kernel, one row per pulse."""
    half = taps // 2
    rows = []
    layer_of = None
    for layer, j, sign in pulses:
        shift = 0 if layer_of is None else layer_of - layer
        layer_of = layer
        rows.append((shift, j, -1 if j == half else taps - 1 - j, sign))
    table = np.asarray(rows, np.int32).reshape(len(rows), 4)
    return table, (layer_of or 0)


def specialized_plain(
    frames: torch.Tensor, pulses, taps: int, tile: int
) -> torch.Tensor:
    """Plain version of the specialized kernel: (n_tiles, frame_len)
    int32 frames → (n_tiles, tile) int32, one vector add per pulse and
    one shift per layer boundary (adds and shifts only, on any device)."""
    half = taps // 2
    u = {}
    for j in sorted({j for (_, j, _) in pulses}):
        if j == half:
            u[j] = frames[:, half:half + tile]
        else:
            u[j] = frames[:, j:j + tile] + frames[:, taps - 1 - j:taps - 1 - j + tile]
    acc = torch.zeros((frames.shape[0], tile), dtype=torch.int32,
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
    """One filter's compiled BLMAC program: its pulse tuple and, for a
    CUDA device, the specialized kernel's pulse table resident there."""

    def __init__(self, pulses, taps: int, tile: int, device: torch.device):
        self.pulses = pulses
        self.taps = taps
        self.tile = tile
        self.device = device
        table, self.final_shift = pulse_table(pulses, taps)
        self.table = _on_device(table, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(T,) samples on this program's device → (T − taps + 1,) int32."""
        frames, n_out = frame_signal(x.to(torch.int32), self.taps, self.tile)
        return specialized_call(frames, self).reshape(-1)[:n_out]


@functools.lru_cache(maxsize=1024)
def specialized_program(pulses, taps: int, tile: int, device: str):
    """The compiled program for one pulse schedule on one device.

    LRU-cached on ``(pulses, taps, tile, device)``: reprogramming a filter
    seen before is a dict hit and reuses its device-resident pulse table —
    the software analogue of reloading the FPGA weight memory."""
    return SpecializedProgram(pulses, taps, tile, torch.device(device))


def specialized_call(frames: torch.Tensor, prog: SpecializedProgram):
    """Run one `SpecializedProgram` over (n_tiles, frame_len) int32
    frames → (n_tiles, tile) int32: the plain version for CPU frames, the
    CUDA kernel for CUDA frames."""
    _check_frames(frames, 2, prog.taps, prog.tile)
    if frames.device.type == "cpu":
        return specialized_plain(frames, prog.pulses, prog.taps, prog.tile)
    if frames.device.type != "cuda" or frames.device != prog.table.device:
        raise ValueError(f"frames on {frames.device}, program on "
                         f"{prog.table.device}")
    from .build import library

    n_tiles = frames.shape[0]
    out = torch.empty((n_tiles, prog.tile), dtype=torch.int32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        err = library("blmac_specialized").blmac_specialized_launch(
            frames.data_ptr(), frames.stride(0), prog.table.data_ptr(),
            prog.table.shape[0], prog.final_shift, out.data_ptr(), n_tiles,
            prog.tile, prog.taps, _stream(frames.device),
        )
    _raise_on(err, "blmac_specialized_kernel")
    specialized_call.launches += 1
    return out


specialized_call.launches = 0


def blmac_fir_specialized(
    x: torch.Tensor, pulses, taps: int, tile: int = 1024
) -> torch.Tensor:
    """Apply one pulse-specialized filter to (T,) samples on ``x``'s
    device; the program is built at most once per distinct
    (pulse schedule, taps, tile, device)."""
    return specialized_program(tuple(pulses), taps, tile, str(x.device))(x)


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
        n_out = xi.shape[-1] - taps + 1
        y = torch.stack([
            torch.stack([
                blmac_fir_specialized(
                    xi[c], pulses_from_packed(packed[b], taps), taps, tile
                )
                for c in range(xi.shape[0])
            ])
            for b in range(n_filters)
        ])[:, :, :n_out]
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
