"""Streaming filter-bank engine: overlap-save BLMAC over B filters × C channels.

The port of `repro.filters.FilterBankEngine`.  Feed it chunks of a
multi-channel sample stream and it returns, for every filter of the bank,
the output samples that became computable, carrying the ``taps − 1``
sample tail between chunks (overlap-save) so consecutive pushes give one
gapless stream per (filter, channel).

Modes:

  * ``"packed"`` (alias ``"scheduled"``) — the scheduled bank kernel: the
    filters sorted into occupancy-homogeneous bank tiles at construction
    (`BlmacProgram.schedule`), the kernel's tables for every tile group
    built and uploaded to the device once (`bank_terms`), one launch per
    push.
  * ``"specialized"`` — the pulse-specialized kernel: one launch per
    push for every filter and channel, the filters' pulse tables
    concatenated and uploaded to the device once, at construction.
  * ``"auto"`` — the default: `autotune_bank_dispatch` prices both paths
    (and the scheduled tile/merge grid) with the cost model — the
    reference's constants on the CPU, the ``"cuda"`` lane fitted on the
    card — and the engine keeps the winner's plan (``dispatch_plan``).

A CSE-optimized program (`repro_torch.compiler.cse_pass`) serves its
parent's filters: the engine runs the augmented bank through K1 or K2,
then folds the shared rows into the real ones (the combine kernel, in
place), and its ``n_filters`` and ``qbank`` are the parent's.  In
``"auto"`` mode the planner may decline the shared-row layout
(``dispatch_plan.cse == "declined"``); the engine then runs the parent.

Arithmetic contract: int32 throughout; the §2.1 bound is asserted once,
inside `compile_bank`.  Every mode agrees with `fir_bit_layers_batch`
and with the reference engine to the last bit on integer inputs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler import BlmacProgram, MERGE_DEFAULT, TailSnapshot, compile_bank
from ..kernels.blmac_fir import (SpecializedProgram, bank_schedule_apply,
                                 bank_terms, combine_fold, combine_table,
                                 frame_signal_batch, specialized_call)
from ..kernels.ops import as_device_tensor
from ..kernels.runtime import (DEFAULT_TILE, autotune_bank_dispatch,
                               resolve_device)

# the reference's legacy crossover (banks below it → specialized), kept
# for callers that force a mode; the planner decides ``mode="auto"``
SPECIALIZE_THRESHOLD = 8

__all__ = ["FilterBankEngine", "SPECIALIZE_THRESHOLD", "DEFAULT_TILE"]


class FilterBankEngine:
    """Overlap-save streaming application of a quantized FIR filter bank.

    Parameters
    ----------
    qbank : (B, taps) or (taps,) int array, or `BlmacProgram`
        Quantized odd symmetric (type-I) coefficients, one row per filter,
        compiled via `compile_bank` (content-addressed); a prebuilt or
        `load()`ed program skips compilation.  An `OptimizedProgram`
        serves its parent's filters (module docstring).
    channels : int
        Number of independent input channels C.
    tile : int | None
        Output samples per signal tile (None = the plan's in ``"auto"``
        mode, else `DEFAULT_TILE`).
    mode : {"auto", "packed", "scheduled", "specialized"}
        See the module docstring; ``"auto"`` runs the dispatch planner.
    bank_tile : int | None
        Filters per bank tile of the schedule (None = the plan's or the
        heuristic).
    merge : int | None
        CSD layers fused per superlayer (None = the plan's or
        `MERGE_DEFAULT`).
    device : str | torch.device | None
        Where the kernels run; None = the GPU (raises without one),
        ``"cpu"`` = the plain PyTorch versions.
    chunk_hint : int
        Expected samples per push, the planner's amortization knob.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.filters import FilterBankEngine
    >>> bank = np.zeros((4, 15), np.int64)
    >>> bank[:, 7] = [64, 96, 160, 224]          # centre-tap scalers
    >>> eng = FilterBankEngine(bank, channels=1, device="cpu")
    >>> y = eng.push(np.arange(40, dtype=np.int32)[None, :])
    >>> y.shape
    (4, 1, 26)
    >>> bool((y[1] == 96 * np.arange(7, 33)).all())
    True
    """

    def __init__(
        self,
        qbank,
        channels: int = 1,
        tile: int | None = None,
        mode: str = "auto",
        bank_tile: int | None = None,
        merge: int | None = None,
        device=None,
        chunk_hint: int = 2048,
    ):
        if isinstance(qbank, BlmacProgram):
            program = qbank
        else:
            # float input is truncated, not quantized (the reference
            # engine's contract): pass floats through `compile_bank`
            program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if mode == "scheduled":
            mode = "packed"
        if mode not in ("auto", "packed", "specialized"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.channels = int(channels)
        self.dispatch_plan = None
        if mode == "auto":
            self.dispatch_plan, schedule = autotune_bank_dispatch(
                program, channels=self.channels, tile=tile,
                chunk_hint=chunk_hint, device=self.device,
            )
            if self.dispatch_plan.cse == "declined":
                # the plan and schedule are the parent's: run the parent
                program = program.parent
            mode = ("specialized" if self.dispatch_plan.mode == "specialized"
                    else "packed")
            if tile is None:
                tile = self.dispatch_plan.tile
            if schedule is not None:  # the plan's geometry, unless given
                bank_tile = schedule.tile_size if bank_tile is None \
                    else bank_tile
                merge = schedule.merge if merge is None else merge
        self.program = program
        # a CSE-optimized program serves its parent's filters: qbank and
        # n_filters describe the folded outputs, the shared rows stay inside
        self._combine = (None if program.combine is None
                         else combine_table(program.combine, self.device))
        self.qbank = (program.qbank if program.combine is None
                      else program.effective_qbank())
        self.n_filters = program.out_filters
        self.taps = program.taps
        self.tile = int(tile) if tile is not None else DEFAULT_TILE
        self.mode = mode
        self.merge = merge if merge is not None else MERGE_DEFAULT
        if mode == "packed":  # memoized: the plan's schedule object
            self.bank_schedule = program.schedule(bank_tile, self.merge)
            self.bank_tile = self.bank_schedule.tile_size
            # the kernel's tables go to the device once (the plain CPU
            # path reads the schedule itself)
            self._terms = (
                bank_terms(self.bank_schedule, self.taps, self.device)
                if self.device.type == "cuda" else None)
            self._spec = None
        else:
            self.bank_schedule = None
            self.bank_tile = bank_tile
            self._terms = None
            self._spec = SpecializedProgram(program.pulse_schedules(),
                                            self.taps, self.tile, self.device)
        self.reset()

    # -- cost model ---------------------------------------------------------

    def predicted_machine_cycles(self, spec=None) -> np.ndarray:
        """(B,) clock cycles per output each filter would cost on the §4
        FPGA dot-product machine (one cycle per RLE code + overhead).

        ``spec`` is a `repro_torch.core.MachineSpec` (default: the paper's
        127-tap spec parameters applied to this bank's tap count).  Reads
        `BlmacProgram.machine_cycles` — derived from the program's own CSD
        digits and memoized per spec on the program, so every engine and
        test sharing this bank shares one computation.  For an optimized
        program: each real filter's reduced row plus one cycle per combine
        use, under a spec widened by one coefficient bit.
        """
        return self.program.machine_cycles(spec)

    def predicted_mean_cycles(self, spec=None) -> float:
        """Bank-average §4 machine cycles per output sample."""
        return float(self.predicted_machine_cycles(spec).mean())

    # -- streaming API ------------------------------------------------------

    def push(self, chunk) -> np.ndarray:
        """Feed (C, n) samples (or (n,) when C == 1), as a numpy array or
        a tensor; returns the newly computable outputs as numpy int32
        (B, C, n_out) — n_out is 0 while the engine primes its taps − 1
        history."""
        buf = self._advance(self._upload(chunk))
        if buf is None:  # still priming
            return np.zeros((self.n_filters, self.channels, 0), np.int32)
        y = self._apply(buf)
        self.samples_out += y.shape[2]
        return y

    def __call__(self, chunk) -> np.ndarray:
        return self.push(chunk)

    def reset(self) -> None:
        """Drop all buffered history (start a new stream)."""
        self._tail = torch.zeros((self.channels, 0), dtype=torch.int32,
                                 device=self.device)
        self.samples_in = 0
        self.samples_out = 0

    @property
    def pending(self) -> int:
        """Samples buffered but not yet old enough to finish a window."""
        return self._tail.shape[1]

    # -- tail snapshot / restore (content-addressed stream state) -----------

    def snapshot_tail(self, session: str = "") -> TailSnapshot:
        """Freeze the overlap-save state as a `TailSnapshot` keyed to this
        engine's program digest — the reference's format, so either
        package's engine restores it."""
        return TailSnapshot(
            program_key=self.program.key, channels=self.channels,
            samples_in=self.samples_in, samples_out=self.samples_out,
            tail=self._tail.cpu().numpy().copy(), session=str(session),
        )

    def restore_tail(self, snapshot) -> None:
        """Adopt a `TailSnapshot` captured on this program (validated by
        content key and channel count — a loud error otherwise)."""
        if snapshot.program_key != self.program.key:
            raise ValueError(
                f"snapshot belongs to program {snapshot.program_key[:12]}…, "
                f"this engine runs {self.program.key[:12]}…"
            )
        if int(snapshot.channels) != self.channels:
            raise ValueError(
                f"snapshot has {snapshot.channels} channels, "
                f"engine has {self.channels}"
            )
        self._tail = torch.tensor(np.asarray(snapshot.tail, np.int32),
                                  device=self.device)
        self.samples_in = int(snapshot.samples_in)
        self.samples_out = int(snapshot.samples_out)

    # -- one-shot application ----------------------------------------------

    def apply_lanes(self, buf) -> np.ndarray:
        """Stateless one-shot application over the ``channels`` lanes:
        (C, n) samples with ``n >= taps`` → (B, C, n − taps + 1) int32,
        leaving the tail and the counters alone."""
        buf = as_device_tensor(buf, self.device).to(torch.int32)
        if buf.ndim != 2 or buf.shape[0] != self.channels:
            raise ValueError(
                f"expected ({self.channels}, n) lane buffer, "
                f"got shape {tuple(buf.shape)}"
            )
        if buf.shape[1] < self.taps:
            raise ValueError(
                f"lane buffer has {buf.shape[1]} samples, "
                f"need >= taps ({self.taps})"
            )
        return self._apply(buf)

    # -- the steps of a push (each timed by `chip_smoke.py`) -----------------

    def _upload(self, chunk) -> torch.Tensor:
        """The chunk as (C, n) int32 on the engine's device."""
        chunk = as_device_tensor(chunk, self.device).to(torch.int32)
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        if chunk.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got {chunk.shape[0]}"
            )
        return chunk

    def _advance(self, chunk: torch.Tensor) -> torch.Tensor | None:
        """Append ``chunk`` to the tail: the (C, taps − 1 + n) buffer to
        filter, keeping its last taps − 1 samples as the new tail, or None
        (the whole buffer kept) while the engine still primes."""
        self.samples_in += chunk.shape[1]
        buf = torch.cat([self._tail, chunk], 1)
        n = buf.shape[1]
        if n < self.taps:
            self._tail = buf
            return None
        self._tail = buf[:, n - (self.taps - 1):].clone()
        return buf

    def _frame(self, buf: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(C, n) samples → the kernels' (C, n_tiles, frame_len) frames
        and the n − taps + 1 outputs they yield."""
        n = buf.shape[1]
        # pad to a tile multiple as the reference does (there to bound its
        # jit shapes), so both engines frame a push identically; windows
        # reaching into the padding are dropped
        n_pad = -(-n // self.tile) * self.tile
        if n_pad != n:
            buf = F.pad(buf, (0, n_pad - n))
        frames, _ = frame_signal_batch(buf, self.taps, self.tile)
        return frames, n - self.taps + 1

    def _run(self, frames: torch.Tensor, n_out: int) -> torch.Tensor:
        """One kernel launch over the frames (and one fold for an
        optimized program) → (B, C, n_out) int32 on the engine's device,
        filters in the caller's order."""
        if self.mode == "packed":
            return bank_schedule_apply(
                frames, self.bank_schedule, self.taps, self.tile, n_out,
                terms=self._terms, combine=self._combine,
            )
        y = specialized_call(frames, self._spec)  # (B, C, n_tiles, tile)
        y = y.reshape(y.shape[0], self.channels, -1)
        if self._combine is not None:
            y = combine_fold(y, self._combine)
        return y[:, :, :n_out]

    def _apply(self, buf: torch.Tensor) -> np.ndarray:
        return self._run(*self._frame(buf)).cpu().numpy()
