"""Vectorized, bank-batched simulator of the §4 right-shift BLMAC machine.

`FirBlmacMachine` (`core/machine.py`) walks the RLE weight program one code
at a time for every output sample — faithful to the hardware, but minutes
of interpreter time for the paper's 9,900-filter Table 4 sweep.  This
module simulates the *same* datapath for a whole ``(B, taps)`` bank against
a whole signal in numpy array ops:

  * the per-layer partial sums Σ_j d[b,j,l]·u[j,t] (what the machine's
    pulse adds accumulate between two EORs) are ONE matrix product per
    bank — the (B·L, M) digit matrix times the (M, n_out) symmetric-folded
    window matrix, evaluated in float64 BLAS (exact: every addend is an
    integer of magnitude ≤ M·2^sample_bits ≪ 2^53) and cast back to int64;
  * the right-shift accumulator is then replayed layer-by-layer (one pass
    per bit layer, vectorized over every filter and every output sample):
    add the layer sum, stream the accumulator LSB into the output shift
    register, arithmetic-shift right — bit-for-bit what `_apply_once` does
    per code, including the final ``(acc << n_layers) | low_bits`` splice;
  * cycle counts are data-independent (one cycle per RLE code, §4), so the
    per-output cycle matrix is the bank's code-count vector broadcast over
    outputs — with the ``fused_last_add`` −1-per-non-empty-layer rebate
    and ``start_overhead`` applied exactly as in the scalar machine.

Weight-memory behaviour is also reproduced bank-wide: `program_bank`
returns a boolean *fit* mask instead of raising per filter, flagging the
~18% of 127-tap Hamming filters whose RLE program overflows the 256-entry
memory (and any filter whose zero-run overflows the ZRUN field).  The
scalar machine stays the trusted reference; `tests/torch_differential.py`
proves outputs, cycles, and overflow decisions identical on every tested
bank.

Cycle → paper mapping (Tab. 4): mean cycles per output over the full
9,900-filter 127-tap Hamming bank ≈ 231.6 (231.968 here, over all
filters); the ``machine`` phase of ``chip_smoke.py`` reproduces that
figure with this simulator.

The port's numpy copy of `repro.core.vmachine`: the same outputs, cycles
and fit masks, bit for bit.  One difference in how, none in what: `run`
takes the bank `BANK_CHUNK` filters a pass, so the host memory of a run
stays bounded at the sweep's 9,900 filters.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .csd import csd_digits
from .machine import MachineSpec
from .rle import (RleBatch, code_count_batch, encode_digits_batch,
                  max_zrun_batch)

__all__ = ["BANK_CHUNK", "VMachineResult", "FirBlmacVMachine",
           "simulate_bank"]

# filters a `FirBlmacVMachine.run` pass takes: its float64 layer-sum
# product is (chunk · n_layers, M) @ (M, n_out)
BANK_CHUNK = 2048


@dataclass
class VMachineResult:
    """Bank-level analogue of `MachineResult`.

    ``outputs[b]`` / ``cycles[b]`` are defined for every filter, including
    the ones that do NOT fit the weight memory (the arithmetic is the same
    dot product either way); ``fits`` says which rows a real machine could
    actually be programmed with.
    """

    outputs: np.ndarray  # int64 (B, n_out) exact filter outputs
    cycles: np.ndarray  # int64 (B, n_out) clock cycles per output
    fits: np.ndarray = field(repr=False)  # bool (B,)

    @property
    def mean_cycles(self) -> float:
        """Mean cycles per output over the whole bank (all filters)."""
        return float(self.cycles.mean())

    @property
    def mean_cycles_fitting(self) -> float:
        """Mean cycles over the filters that fit the weight memory."""
        if not self.fits.any():
            return float("nan")
        return float(self.cycles[self.fits].mean())


class FirBlmacVMachine:
    """Program a bank once, then stream signals through every filter at
    once.  Mirrors `FirBlmacMachine`'s two-phase API (program → run)."""

    def __init__(self, spec: MachineSpec | None = None):
        self.spec = spec if spec is not None else MachineSpec()
        self._digits: np.ndarray | None = None  # (B, M, L) int8
        self._fits: np.ndarray | None = None  # (B,) bool
        self._n_codes: np.ndarray | None = None  # (B,) int64
        self._cycles: np.ndarray | None = None  # (B,) int64

    # -- programming --------------------------------------------------------

    def program_bank(self, qbank: np.ndarray) -> np.ndarray:
        """Load a quantized type-I filter bank; returns the (B,) fit mask.

        Validation errors that a designer must fix (wrong tap count,
        asymmetry, out-of-range coefficients) raise, exactly like the
        scalar `program`; the *data-dependent* rejections (RLE program
        longer than the weight memory, zero-run overflowing the ZRUN
        field) come back as ``False`` entries of the mask so a sweep can
        tally them — the paper's ~18% figure.
        """
        spec = self.spec
        qbank = np.atleast_2d(np.asarray(qbank, np.int64))
        if qbank.ndim != 2 or qbank.shape[1] != spec.taps:
            raise ValueError(
                f"expected (B, {spec.taps}) coefficients, got {qbank.shape}"
            )
        if not np.array_equal(qbank, qbank[:, ::-1]):
            raise ValueError("type-I FIR coefficients must be symmetric")
        lim = 1 << (spec.coeff_bits - 1)
        if qbank.max() >= lim or qbank.min() < -lim:
            raise ValueError(f"coefficients exceed {spec.coeff_bits} bits")
        digits = csd_digits(qbank[:, : spec.n_half], n_digits=spec.n_layers)
        n_codes = code_count_batch(digits)
        zrun_ok = max_zrun_batch(digits) <= (1 << spec.zrun_bits) - 1
        fits = (n_codes <= spec.weight_mem_codes) & zrun_ok
        self._digits = digits
        self._fits = fits
        self._n_codes = n_codes
        self._cycles = n_codes + spec.start_overhead
        if spec.fused_last_add:
            # §4: the last add of a non-empty layer happens during the shift
            nonempty = np.count_nonzero(
                digits.any(axis=1), axis=-1
            ).astype(np.int64)
            self._cycles = self._cycles - nonempty
        return fits

    @property
    def code_counts(self) -> np.ndarray:
        """(B,) RLE codes per programmed filter (pulses + one EOR per
        layer) — the weight-memory footprint, independent of spec
        variants like ``fused_last_add``."""
        if self._n_codes is None:
            raise RuntimeError("machine not programmed")
        return self._n_codes

    def programs(self) -> RleBatch:
        """The programmed bank's RLE weight programs (vectorized encode).

        Raises on ZRUN overflow like the scalar encoder — call only when
        every filter passed the fit mask, or slice the bank first.
        """
        if self._digits is None:
            raise RuntimeError("machine not programmed")
        return encode_digits_batch(self._digits, zrun_bits=self.spec.zrun_bits)

    # -- execution ----------------------------------------------------------

    def run(self, samples: np.ndarray) -> VMachineResult:
        """Stream ``samples`` (T,) through every programmed filter.

        Returns outputs and per-output cycle counts of shape
        ``(B, T - taps + 1)``, bit-exact against running the scalar
        machine once per filter.
        """
        spec = self.spec
        if self._digits is None:
            raise RuntimeError("machine not programmed")
        x = np.asarray(samples, np.int64)
        if x.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {x.shape}")
        lim = 1 << (spec.sample_bits - 1)
        if x.size and (x.max() >= lim or x.min() < -lim):
            raise ValueError(f"samples exceed {spec.sample_bits} bits")
        n_out = x.size - spec.taps + 1
        if n_out <= 0:
            raise ValueError("need at least `taps` samples")
        u = _folded_windows(x, spec.taps)  # (M, n_out)
        # BANK_CHUNK filters a pass: the float64 product and the layer sums
        # of one pass stay a bounded size however wide the bank
        outputs = np.empty((self._digits.shape[0], n_out), np.int64)
        for lo in range(0, self._digits.shape[0], BANK_CHUNK):
            layer_sums = _layer_sums(self._digits[lo:lo + BANK_CHUNK], u,
                                     spec.sample_bits)
            outputs[lo:lo + BANK_CHUNK] = _right_shift_accumulate(layer_sums)
        # cycles are data-independent (§4: one clock per RLE code), so the
        # per-output matrix is a zero-copy read-only broadcast of the
        # per-filter vector
        cycles = np.broadcast_to(self._cycles[:, None], outputs.shape)
        return VMachineResult(outputs, cycles, self._fits.copy())


def _folded_windows(x: np.ndarray, taps: int) -> np.ndarray:
    """(T,) → (M, n_out) symmetric pre-adder outputs: row j is
    x[t+j] + x[t+taps−1−j] for j < centre, the bare centre tap at j=centre
    — the machine's two sample-memory ports plus the Eq. 3 fold."""
    half = taps // 2
    win = np.lib.stride_tricks.sliding_window_view(x, taps)  # (n_out, taps)
    folded = win[:, :half] + win[:, taps - 1 : half : -1]
    return np.concatenate([folded, win[:, half : half + 1]], axis=1).T


def _layer_sums(
    digits: np.ndarray, u: np.ndarray, sample_bits: int
) -> np.ndarray:
    """(B, M, L) digits × (M, n_out) windows → (B, L, n_out) int64 layer
    partial sums, via one float64 BLAS matmul (exact, see module doc)."""
    n_bank, m, n_layers = digits.shape
    # every addend is an integer; the sum magnitude is < M · 2^(bits+1),
    # far inside float64's 2^53 exact-integer range for any real spec —
    # a real raise (not assert) so `python -O` can't silently lose bits
    if m * 2.0 ** (sample_bits + 1) >= 2.0**52:
        raise ValueError(
            f"float64 layer-sum path not exact for {m} coefficients at "
            f"{sample_bits} sample bits"
        )
    d2 = digits.transpose(0, 2, 1).reshape(n_bank * n_layers, m)
    p = d2.astype(np.float64) @ u.astype(np.float64)
    return np.rint(p).astype(np.int64).reshape(n_bank, n_layers, -1)


def _right_shift_accumulate(layer_sums: np.ndarray) -> np.ndarray:
    """Replay the right-shift BLMAC accumulator over bit layers, LSB first,
    vectorized over (B, n_out): each EOR streams the accumulator LSB into
    the output shift register and arithmetic-shifts the accumulator."""
    n_bank, n_layers, n_out = layer_sums.shape
    acc = np.zeros((n_bank, n_out), np.int64)
    low_bits = np.zeros((n_bank, n_out), np.int64)
    for layer in range(n_layers):
        acc += layer_sums[:, layer, :]
        low_bits |= (acc & 1) << layer
        acc >>= 1  # numpy int64 >> is arithmetic: exact two's complement
    return (acc << n_layers) | low_bits


def simulate_bank(
    qbank: np.ndarray,
    samples: np.ndarray,
    spec: MachineSpec | None = None,
) -> VMachineResult:
    """One-shot convenience: program ``qbank`` and run ``samples``."""
    vm = FirBlmacVMachine(spec)
    vm.program_bank(qbank)
    return vm.run(samples)
