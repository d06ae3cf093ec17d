"""Cycle-accurate simulator of the paper's §4 BLMAC dot-product machine
(Fig. 5): right-shift BLMAC + RLE weight memory + symmetric pre-adder,
specialised for odd-tap type-I FIR filters.

Nothing is synthesized, so the FPGA resource numbers of Tab. 4 are the
paper's own; everything *behavioural* is simulated
exactly: the 8-bit RLE weight memory (256 codes), the per-code cycle count,
the right-shift accumulator with its streamed-out result bits, and the
bit-exactness of the result against the classical dot product — this is the
paper's testbench, reproduced.

The port's numpy copy of `repro.core.machine`: the same spec defaults,
codes, outputs and cycle counts (`tests/test_torch_machine.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .csd import csd_digits
from .rle import EOR, RleStream, encode_digits

__all__ = ["MachineSpec", "MachineResult", "FirBlmacMachine"]


@dataclass(frozen=True)
class MachineSpec:
    """Hardware parameters of the dot-product machine."""

    taps: int = 127
    sample_bits: int = 8
    coeff_bits: int = 16
    weight_mem_codes: int = 256
    zrun_bits: int = 6
    # §4: "perform the last addition at the end of a bit layer at the same
    # time as the shift ... would reduce the number of clock cycles by 16".
    fused_last_add: bool = False
    # fixed cycles per output sample (start/clear); the paper's ~231.6 avg
    # is consistent with 0–2 cycles of overhead on top of the code count.
    start_overhead: int = 0

    @property
    def n_half(self) -> int:
        return self.taps // 2 + 1

    @property
    def n_layers(self) -> int:
        return self.coeff_bits


@dataclass
class MachineResult:
    outputs: np.ndarray  # int64 (n_out,) exact filter outputs
    cycles: np.ndarray  # int64 (n_out,) clock cycles per output
    stream: RleStream = field(repr=False)

    @property
    def mean_cycles(self) -> float:
        return float(self.cycles.mean())


class FirBlmacMachine:
    """Behavioural + cycle model.  Program once per filter, then stream."""

    def __init__(self, spec: MachineSpec | None = None):
        # None default (not `spec=MachineSpec()`): a mutable-looking default
        # would be evaluated once at import and shared by every machine
        self.spec = spec if spec is not None else MachineSpec()
        self._stream: RleStream | None = None
        self._coeffs: np.ndarray | None = None

    # -- programming --------------------------------------------------------

    def program(self, coeffs: np.ndarray) -> RleStream:
        """Load a quantized type-I filter into the weight memory.

        Raises ``ValueError`` when the RLE program does not fit the weight
        memory — the condition that excluded ~18% of the paper's 9,900
        127-tap Hamming filters.
        """
        spec = self.spec
        coeffs = np.asarray(coeffs, np.int64)
        if coeffs.shape != (spec.taps,):
            raise ValueError(f"expected {spec.taps} taps, got {coeffs.shape}")
        if not np.array_equal(coeffs, coeffs[::-1]):
            raise ValueError("type-I FIR coefficients must be symmetric")
        lim = 1 << (spec.coeff_bits - 1)
        if coeffs.max() >= lim or coeffs.min() < -lim:
            raise ValueError(f"coefficients exceed {spec.coeff_bits} bits")
        half = coeffs[: spec.n_half]
        digits = csd_digits(half, n_digits=spec.n_layers)
        stream = encode_digits(digits, zrun_bits=spec.zrun_bits)
        if not stream.fits(spec.weight_mem_codes):
            raise ValueError(
                f"RLE program needs {stream.n_codes} codes > "
                f"{spec.weight_mem_codes}-entry weight memory"
            )
        self._stream, self._coeffs = stream, coeffs
        return stream

    # -- execution ----------------------------------------------------------

    def run(self, samples: np.ndarray) -> MachineResult:
        """Stream ``samples`` through the programmed filter.

        Produces ``len(samples) - taps + 1`` outputs, exactly like the
        paper's testbench (127 warm-up samples + one output per new
        sample), each with its cycle count.
        """
        spec = self.spec
        if self._stream is None or self._coeffs is None:
            raise RuntimeError("machine not programmed")
        x = np.asarray(samples, np.int64)
        lim = 1 << (spec.sample_bits - 1)
        if x.max() >= lim or x.min() < -lim:
            raise ValueError(f"samples exceed {spec.sample_bits} bits")
        n_out = x.size - spec.taps + 1
        if n_out <= 0:
            raise ValueError("need at least `taps` samples")
        outputs = np.empty(n_out, np.int64)
        cycles = np.empty(n_out, np.int64)
        codes = self._stream.codes
        for t in range(n_out):
            window = x[t : t + spec.taps]
            outputs[t], cycles[t] = self._apply_once(codes, window)
        return MachineResult(outputs, cycles, self._stream)

    def _apply_once(self, codes: np.ndarray, window: np.ndarray):
        """One dot product, right-shift BLMAC semantics, exact integers.

        The sample memory is addressed j (ascending) and taps-1-j
        (descending); the pre-adder folds the symmetric pair.  The centre
        tap reads the same cell on both ports, so the machine suppresses
        the second port's contribution there.  Each RLE code (pulse or
        EOR) costs one clock cycle; each EOR arithmetic-right-shifts the
        accumulator, streaming one fully-determined result bit (§2.1) into
        the output shift register.
        """
        spec = self.spec
        centre = spec.n_half - 1
        acc = 0
        low_bits = 0
        shift_count = 0
        n_cycles = spec.start_overhead
        j = 0
        layer_pulses = 0
        for c in codes:
            c = int(c)
            if c & EOR:
                low_bits |= (acc & 1) << shift_count
                shift_count += 1
                n_cycles += 1
                if spec.fused_last_add and layer_pulses:
                    n_cycles -= 1  # last add fused with the shift
                acc >>= 1  # arithmetic shift; exact two's complement
                j = 0
                layer_pulses = 0
                continue
            j += c & 0x3F  # ZRUN expansion
            pre = int(window[j])
            if j != centre:
                pre += int(window[spec.taps - 1 - j])
            acc = acc - pre if (c & 0x40) else acc + pre
            n_cycles += 1
            layer_pulses += 1
            j += 1
        # acc holds the high bits, the shift register the low n_layers bits
        return (acc << spec.n_layers) | low_bits, n_cycles
