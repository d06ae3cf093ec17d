"""Run-length coding of bit layers — the BLMAC weight memory format (§2.4).

The port's numpy copy of `repro.core.rle`: the same code packing, byte
for byte, so a weight program encoded by either package decodes in the
other.

Each bit layer of the CSD digit matrix is a stream of (S, ZRUN) pairs —
``S`` the ±1 pulse sign, ``ZRUN`` the number of zero coefficients skipped
before it — terminated by an End-Of-Run (EOR) code; an empty layer is a
bare EOR.  The paper's 127-tap machine stores these in a 256×8 distributed
memory; our concrete 8-bit code packing (which fits that memory exactly):

    bit 7      EOR flag (1 ⇒ end of layer; other bits ignored)
    bit 6      S: 0 ⇒ +1, 1 ⇒ −1
    bits 5..0  ZRUN (0..63) — enough for the 64 unique coefficients of a
               symmetric 127-tap filter

Layers are emitted LSB-first, matching the right-shift BLMAC.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EOR = 0x80
_SIGN = 0x40

__all__ = [
    "EOR",
    "RleStream",
    "RleBatch",
    "encode_digits",
    "encode_digits_batch",
    "decode_codes",
    "code_count",
    "code_count_batch",
    "max_zrun_batch",
]


@dataclass(frozen=True)
class RleStream:
    """A packed BLMAC weight program."""

    codes: np.ndarray  # uint8 (n_codes,)
    n_coeffs: int
    n_layers: int

    @property
    def n_codes(self) -> int:
        return int(self.codes.size)

    @property
    def n_pulses(self) -> int:
        return int(np.count_nonzero((self.codes & EOR) == 0))

    def fits(self, mem_codes: int = 256) -> bool:
        """Does the program fit the machine's weight memory?  The paper's
        256-entry memory rejects ~18% of the 127-tap Hamming filters."""
        return self.n_codes <= mem_codes


def encode_digits(digits: np.ndarray, zrun_bits: int = 6) -> RleStream:
    """Encode a CSD digit matrix (n_coeffs, n_layers), LSB-first layers.

    Raises ``ValueError`` if any zero-run exceeds the ZRUN field — the
    hardware analogue of a mis-sized run-length field.
    """
    d = np.asarray(digits)
    if d.ndim != 2:
        raise ValueError(f"digits must be (n_coeffs, n_layers), got {d.shape}")
    n_coeffs, n_layers = d.shape
    max_run = (1 << zrun_bits) - 1
    codes: list[int] = []
    for layer in range(n_layers):  # LSB first
        run = 0
        col = d[:, layer]
        for j in range(n_coeffs):
            t = int(col[j])
            if t == 0:
                run += 1
                continue
            if run > max_run:
                raise ValueError(
                    f"zero-run {run} exceeds {zrun_bits}-bit ZRUN field"
                )
            codes.append((_SIGN if t < 0 else 0) | run)
            run = 0
        codes.append(EOR)
    return RleStream(np.asarray(codes, np.uint8), n_coeffs, n_layers)


def decode_codes(stream: RleStream) -> np.ndarray:
    """Inverse of :func:`encode_digits`: codes → (n_coeffs, n_layers) int8."""
    d = np.zeros((stream.n_coeffs, stream.n_layers), np.int8)
    layer = 0
    j = 0
    for c in stream.codes:
        c = int(c)
        if c & EOR:
            layer += 1
            j = 0
            continue
        j += c & 0x3F
        d[j, layer] = -1 if (c & _SIGN) else 1
        j += 1
    if layer != stream.n_layers:
        raise ValueError(f"expected {stream.n_layers} EORs, saw {layer}")
    return d


def code_count(digits: np.ndarray) -> int:
    """#codes = #pulses + #layers — the machine's weight-memory footprint
    and (bar fixed overhead) its cycle count per output sample."""
    d = np.asarray(digits)
    return int(np.count_nonzero(d)) + d.shape[-1]


# ---------------------------------------------------------------------------
# bank-level (vectorized) encoding — the weight programs of a whole filter
# bank in numpy array ops, no per-code Python loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RleBatch:
    """Weight programs for a whole bank, one padded row per filter.

    ``codes[b, :n_codes[b]]`` is exactly ``encode_digits(digits[b]).codes``;
    entries past ``n_codes[b]`` are zero padding and carry no meaning.
    """

    codes: np.ndarray  # uint8 (B, max_codes), rows zero-padded
    n_codes: np.ndarray  # int64 (B,)
    n_coeffs: int
    n_layers: int

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def stream(self, b: int) -> RleStream:
        """The b-th filter's program as a scalar :class:`RleStream`."""
        return RleStream(
            self.codes[b, : self.n_codes[b]].copy(),
            self.n_coeffs,
            self.n_layers,
        )

    @property
    def n_pulses(self) -> np.ndarray:
        return self.n_codes - self.n_layers

    def fits(self, mem_codes: int = 256) -> np.ndarray:
        """(B,) bool — which programs fit a ``mem_codes``-entry memory."""
        return self.n_codes <= mem_codes


def encode_digits_batch(digits: np.ndarray, zrun_bits: int = 6) -> RleBatch:
    """Vectorized :func:`encode_digits` over a bank.

    ``digits`` is (B, n_coeffs, n_layers) in {-1, 0, 1}.  The whole bank is
    encoded with a handful of numpy passes (nonzero + bincount + two
    scatters); per-row results are bit-identical to the scalar encoder.
    Raises ``ValueError`` if any zero-run in any filter overflows the ZRUN
    field, like the scalar path.
    """
    d = np.asarray(digits)
    if d.ndim != 3:
        raise ValueError(f"digits must be (B, n_coeffs, n_layers), got {d.shape}")
    n_bank, n_coeffs, n_layers = d.shape
    max_run = (1 << zrun_bits) - 1
    dT = d.transpose(0, 2, 1)  # (B, L, C): layer-major, LSB first
    b_idx, l_idx, j_idx = np.nonzero(dT)  # lexicographic (b, l, j) order
    signs = dT[b_idx, l_idx, j_idx]
    # zero-run preceding each pulse: distance to the previous pulse in the
    # same (filter, layer), or to the start of the layer
    same = np.zeros(b_idx.size, bool)
    same[1:] = (b_idx[1:] == b_idx[:-1]) & (l_idx[1:] == l_idx[:-1])
    prev_end = np.concatenate([[0], j_idx[:-1] + 1])
    runs = j_idx - np.where(same, prev_end, 0)
    if runs.size and runs.max() > max_run:
        bad = int(runs.max())
        raise ValueError(f"zero-run {bad} exceeds {zrun_bits}-bit ZRUN field")
    pulse_codes = (np.where(signs < 0, _SIGN, 0) | runs).astype(np.uint8)
    # stream position of each pulse: pulses before it in its row + one EOR
    # per earlier layer (l_idx)
    pulses_per_row = np.bincount(b_idx, minlength=n_bank)
    row_start = np.concatenate([[0], np.cumsum(pulses_per_row)])[:-1]
    pulse_pos = np.arange(b_idx.size) - row_start[b_idx] + l_idx
    # EOR of (b, l) sits after every pulse of layers <= l and l earlier EORs
    pulses_per_bl = np.bincount(
        b_idx * n_layers + l_idx, minlength=n_bank * n_layers
    ).reshape(n_bank, n_layers)
    eor_pos = np.cumsum(pulses_per_bl, axis=1) + np.arange(n_layers)
    n_codes = pulses_per_row + n_layers
    max_codes = int(n_codes.max()) if n_bank else 0  # B=0: empty batch
    codes = np.zeros((n_bank, max_codes), np.uint8)
    codes[np.repeat(np.arange(n_bank), n_layers), eor_pos.ravel()] = EOR
    codes[b_idx, pulse_pos] = pulse_codes
    return RleBatch(codes, n_codes.astype(np.int64), n_coeffs, n_layers)


def code_count_batch(digits: np.ndarray) -> np.ndarray:
    """Vectorized :func:`code_count`: (..., n_coeffs, n_layers) digit
    tensors → (...,) int64 code counts (pulses + one EOR per layer)."""
    d = np.asarray(digits)
    if d.ndim < 2:
        raise ValueError("digits need at least (n_coeffs, n_layers) axes")
    return (
        np.count_nonzero(d, axis=(-2, -1)).astype(np.int64) + d.shape[-1]
    )


def max_zrun_batch(digits: np.ndarray) -> np.ndarray:
    """(B, n_coeffs, n_layers) → (B,) longest zero-run *preceding a pulse*
    in any layer — the quantity the ZRUN field must hold.  Trailing zeros
    of a layer are never encoded and do not count (a filter fits iff
    ``max_zrun_batch(d) <= 2**zrun_bits - 1``, matching exactly where the
    encoders raise)."""
    d = np.asarray(digits)
    if d.ndim != 3:
        raise ValueError(f"digits must be (B, n_coeffs, n_layers), got {d.shape}")
    nz = d != 0
    j = np.arange(d.shape[1])[None, :, None]
    prev_end = np.maximum.accumulate(np.where(nz, j + 1, 0), axis=1)
    shifted = np.concatenate(
        [np.zeros_like(prev_end[:, :1]), prev_end[:, :-1]], axis=1
    )
    runs = np.where(nz, j - shifted, 0)
    if not runs.size:
        return np.zeros(d.shape[0], np.int64)
    return runs.max(axis=(1, 2)).astype(np.int64)
