"""Canonical signed-digit (ternary) weight codec — the heart of BLMAC.

The port's own copy of `repro.core.csd` (no JAX): the packed trit layout
and the digit order must stay identical, because a program saved by
either package loads in the other.

The paper (§2) represents each integer weight as ``w = Σ_i d_i 2^i`` with
``d_i ∈ {-1, 0, +1}`` ("trits"); every non-zero trit is a *pulse* and costs
exactly one add/sub cycle in a BLMAC.  We use the non-adjacent form (NAF),
the canonical signed-digit recoding, which provably minimizes the number of
non-zero digits and reproduces the paper's Tab. 3 statistics exactly
(avg ~2.77 pulses for 7-bit, max ⌈(n+1)/2⌉ pulses for n-bit).

Everything here is vectorized numpy, except `csd_digits_tensor` and
`csd_truncate_tensor`, the same codec on torch tensors for the pulse-code
quantizer; LSB-first digit order throughout
(digit ``[..., i]`` weighs ``2**i``) — the right-shift BLMAC processes
layers in exactly this order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "csd_digits",
    "csd_decode",
    "num_pulses",
    "ntrits_table",
    "max_pulses",
    "csd_truncate",
    "csd_digits_tensor",
    "csd_truncate_tensor",
    "pack_trits",
    "unpack_trits",
    "packed_pulse_counts",
    "require_type1",
    "assert_int32_bound",
    "layer_occupancy",
    "layer_pulse_counts",
    "occupancy_signatures",
]


def require_type1(w, what: str = "filter") -> int:
    """Validate odd symmetric (type-I) coefficients — the precondition of
    the BLMAC symmetric fold (Eq. 3).  Accepts one filter (taps,) or a
    bank (B, taps); returns the tap count."""
    w2 = np.atleast_2d(np.asarray(w))
    taps = int(w2.shape[-1])
    if taps % 2 == 0 or not np.array_equal(w2, w2[..., ::-1]):
        raise ValueError(f"{what} needs odd symmetric (type-I) coefficients")
    return taps


def assert_int32_bound(w, sample_bits: int = 8, what: str = "filter bank") -> int:
    """Assert the BLMAC accumulator fits int32 — checked ONCE at pack time.

    This is the §2.1 claim ("16-bit coeffs × 8-bit samples × ≤255 taps fits
    32 bits") made load-bearing: every BLMAC accumulator in this repo —
    the CUDA kernels, `blmac_fir_dynamic`, `FilterBankEngine` — carries
    int32, so this single pack-time check covers every call site.

    The checked quantity is the final-sum bound Σ|w_j|·max|x| plus a
    partial-Horner slack of 2·M·max|x|: after processing layers ≥ lo the
    accumulator holds (w_prefix/2^lo)·u, and a signed-CSD prefix can
    exceed |w| by the discarded NAF tail (< 2^lo per coefficient) — e.g.
    NAF(7) = +8−1, whose prefix is 8.  That slack is ≤ 2·max|x| per
    folded row, taps·max|x| total, far below the headroom at the paper's
    operating point (255·2^15·2^7 ≈ 2^30).  Returns the final-sum bound.
    """
    w2 = np.atleast_2d(np.asarray(w, np.int64))
    taps = w2.shape[-1]
    xmax = np.int64(1) << (sample_bits - 1)
    bound = int(np.abs(w2).sum(axis=-1).max(initial=0) * xmax)
    slack = (taps // 2 + 1) * int(xmax) * 2  # NAF-prefix excess, see above
    if bound + slack >= 1 << 31:
        raise OverflowError(
            f"{what}: worst-case accumulator Σ|w|·2^{sample_bits - 1} "
            f"(+{slack} partial-sum slack) = {bound + slack} overflows "
            f"int32 — reduce coeff bits, taps, or sample_bits"
        )
    return bound


def layer_occupancy(digits: np.ndarray) -> np.ndarray:
    """(…, M, L) CSD digits → bool (…, L): which bit layers hold ≥1 pulse.

    The layer-skip schedule of the bank kernel is built from this: a layer
    empty across a whole bank tile costs zero kernel iterations.
    """
    return np.any(np.asarray(digits) != 0, axis=-2)


def layer_pulse_counts(digits: np.ndarray) -> np.ndarray:
    """(…, M, L) CSD digits → int64 (…, L) pulses per bit layer (the
    autotuner's per-layer work predictor)."""
    return np.count_nonzero(np.asarray(digits), axis=-2).astype(np.int64)


def occupancy_signatures(occ: np.ndarray) -> np.ndarray:
    """Bool (…, L) occupancy → uint64 (…,) bitmask (bit i = layer i
    populated).  Filters sharing a signature schedule identically, so
    sorting on it groups bank tiles into occupancy-homogeneous runs."""
    occ = np.asarray(occ, bool)
    if occ.shape[-1] > 64:
        raise ValueError("occupancy signatures support at most 64 layers")
    weights = np.uint64(1) << np.arange(occ.shape[-1], dtype=np.uint64)
    return (occ * weights).sum(axis=-1, dtype=np.uint64)


def _as_int64(w) -> np.ndarray:
    a = np.asarray(w)
    if a.dtype.kind not in "iu":
        raise TypeError(f"CSD encoding requires integer input, got {a.dtype}")
    return a.astype(np.int64)


def csd_digits(w, n_digits: int | None = None) -> np.ndarray:
    """NAF/CSD digits of integer array ``w``.

    Returns int8 array of shape ``w.shape + (n_digits,)``, LSB first, each
    digit in {-1, 0, +1}, satisfying ``Σ_i d[..., i] * 2**i == w``.

    ``n_digits`` defaults to the minimum that can represent ``max |w|``
    (NAF of an n-bit magnitude may need n+1 digit positions).
    """
    w = _as_int64(w)
    if n_digits is None:
        maxabs = int(np.max(np.abs(w))) if w.size else 0
        n_digits = max(1, maxabs.bit_length() + 1)
    digits = np.zeros(w.shape + (n_digits,), dtype=np.int8)
    rem = w.copy()
    for i in range(n_digits):
        odd = (rem & 1).astype(bool)
        # For odd rem, pick d = ±1 so that rem - d ≡ 0 (mod 4)  →  NAF.
        mod4 = rem & 3
        d = np.where(odd, np.where(mod4 == 1, 1, -1), 0).astype(np.int64)
        digits[..., i] = d
        rem = (rem - d) >> 1
    if np.any(rem != 0):
        bad = int(np.max(np.abs(w)))
        raise ValueError(
            f"n_digits={n_digits} too small for values up to |{bad}|"
        )
    return digits


def csd_decode(digits: np.ndarray) -> np.ndarray:
    """Inverse of :func:`csd_digits` (works for any {-1,0,1} digit tensor)."""
    d = np.asarray(digits, dtype=np.int64)
    weights = np.int64(1) << np.arange(d.shape[-1], dtype=np.int64)
    return (d * weights).sum(axis=-1)


def num_pulses(w) -> np.ndarray:
    """Number of BLMAC additions (non-zero NAF trits) for each weight.

    Sign-independent (paper §2.3: a negative number costs the same).
    """
    d = csd_digits(np.abs(_as_int64(w)))
    return np.count_nonzero(d, axis=-1)


_NTRITS_CACHE: dict[int, np.ndarray] = {}


def ntrits_table(bits: int = 15) -> np.ndarray:
    """The paper's precomputed ``ntrits[]`` array (§3.3): pulse count for
    every magnitude in ``[0, 2**bits)``.  Cached; ~32k uint8 for bits=15."""
    if bits not in _NTRITS_CACHE:
        values = np.arange(1 << bits, dtype=np.int64)
        _NTRITS_CACHE[bits] = num_pulses(values).astype(np.uint8)
    return _NTRITS_CACHE[bits]


def max_pulses(bits: int) -> int:
    """Worst-case pulses for a ``bits``-bit magnitude: ⌈(bits+1)/2⌉ (Tab. 3)."""
    return (bits + 2) // 2


def csd_truncate(w, planes: int, n_digits: int | None = None) -> np.ndarray:
    """Keep only the ``planes`` most-significant *pulses* of each weight.

    This is the "variable precision" property of §2 turned into a
    quantizer: a weight rounded to ≤ ``planes`` signed powers of two.
    Greedy MSB-first on the NAF digits; exact when the weight already has
    ≤ ``planes`` pulses.  Returns the truncated integer values.
    """
    d = csd_digits(w, n_digits).astype(np.int64)
    nz = d != 0
    # rank pulses MSB→LSB: cumulative count of non-zeros from the top
    rank = np.cumsum(nz[..., ::-1], axis=-1)[..., ::-1]
    keep = nz & (rank <= planes)
    return csd_decode(np.where(keep, d, 0))


# ---------------------------------------------------------------------------
# The same codec on tensors, on the device of the input (the pulse-code
# quantizer runs on the card).  Same digits, same order, same truncation;
# int32 intermediates and int8 digits keep a full-width weight matrix small.
# ---------------------------------------------------------------------------

def _work_dtype(w: torch.Tensor) -> torch.dtype:
    """int32 for inputs of at most 16 bits, whose NAF steps cannot
    overflow it; int64 for wider ones."""
    if w.dtype.is_floating_point or w.dtype.is_complex or w.dtype == torch.bool:
        raise TypeError(f"CSD encoding requires integer input, got {w.dtype}")
    return torch.int64 if w.element_size() >= 4 else torch.int32


def csd_digits_tensor(w: torch.Tensor, n_digits: int | None = None) -> torch.Tensor:
    """:func:`csd_digits` on an integer tensor: int8 NAF digits of shape
    ``w.shape + (n_digits,)``, LSB first, on ``w``'s device.  Arithmetic
    is int32 for 8- and 16-bit inputs, int64 for wider ones."""
    rem = w.to(_work_dtype(w))
    if n_digits is None:
        maxabs = int(rem.abs().max()) if rem.numel() else 0
        n_digits = max(1, maxabs.bit_length() + 1)
    digits = torch.empty(rem.shape + (n_digits,), dtype=torch.int8,
                         device=rem.device)
    for i in range(n_digits):
        # for odd rem, d = ±1 so that rem - d ≡ 0 (mod 4): the NAF
        d = torch.where((rem & 1) == 1, 1 - (rem & 2), 0)
        digits[..., i] = d
        rem = (rem - d) >> 1
    if bool((rem != 0).any()):
        bad = int(w.to(torch.int64).abs().max())
        raise ValueError(
            f"n_digits={n_digits} too small for values up to |{bad}|"
        )
    return digits


def csd_truncate_tensor(w: torch.Tensor, planes: int,
                        n_digits: int | None = None) -> torch.Tensor:
    """:func:`csd_truncate` on an integer tensor: the ``planes``
    most-significant NAF pulses of each value, MSB first, as integers of
    the working type of :func:`csd_digits_tensor` on ``w``'s device."""
    d = csd_digits_tensor(w, n_digits)
    dtype = _work_dtype(w)
    out = torch.zeros(d.shape[:-1], dtype=dtype, device=d.device)
    seen = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
    for i in range(d.shape[-1] - 1, -1, -1):
        di = d[..., i].to(dtype)
        seen += di != 0
        out += torch.where(seen <= planes, di, 0) << i
    return out


# ---------------------------------------------------------------------------
# 2-bit trit packing — the bank kernel's operand format.
# Code: 0b00 = 0, 0b01 = +1, 0b11 = -1 (0b10 unused).  16 trits / int32.
# ---------------------------------------------------------------------------

def pack_trits(digits: np.ndarray) -> np.ndarray:
    """Pack a {-1,0,1} int8 tensor into uint32 along the last axis
    (16 trits per word, little-endian trit order).  Pads with zeros."""
    d = np.asarray(digits)
    n = d.shape[-1]
    n_words = (n + 15) // 16
    pad = n_words * 16 - n
    if pad:
        d = np.concatenate([d, np.zeros(d.shape[:-1] + (pad,), d.dtype)], -1)
    codes = np.where(d == 0, 0, np.where(d > 0, 1, 3)).astype(np.uint32)
    codes = codes.reshape(d.shape[:-1] + (n_words, 16))
    shifts = (2 * np.arange(16, dtype=np.uint32))[None]
    return (codes << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_trits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_trits`; returns int8 of last-dim size ``n``."""
    w = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None]
    codes = (w[..., None] >> shifts) & np.uint32(3)
    trits = np.where(codes == 1, 1, np.where(codes == 3, -1, 0)).astype(np.int8)
    out = trits.reshape(w.shape[:-1] + (w.shape[-1] * 16,))
    return out[..., :n]


def packed_pulse_counts(packed: np.ndarray) -> np.ndarray:
    """(B, n_layers, n_words) packed trit words → (B,) int64 non-zero trit
    (= BLMAC pulse, §3.3) counts per filter, read straight off the 2-bit
    codes without unpacking (`repro_torch.compiler.BlmacProgram`)."""
    w = np.asarray(packed, dtype=np.uint32)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    codes = (w[..., None] >> shifts) & np.uint32(3)
    return (codes != 0).sum(axis=(1, 2, 3)).astype(np.int64)
