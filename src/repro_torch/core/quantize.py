"""Coefficient quantization, exactly as the paper does it (§3.2) — plus the
CSD-plane quantizer used by the LM serving path.

The port's numpy copy of `repro.core.quantize`, function for function.

The paper: scale the float coefficients by the *largest power of two* such
that the largest coefficient still fits a signed 16-bit word, then apply
convergent rounding (round-half-to-even; numpy's ``rint``).  This fills the
full int16 range so the 16-bit pulse statistics are honest.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csd import csd_digits, csd_truncate, pack_trits

__all__ = [
    "po2_quantize",
    "po2_quantize_batch",
    "dequantize",
    "PlaneQuantized",
    "csd_plane_quantize",
    "plane_dequantize",
]


def po2_quantize(h: np.ndarray, bits: int = 16) -> tuple[np.ndarray, int]:
    """Quantize float coefficients to ``bits``-bit signed integers.

    Returns ``(q, k)`` with ``q = rint(h * 2**k)`` and ``k`` the largest
    exponent for which every value fits ``[-(2**(bits-1)), 2**(bits-1)-1]``.
    """
    h = np.asarray(h, np.float64)
    maxabs = float(np.max(np.abs(h))) if h.size else 0.0
    if maxabs == 0.0:
        return np.zeros(h.shape, np.int32), 0
    top = float(2 ** (bits - 1) - 1)
    k = int(np.floor(np.log2(top / maxabs)))
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    # convergent rounding can tip the largest value over; back off if so
    for _ in range(4):
        q = np.rint(h * float(2.0**k))
        if q.max() <= hi and q.min() >= lo:
            break
        k -= 1
    else:  # pragma: no cover - mathematically unreachable
        raise RuntimeError("po2_quantize failed to converge")
    return q.astype(np.int64), k


def dequantize(q: np.ndarray, k: int) -> np.ndarray:
    return np.asarray(q, np.float64) * float(2.0**-k)


def po2_quantize_batch(
    bank: np.ndarray, bits: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise :func:`po2_quantize` for a (n_filters, n_taps) bank.

    Returns ``(q, k)`` with per-row exponents; vectorized (the 1.98M-filter
    sweep calls this 202 times on 9,900-row banks).
    """
    bank = np.asarray(bank, np.float64)
    maxabs = np.abs(bank).max(axis=-1)
    maxabs = np.where(maxabs == 0.0, 1.0, maxabs)
    top = float(2 ** (bits - 1) - 1)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    k = np.floor(np.log2(top / maxabs)).astype(np.int64)
    for _ in range(4):
        q = np.rint(bank * np.exp2(k.astype(np.float64))[..., None])
        over = (q.max(axis=-1) > hi) | (q.min(axis=-1) < lo)
        if not over.any():
            break
        k = np.where(over, k - 1, k)
    else:  # pragma: no cover
        raise RuntimeError("po2_quantize_batch failed to converge")
    return q.astype(np.int64), k


# ---------------------------------------------------------------------------
# CSD-P plane quantization: keep only the P most-significant pulses of each
# weight.  This is the paper's "naturally variable precision" observation
# (§2) used as a *quantizer*: storage is P × 2-bit planes instead of 16 bits,
# which is what a memory-bound decode roofline wants.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlaneQuantized:
    """A weight matrix stored as packed CSD trit planes.

    ``planes_packed``: uint32, shape ``W.shape[:-1] + (n_digits, ceil(last/16))``
    — plane ``i`` holds the digit of weight ``2**i`` for each entry, packed
    16 trits/word along the (contracted) last axis.
    """

    planes_packed: np.ndarray
    n_digits: int
    n: int  # unpacked size of the packed axis
    exponent: int  # dequant scale is 2**-exponent
    keep_planes: int

    @property
    def bits_per_weight(self) -> float:
        """Storage cost of the packed representation."""
        return 2.0 * self.n_digits


def csd_plane_quantize(
    w: np.ndarray, bits: int = 16, keep_pulses: int | None = None
) -> PlaneQuantized:
    """Quantize float weights to int, CSD-encode, optionally truncate to the
    ``keep_pulses`` most significant pulses, and pack 2-bit trit planes.

    The packed axis is the *last* axis of ``w`` (the contraction axis of
    ``x @ W`` should be moved there by the caller).
    """
    q, k = po2_quantize(w, bits)
    if keep_pulses is not None:
        q = csd_truncate(q, keep_pulses, n_digits=bits + 1)
    digits = csd_digits(q, n_digits=bits + 1)  # (..., n, n_digits)
    # drop empty leading planes (cheap static compression)
    nz = np.nonzero(np.any(digits != 0, axis=tuple(range(digits.ndim - 1))))[0]
    n_digits = int(nz.max()) + 1 if nz.size else 1
    digits = digits[..., :n_digits]
    planes = np.moveaxis(digits, -1, -2)  # (..., n_digits, n)
    return PlaneQuantized(
        planes_packed=pack_trits(planes),
        n_digits=n_digits,
        n=w.shape[-1],
        exponent=k,
        keep_planes=keep_pulses if keep_pulses is not None else bits + 1,
    )


def plane_dequantize(pq: PlaneQuantized) -> np.ndarray:
    """Reconstruct float weights from packed planes (the numpy oracle)."""
    from .csd import unpack_trits

    planes = unpack_trits(pq.planes_packed, pq.n).astype(np.int64)
    scale = (np.int64(1) << np.arange(pq.n_digits, dtype=np.int64))
    q = np.tensordot(
        np.moveaxis(planes, -2, -1), scale, axes=([-1], [0])
    )  # (..., n)
    return q.astype(np.float64) * float(2.0**-pq.exponent)
