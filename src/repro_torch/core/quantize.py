"""Coefficient quantization, exactly as the paper does it (§3.2).

The port's copy of `repro.core.quantize.po2_quantize_batch`:
scale the float coefficients by the *largest power of two* such that the
largest coefficient still fits a signed ``bits``-bit word, then apply
convergent rounding (round-half-to-even; numpy's ``rint``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["po2_quantize_batch"]


def po2_quantize_batch(
    bank: np.ndarray, bits: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise po2 quantization of a (n_filters, n_taps) bank.

    Returns ``(q, k)`` int64 with per-row exponents, vectorized over the
    bank (the 9,900-filter sweep bank is one call).
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
