"""Reference FIR application paths (numpy, exact integer arithmetic).

The port's copy of the oracles of `repro.filters.apply`.  All compute
y[t] = Σ_j w[j] · x[t+j] over a length-N window (the machine's
orientation; flip w for convolution):

  * ``fir_direct``           — classical MACs,
  * ``fir_bit_layers``       — Eq. 2 for one type-I filter (a B=1, C=1
                               call of the batched oracle),
  * ``fir_bit_layers_batch`` — Eq. 2 for a bank: the naive dense Horner
                               recursion over CSD bit layers, sharing no
                               schedule machinery with the kernels it
                               verifies.
"""
from __future__ import annotations

import numpy as np

from ..core.csd import csd_digits, require_type1

__all__ = ["sliding_windows", "fir_direct", "fir_bit_layers",
           "fir_bit_layers_batch"]


def sliding_windows(x: np.ndarray, n: int) -> np.ndarray:
    """(T,) → (T-n+1, n) view of ascending windows."""
    return np.lib.stride_tricks.sliding_window_view(x, n)


def fir_direct(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.int64)
    w = np.asarray(w, np.int64)
    return sliding_windows(x, w.size) @ w


def fir_bit_layers(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Eq. 2 for one type-I filter: the (0, 0) row of
    `fir_bit_layers_batch`, so single-filter and bank semantics are one
    code path."""
    w = np.asarray(w, np.int64)
    require_type1(w, "fir_bit_layers")
    return fir_bit_layers_batch(x, w)[0, 0, :]


def fir_bit_layers_batch(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Batched Eq. 2 oracle: B symmetric filters × C channels at once.

    ``x`` is (C, T) (or (T,), treated as one channel); ``w`` is (B, taps)
    (or (taps,)) odd symmetric integer coefficients sharing one tap count.
    Returns int64 (B, C, T - taps + 1).  One einsum contraction per bit
    layer.
    """
    x2 = np.atleast_2d(np.asarray(x, np.int64))
    w2 = np.atleast_2d(np.asarray(w, np.int64))
    n = require_type1(w2, "batched path")
    half = n // 2
    win = np.lib.stride_tricks.sliding_window_view(x2, n, axis=-1)  # (C,T',n)
    data = np.concatenate(
        [win[..., :half] + win[..., n - 1 : half : -1], win[..., half : half + 1]],
        axis=-1,
    )  # (C, T', M)
    digits = csd_digits(w2[:, : half + 1])  # (B, M, L) LSB-first
    acc = np.zeros((w2.shape[0], data.shape[0], data.shape[1]), np.int64)
    # deliberately the dense recursion: no layer skip, no superlayers
    for layer in range(digits.shape[2] - 1, -1, -1):  # MSB → LSB
        acc <<= 1
        acc += np.einsum("bm,ctm->bct", digits[:, :, layer], data)
    return acc
