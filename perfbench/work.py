"""The work a call does, counted from the benchmark's own inputs (NumPy).

The operations are the additions of the paper's Eq. 3 for each output:
``taps // 2`` pre-adds of the symmetric sample pairs plus one addition
per nonzero digit of the canonical signed-digit (non-adjacent) form of
each coefficient of the folded half (taps 0 .. taps // 2).  The bytes are
each int32 input sample read once, each int32 output written once and
each coefficient once, as a word of ``coeff_bits`` bits.  Neither count
depends on how the program computes the result.
"""
from __future__ import annotations

import numpy as np

__all__ = ["naf_weight", "eq3_additions", "call_work"]


def naf_weight(v) -> np.ndarray:
    """Nonzero digits of the non-adjacent form of each integer in ``v``:
    digit by digit from the least significant, d = ±1 where the rest is
    odd (chosen so that the rest less d is a multiple of 4), else 0."""
    rest = np.abs(np.asarray(v, np.int64))
    count = np.zeros(rest.shape, np.int64)
    while np.any(rest):
        odd = (rest & 1) == 1
        d = np.where(odd, np.where((rest & 3) == 1, 1, -1), 0)
        count += odd
        rest = (rest - d) >> 1
    return count


def eq3_additions(qbank: np.ndarray) -> np.ndarray:
    """Eq. 3 additions per output sample of each (type-I) filter → (B,)."""
    q = np.atleast_2d(np.asarray(qbank, np.int64))
    taps = q.shape[-1]
    if taps % 2 == 0:
        raise ValueError("type-I filters have an odd tap count")
    return taps // 2 + naf_weight(q[:, : taps // 2 + 1]).sum(axis=-1)


def call_work(qbank: np.ndarray, channels: int, samples: int,
              coeff_bits: int) -> dict:
    """Outputs, Eq. 3 operations and bytes of one call of a (B, taps)
    bank over a (channels, samples) block."""
    q = np.atleast_2d(np.asarray(qbank, np.int64))
    n_filters, taps = q.shape
    n_out = samples - taps + 1
    outputs = n_filters * channels * n_out
    ops = int(eq3_additions(q).sum()) * channels * n_out
    nbytes = (4 * channels * samples + 4 * outputs
              + n_filters * taps * coeff_bits // 8)
    return {"outputs": outputs, "n_out": n_out, "ops": ops, "bytes": nbytes}
