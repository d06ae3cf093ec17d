"""The benchmark's frozen copy of the paper's filter design (NumPy only).

§3.1: the filter-space sweep.  With the frequency axis divided into N
parts, one tap count gives N − 1 lowpass, N − 1 highpass, (N − 1)(N − 2)/2
bandpass and as many bandstop filters, in that order, each a windowed sinc
with scipy's passband-centre scaling (Nyquist = 1.0).

§3.2: each filter is scaled by the largest power of two that keeps its
largest coefficient inside a signed ``bits``-bit word and rounded
half-to-even (``np.rint``).

The arithmetic follows the design the paper describes step for step, so
that the bank is the same bit for bit as the program's own design; it is
kept here, apart from the program, so that no change to the program can
move the benchmark's inputs.  It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sweep_bands", "firwin_bank", "po2_quantize_rows", "design_bank"]


def sweep_bands(n_div: int) -> list[np.ndarray]:
    """Passband edges of the N(N − 1) sweep filters, in the §3.1 order:
    lowpass, highpass, bandpass, bandstop; pairs (i/N, j/N) with i < j."""
    fs = [i / n_div for i in range(1, n_div)]
    pairs = [(f1, f2) for i, f1 in enumerate(fs) for f2 in fs[i + 1:]]
    bands = [np.array([[0.0, f]]) for f in fs]
    bands += [np.array([[f, 1.0]]) for f in fs]
    bands += [np.array([[f1, f2]]) for f1, f2 in pairs]
    bands += [np.array([[0.0, f1], [f2, 1.0]]) for f1, f2 in pairs]
    return bands


def _window(numtaps: int, window: str) -> np.ndarray:
    if window != "hamming":
        raise ValueError(f"unsupported window {window!r}")
    return np.hamming(numtaps)


def firwin_bank(numtaps: int, bands: list[np.ndarray],
                window: str = "hamming") -> np.ndarray:
    """Windowed-sinc design of ``len(bands)`` filters at once → float64
    (n_filters, numtaps), unit gain at the centre of each first band."""
    if numtaps % 2 == 0:
        raise ValueError("type-I FIR filters need an odd tap count")
    nf = len(bands)
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    owners = np.concatenate(
        [np.full(len(b), i, dtype=np.int64) for i, b in enumerate(bands)])
    edges = np.concatenate([np.asarray(b, np.float64) for b in bands], axis=0)
    left, right = edges[:, 0:1], edges[:, 1:2]
    contrib = right * np.sinc(right * m) - left * np.sinc(left * m)
    h = np.zeros((nf, numtaps), np.float64)
    np.add.at(h, owners, contrib)
    h *= _window(numtaps, window)
    first = np.searchsorted(owners, np.arange(nf))
    l0, r0 = edges[first, 0], edges[first, 1]
    scale_f = np.where(l0 == 0.0, 0.0,
                       np.where(r0 == 1.0, 1.0, (l0 + r0) / 2))
    c = np.cos(np.pi * m[None, :] * scale_f[:, None])
    s = np.einsum("ft,ft->f", h, c)
    h /= s[:, None]
    return h


def po2_quantize_rows(bank: np.ndarray, bits: int = 16) -> np.ndarray:
    """Row-wise power-of-two scaling and half-to-even rounding → int64."""
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
            return q.astype(np.int64)
        k = np.where(over, k - 1, k)
    raise RuntimeError("po2 quantization did not converge")


def design_bank(design: dict) -> np.ndarray:
    """The quantized bank a configuration's ``design`` block names:
    ``{"kind": "sweep", "taps", "n_div", "window", "coeff_bits",
    "rows"}``; ``rows`` (a list, or null for all) picks filters of the
    sweep in its order.  Returns int64 (B, taps), C-contiguous."""
    if design["kind"] != "sweep":
        raise ValueError(f"unknown design kind {design['kind']!r}")
    q = po2_quantize_rows(
        firwin_bank(design["taps"], sweep_bands(design["n_div"]),
                    design["window"]),
        design["coeff_bits"])
    rows = design.get("rows")
    if rows is not None:
        q = q[np.asarray(rows, np.int64)]
    return np.ascontiguousarray(q)
