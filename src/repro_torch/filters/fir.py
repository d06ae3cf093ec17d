"""Windowed-sinc FIR design, vectorized over whole filter banks.

The port's copy of `repro.filters.fir`: ``firwin_batch`` reproduces
``scipy.signal.firwin`` (windowed-sinc with passband-centre scaling) for
thousands of filters in one numpy pass, or across a process pool
(``workers=``) for the paper's sweep banks.  Normalized frequencies
follow scipy's convention: Nyquist = 1.0.
"""
from __future__ import annotations

import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Literal, Sequence

import numpy as np

FilterKind = Literal["lowpass", "highpass", "bandpass", "bandstop"]

__all__ = ["FilterKind", "bands_for", "window_values", "firwin_batch",
           "design_bank", "spread_lowpass_qbank"]


def bands_for(kind: FilterKind, cutoff: float | tuple[float, float]) -> np.ndarray:
    """Passband edges [(left, right), ...] for one filter, scipy-style."""
    if kind == "lowpass":
        return np.array([[0.0, float(cutoff)]])
    if kind == "highpass":
        return np.array([[float(cutoff), 1.0]])
    f1, f2 = cutoff  # type: ignore[misc]
    if kind == "bandpass":
        return np.array([[float(f1), float(f2)]])
    if kind == "bandstop":
        return np.array([[0.0, float(f1)], [float(f2), 1.0]])
    raise ValueError(f"unknown filter kind {kind!r}")


@functools.lru_cache(maxsize=256)
def _window_cached(numtaps: int, key) -> np.ndarray:
    w = np.hamming(numtaps) if key == "hamming" else np.kaiser(numtaps, key[1])
    w.setflags(write=False)  # memoized: callers share one read-only array
    return w


def window_values(numtaps: int, window: str | tuple = "hamming") -> np.ndarray:
    """Symmetric window samples (Hamming or ``("kaiser", beta)``),
    memoized per (numtaps, window); the array is read-only."""
    if window == "hamming":
        key = "hamming"
    elif isinstance(window, tuple) and window[0] == "kaiser":
        key = ("kaiser", float(window[1]))
    else:
        raise ValueError(f"unsupported window {window!r}")
    return _window_cached(numtaps, key)


def firwin_batch(
    numtaps: int,
    bands: Sequence[np.ndarray],
    window: str | tuple = "hamming",
    scale: bool = True,
    workers: int | None = None,
) -> np.ndarray:
    """Design ``len(bands)`` filters of ``numtaps`` taps at once.

    ``bands[i]`` is an (n_bands_i, 2) array of passband edges.  Returns
    float64 (n_filters, numtaps), the reference's construction, step for
    step (same summed-sinc terms, same passband-centre scaling rule).

    ``workers`` > 1 splits a bank of at least ``4 * workers`` filters
    into contiguous slices designed in a process pool: every filter is
    designed on its own (the scaling is per filter), so the slices
    concatenate to the same bank, bit for bit, as ``workers=None``.  The
    workers are spawned (a fork is unsafe once torch or CUDA has started
    threads), so a pool first pays each worker's import of the package.
    """
    if numtaps % 2 == 0:
        raise ValueError("type-I FIR filters need an odd tap count")
    if workers and workers > 1 and len(bands) >= 4 * workers:
        chunks = np.array_split(np.arange(len(bands)), workers)
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=spawn) as pool:
            parts = pool.map(
                _firwin_chunk,
                [(numtaps, [bands[i] for i in c], window, scale) for c in chunks],
            )
            return np.concatenate(list(parts), axis=0)
    nf = len(bands)
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0  # (T,)
    # flatten all bands with an owner index so one vector pass handles
    # filters with different band counts (bandstop has two)
    owners = np.concatenate(
        [np.full(len(b), i, dtype=np.int64) for i, b in enumerate(bands)]
    )
    edges = np.concatenate([np.asarray(b, np.float64) for b in bands], axis=0)
    if np.any(edges[:, 0] >= edges[:, 1]) or np.any(edges < 0) or np.any(edges > 1):
        raise ValueError("band edges must satisfy 0 <= left < right <= 1")
    left, right = edges[:, 0:1], edges[:, 1:2]  # (B, 1)
    contrib = right * np.sinc(right * m) - left * np.sinc(left * m)  # (B, T)
    h = np.zeros((nf, numtaps), np.float64)
    np.add.at(h, owners, contrib)
    h *= window_values(numtaps, window)
    if scale:
        # scipy: normalize unit gain at the centre of the *first* band
        first = np.searchsorted(owners, np.arange(nf))
        l0, r0 = edges[first, 0], edges[first, 1]
        scale_f = np.where(l0 == 0.0, 0.0, np.where(r0 == 1.0, 1.0, (l0 + r0) / 2))
        c = np.cos(np.pi * m[None, :] * scale_f[:, None])  # (F, T)
        s = np.einsum("ft,ft->f", h, c)
        h /= s[:, None]
    return h


def _firwin_chunk(args) -> np.ndarray:
    """Process-pool worker: design one contiguous slice of a bank."""
    numtaps, bands, window, scale = args
    return firwin_batch(numtaps, bands, window, scale)


def design_bank(
    numtaps: int,
    specs: Sequence[tuple[FilterKind, float | tuple[float, float]]],
    window: str | tuple = "hamming",
) -> np.ndarray:
    """Convenience: design a heterogeneous bank from (kind, cutoff) specs."""
    return firwin_batch(numtaps, [bands_for(k, c) for k, c in specs], window)


def spread_lowpass_qbank(
    n_filters: int, taps: int, coeff_bits: int = 16
) -> np.ndarray:
    """Quantized lowpass bank with evenly spread cutoffs in (0.05, 0.95) —
    the reference's shared demo and serving workload, built the same
    way so the two packages serve the same bank."""
    from ..core.quantize import po2_quantize_batch

    cuts = 0.05 + 0.9 * (np.arange(n_filters) + 0.5) / n_filters
    q, _ = po2_quantize_batch(
        design_bank(taps, [("lowpass", float(c)) for c in cuts]), coeff_bits
    )
    return q
