"""The paper's §3.1 filter-space sweep, exactly (the port's copy of
`repro.filters.sweep`).

With the frequency axis divided into N parts (paper: N = 100):
  lowpass  : cutoffs  i/N, i = 1..N-1                    → N−1 filters
  highpass : same                                         → N−1 filters
  bandpass : pairs (i/N, j/N), 1 ≤ i < j ≤ N−1            → (N−1)(N−2)/2
  bandstop : same pairs                                   → (N−1)(N−2)/2
total N(N−1) per tap count (9,900 at N=100); taps sweep 55..255 odd
(101 values) × {Hamming, Kaiser} ⇒ 1,980,000 filters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from .fir import FilterKind, bands_for, firwin_batch

__all__ = ["SweepSpec", "sweep_specs", "sweep_bank", "iter_sweep",
           "TAPS_RANGE"]

TAPS_RANGE = tuple(range(55, 256, 2))  # odd only: type I


@dataclass(frozen=True)
class SweepSpec:
    kind: FilterKind
    cutoff: float | tuple[float, float]


def sweep_specs(n_div: int = 100) -> list[SweepSpec]:
    """All N(N−1) (kind, cutoff) specs for one tap count."""
    fs = [i / n_div for i in range(1, n_div)]
    specs: list[SweepSpec] = []
    specs += [SweepSpec("lowpass", f) for f in fs]
    specs += [SweepSpec("highpass", f) for f in fs]
    pairs = [(f1, f2) for i, f1 in enumerate(fs) for f2 in fs[i + 1 :]]
    specs += [SweepSpec("bandpass", p) for p in pairs]
    specs += [SweepSpec("bandstop", p) for p in pairs]
    assert len(specs) == n_div * (n_div - 1)
    return specs


def sweep_bank(
    numtaps: int,
    n_div: int = 100,
    window: str | tuple = "hamming",
    specs: Sequence[SweepSpec] | None = None,
    workers: int | None = None,
) -> np.ndarray:
    """Design the full (n_div*(n_div-1), numtaps) bank for one tap count;
    ``workers`` fans the design across a process pool (`firwin_batch`)."""
    if specs is None:
        specs = sweep_specs(n_div)
    return firwin_batch(
        numtaps, [bands_for(s.kind, s.cutoff) for s in specs], window,
        workers=workers,
    )


def iter_sweep(
    n_div: int = 100,
    taps: Sequence[int] = TAPS_RANGE,
    window: str | tuple = "hamming",
    workers: int | None = None,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (numtaps, bank) across the tap sweep, one bank at a time."""
    specs = sweep_specs(n_div)
    for t in taps:
        yield t, sweep_bank(t, n_div, window, specs, workers=workers)
