"""A kernel's share of its roofline: the least time the card could
take for a call's work, the larger of its Eq. 3 operations over the
peak integer rate and its bytes over the peak memory bandwidth (the
data-sheet peaks in ``peaks.json``), over the kernel's device time a
call (its mean duration in the trace times its launches a call)."""
from __future__ import annotations

__all__ = ["bound_s", "kernel_roofline_pct"]


def bound_s(work: dict, peaks: dict) -> float:
    return max(work["ops"] / peaks["int8_ops_per_s"],
               work["bytes"] / peaks["hbm_bytes_per_s"])


def kernel_roofline_pct(rec, kernel: str, counter: str) -> float | None:
    if rec.trace is None or rec.peaks is None or not rec.calls:
        return None
    times = [t for name, ts in rec.trace.kernels.items() if kernel in name
             for t in ts]
    launches = rec.counters.get(counter, 0) / rec.calls
    if not times or launches <= 0:
        return None
    per_call = sum(times) / len(times) * launches
    return 100.0 * bound_s(rec.work, rec.peaks) / per_call
