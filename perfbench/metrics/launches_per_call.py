"""Launches of the port's kernel wrappers (K1, K2, the fold) a call,
from their own counters over the window."""


def read(rec):
    if not rec.calls:
        return None
    return sum(rec.counters.values()) / rec.calls
