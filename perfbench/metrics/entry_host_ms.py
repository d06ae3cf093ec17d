"""The median host time of the entry call (from handing the block over
to the call's return: lookup, schedule, framing, launch; no
synchronise), over the window's calls outside the traced sub-window."""
import statistics


def read(rec):
    return statistics.median(rec.host_ms) if rec.host_ms else None
