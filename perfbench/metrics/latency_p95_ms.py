"""The 95th percentile, over every block the window completed, of the
time from when the block was handed to the entry to when the host saw
its outputs ready (its completion event on the device)."""
import numpy as np


def read(rec):
    if not rec.calls:
        return None
    return float(np.percentile(rec.latencies_s, 95)) * 1e3
