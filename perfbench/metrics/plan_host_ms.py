"""The program's plan a call: the median, over the traced calls, of the
host time of its ``repro_torch.plan`` span (K1's path: the memoized
schedule and K1's tables looked up; the one-filter path: the pulse
tuple unpacked and its K2 program looked up)."""
from perfbench.spans import median_ms


def read(rec):
    return median_ms(rec, ("plan",))
