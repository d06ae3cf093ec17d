"""The program's bank lookup a call: the median, over the traced calls,
of the host time of its ``repro_torch.compile.lookup`` span (the bank's
coercion to int64, its sha256 digest, the program memo's answer)."""
from perfbench.spans import median_ms


def read(rec):
    return median_ms(rec, ("compile.lookup",))
