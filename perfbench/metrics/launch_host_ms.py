"""The program's framing and launches a call: the median, over the
traced calls, of the host time its ``repro_torch.frame``,
``repro_torch.launch.*`` (the output's allocation and the kernel's
library call) and ``repro_torch.stack`` spans cover."""
from perfbench.spans import median_ms


def read(rec):
    return median_ms(rec, ("frame", "launch.", "stack"))
