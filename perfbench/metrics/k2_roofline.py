"""K2 (``blmac_specialized_kernel``): the call's least time over K2's
device time a call."""
from perfbench.roofline import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "blmac_specialized_kernel",
                               "specialized_call")
