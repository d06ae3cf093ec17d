"""K1 (``blmac_bank_kernel``): the call's least time over K1's device
time a call."""
from perfbench.roofline import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "blmac_bank_kernel", "bank_apply")
