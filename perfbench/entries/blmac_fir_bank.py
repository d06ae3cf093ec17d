"""Entry: ``repro_torch.kernels.blmac_fir_bank(x, qbank)``, the port's
public bank call.  It looks the bank up by its content (compiling it on
the first call), frames the block and launches K1 for the whole bank, or
K2 for a one-filter bank, and returns int32 (B, C, n_out) on the block's
device."""
from __future__ import annotations

import importlib

__all__ = ["make", "counters"]


def make(qbank, device):
    from repro_torch.kernels import blmac_fir_bank

    def call(x):
        return blmac_fir_bank(x, qbank, device=x.device)

    return call


def counters() -> dict:
    """The kernel wrappers' launch counters (``.launches``)."""
    bf = importlib.import_module("repro_torch.kernels.blmac_fir")
    return {"bank_apply": bf.bank_apply.launches,
            "specialized_call": bf.specialized_call.launches,
            "combine_fold": bf.combine_fold.launches}
