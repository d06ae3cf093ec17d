"""The overlap-save halo exchange of a time-sharded FIR stream — the
port's counterpart of `repro.distributed.collectives.halo_exchange_left`.

When a signal chunk is split along time over a mesh row, every slot needs
the last ``taps − 1`` samples of its left neighbour to compute its own
first outputs (overlap-save across devices instead of across pushes).
The reference moves exactly that halo with one `ppermute` inside
`shard_map`; here the row's slices are tensors on their slots' devices,
and the halo is one copy from slot j − 1 to slot j.
"""
from __future__ import annotations

import torch

__all__ = ["halo_exchange_left"]


def halo_exchange_left(slices, halo: int) -> list:
    """Prepend the last ``halo`` samples of slice j − 1 (moved to slice
    j's device) to each ``(..., T_local)`` slice j of one mesh row.

    Slice 0 has no left neighbour and gets zeros, as `ppermute` gives
    them: its first ``halo`` outputs are the warm-up region the caller
    trims, like the zero-primed tail of a fresh overlap-save stream.
    """
    slices = list(slices)
    if halo <= 0:
        return slices
    for s in slices:
        if s.shape[-1] < halo:
            raise ValueError(
                f"halo {halo} exceeds the local slice ({s.shape[-1]} samples)")
    out = []
    for j, s in enumerate(slices):
        if j == 0:
            left = torch.zeros(s.shape[:-1] + (halo,), dtype=s.dtype,
                               device=s.device)
        else:
            left = slices[j - 1][..., -halo:].to(s.device)
        out.append(torch.cat([left, s], dim=-1))
    return out
