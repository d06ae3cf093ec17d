"""Collectives of the port over a list of device slots: the overlap-save
halo exchange of a time-sharded FIR stream and the int8-compressed
data-parallel gradient all-reduce — `repro.distributed.collectives`
without `shard_map`.

Halo exchange: when a signal chunk is split along time over a mesh row,
every slot needs the last ``taps − 1`` samples of its left neighbour to
compute its own first outputs (overlap-save across devices instead of
across pushes).  The reference moves exactly that halo with one
`ppermute` inside `shard_map`; here the row's slices are tensors on
their slots' devices, and the halo is one copy from slot j − 1 to slot j.
The all-reduce takes one tensor a slot in the same way.
"""
from __future__ import annotations

import torch

from ..nn.common import map_tree, tree_leaves
from .placement import record_collective

__all__ = ["compressed_psum", "compressed_psum_tree", "halo_exchange_left",
           "make_compressed_dp_grad_fn"]


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


# ---------------------------------------------------------------------------
# int8-compressed data-parallel all-reduce
# ---------------------------------------------------------------------------


def compressed_psum(slots, generator: torch.Generator | None = None) -> list:
    """All-reduce-mean one tensor a slot in int8; returns the mean on
    every slot's device.

    Two phases, as the reference's: the slots agree on a *shared* scale
    (their max |x| over 127, so the integer sum decodes exactly to
    Σ scale·qᵢ), then each slot's tensor moves as int8 and the int32 sum
    is taken on the first slot's device: 1 byte an element and one
    float32 scalar a tensor, against 4 bytes an element for a float32
    all-reduce.  ``generator``: stochastic rounding (floor(y + U[0, 1)))
    with draws from it, in place of round-half-to-even.
    """
    slots = list(slots)
    home = slots[0].device
    gmax = torch.stack([s.abs().max().to(home) for s in slots]).max()
    record_collective("all-reduce", 4 * len(slots), 4, len(slots))
    scale = torch.where(gmax == 0, torch.ones_like(gmax), gmax / 127.0)
    total = None
    for s in slots:
        y = s / scale.to(s.device)
        if generator is not None:
            y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                           device=generator.device)
                            .to(s.device))
        else:
            y = torch.round(y)
        q = torch.clamp(y, -127, 127).to(torch.int8).to(home)
        total = q.to(torch.int32) if total is None else total + q
    # the int8 pieces summed into one int32 total (the scale's max above)
    record_collective("all-reduce", q.numel() * len(slots),
                      total.numel() * total.element_size(), len(slots))
    mean = total.to(torch.float32) * scale / float(len(slots))
    return [mean.to(s.device) for s in slots]


def compressed_psum_tree(slot_trees) -> list:
    """`compressed_psum` of every leaf of one tree a slot (nested dicts,
    lists or tuples of tensors); returns one reduced tree a slot."""
    slot_trees = list(slot_trees)
    reduced = [compressed_psum(group)
               for group in zip(*map(tree_leaves, slot_trees))]
    out = []
    for i, tree in enumerate(slot_trees):
        mine = iter(r[i] for r in reduced)
        out.append(map_tree(lambda _: next(mine), tree))
    return out


def make_compressed_dp_grad_fn(loss_fn, devices):
    """Data-parallel grads with the int8 all-reduce over the slots
    ``devices`` (a list of devices; one may repeat).

    Returns ``f(params, batch) → (loss, grads)``: the params (a tensor or
    a tree of them) replicated on every slot, the batch's leaves split by
    rows into one equal part a slot, each slot's ``loss_fn(params,
    part)`` differentiated there, its loss averaged over the slots and
    its grads all-reduced in int8 (`compressed_psum`); both on the first
    slot's device.
    """
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def wrapped(params, batch):
        for leaf in tree_leaves(batch):
            if leaf.shape[0] % n:
                raise ValueError(f"batch of {leaf.shape[0]} rows does not "
                                 f"split over {n} slots")
        losses, grads = [], []
        for i, dev in enumerate(devices):
            p = map_tree(lambda t: t.detach().to(dev).requires_grad_(True),
                         params)
            part = map_tree(lambda t: t.chunk(n, dim=0)[i].to(dev), batch)
            loss = loss_fn(p, part)
            g = iter(torch.autograd.grad(loss, tree_leaves(p)))
            grads.append(map_tree(lambda _: next(g), p))
            losses.append(loss.detach().to(devices[0]))
        loss = torch.stack(losses).sum() / n
        return loss, compressed_psum_tree(grads)[0]

    return wrapped
