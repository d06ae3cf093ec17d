"""Tensors placed on a mesh of device slots, and the slot collectives of
the language model's data-parallel path.

A `ShardedTensor` is what a JAX array with a `NamedSharding` is to the
reference: a global shape cut by a (sanitized) spec.  Each slot of the
mesh holds the block its coordinate selects; slots that hold the same
block on the same device share one piece, so a (2, 4) mesh of one card
stores every leaf exactly once, and a leaf replicated over slots on
distinct devices has one piece a device.  The first piece of each
distinct block (in mesh order) is its *canonical* piece: reductions that
must count a block once (the gradient clip's norm, Adafactor's means)
read those only.

Collectives move data between pieces with ``.to(device)`` — on several
cards the copies cross NVLink; no process group is involved:

  * the all-gather (`ShardedTensor.full`): the whole tensor on one
    device, an autograd function whose backward cuts the gradient back
    into each piece's gradient — the reduce-scatter of a data-parallel
    step, summed over data slots by autograd's accumulation into
    ``.grad``;
  * `all_reduce_sum`: tensors from several slots summed onto one device;
  * `sync_replicas`: every copy of a block set to the sum of the copies.

`TRAFFIC` counts the bytes the all-gathers and their backward moved.
`COLLECTIVES` counts every collective of this module (and the int8
all-reduce of `distributed.collectives`) by kind and data slot: its
calls, operand and result bytes, by group size (the pieces gathered or
summed).  On a mesh of ``meta`` slots the copies move nothing and the
counts are all there is: the dry run (`repro_torch.launch.dryrun`)
reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..nn.common import map_tree, map_trees
from .sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["COLLECTIVES", "COLLECTIVE_KINDS", "SeqShards", "ShardedTensor",
           "TRAFFIC", "all_reduce_sum", "record_collective",
           "data_slots", "device_put", "from_blocks", "gather", "open_cache",
           "placed_bytes", "reset_traffic", "rows_of", "slot_index",
           "sync_replicas", "zeros_placed"]

Index = tuple  # ((start, stop), ...) a dimension

TRAFFIC = {"gather_bytes": 0, "reduce_scatter_bytes": 0}

# the reference's names for the kinds (`repro.roofline.hlo_analysis`)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# (kind, data slot or None, group size) → {"calls", "operand_bytes",
# "result_bytes"}; the slot is None where no data slot is computing
# (Adafactor's reductions, `sync_replicas`, the int8 all-reduce)
COLLECTIVES: dict = {}


def reset_traffic() -> None:
    """Zero `TRAFFIC` and `COLLECTIVES`."""
    for k in TRAFFIC:
        TRAFFIC[k] = 0
    COLLECTIVES.clear()


def record_collective(kind: str, operand_bytes: int, result_bytes: int,
                      group: int, slot=None) -> None:
    """Count one collective of ``kind`` over ``group`` pieces."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    rec = COLLECTIVES.setdefault((kind, slot, int(group)), {
        "calls": 0, "operand_bytes": 0, "result_bytes": 0})
    rec["calls"] += 1
    rec["operand_bytes"] += int(operand_bytes)
    rec["result_bytes"] += int(result_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def slot_index(mesh: Mesh, spec: PartitionSpec, shape, pos) -> Index:
    """The block of a ``shape`` tensor cut by ``spec`` that the slot at
    mesh coordinate ``pos`` holds: its (start, stop) a dimension."""
    coord = dict(zip(mesh.axis_names, pos))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n, b = 1, 0
        for a in _axes(entry):
            b = b * mesh.shape[a] + coord[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n} "
                             f"ways): sanitize the spec first")
        size = dim // n
        out.append((b * size, (b + 1) * size))
    return tuple(out)


def _slices(index: Index) -> tuple:
    return tuple(slice(a, b) for a, b in index)


def _layout(sharding: NamedSharding, shape) -> tuple[list, list]:
    """(index, device) of every distinct piece, in mesh order."""
    seen, index, devices = set(), [], []
    mesh = sharding.mesh
    for pos in np.ndindex(mesh.devices.shape):
        key = (mesh.devices[pos], slot_index(mesh, sharding.spec, shape, pos))
        if key not in seen:
            seen.add(key)
            devices.append(key[0])
            index.append(key[1])
    return index, devices


def _copy_blocks(dst: torch.Tensor, dst_index: Index, blocks) -> None:
    """Copy into ``dst`` (the block ``dst_index`` of a global tensor) the
    part of each ``(index, tensor)`` block that overlaps it."""
    for index, t in blocks:
        inter = [(max(a0, b0), min(a1, b1))
                 for (a0, a1), (b0, b1) in zip(dst_index, index)]
        if any(lo >= hi for lo, hi in inter):
            continue
        d = tuple(slice(lo - a0, hi - a0)
                  for (lo, hi), (a0, _) in zip(inter, dst_index))
        s = tuple(slice(lo - b0, hi - b0)
                  for (lo, hi), (b0, _) in zip(inter, index))
        dst[d].copy_(t[s])


class _AllGather(torch.autograd.Function):
    """Pieces → the whole tensor on one device; the backward cuts the
    whole gradient into each piece's part, on the piece's device."""

    @staticmethod
    def forward(ctx, meta, *pieces):
        shape, dtype, device, index, devices, slot = meta
        out = torch.empty(shape, dtype=dtype, device=device)
        _copy_blocks(out, tuple((0, n) for n in shape), zip(index, pieces))
        ctx.meta = (index, devices, slot)
        TRAFFIC["gather_bytes"] += _nbytes(out)
        record_collective("all-gather", sum(map(_nbytes, pieces)),
                          _nbytes(out), len(pieces), slot)
        return out

    @staticmethod
    def backward(ctx, g):
        index, devices, slot = ctx.meta
        TRAFFIC["reduce_scatter_bytes"] += _nbytes(g)
        out = tuple(g[_slices(i)].to(d) for i, d in zip(index, devices))
        record_collective("reduce-scatter", _nbytes(g),
                          sum(map(_nbytes, out)), len(out), slot)
        return (None,) + out


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """A ``shape`` tensor stored as pieces on a mesh's slots, cut by
    ``sharding.spec``: ``pieces[i]`` is the block ``index[i]`` on the
    slot device ``devices[i]`` (a tensor on a ``cpu:k`` slot lies on the
    CPU, so the slot's device is kept beside it)."""

    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding
    index: list
    devices: list
    pieces: list

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """The bytes its pieces hold (a replica counts each time)."""
        return sum(p.numel() * p.element_size() for p in self.pieces)

    def groups(self) -> dict:
        """Distinct block → the pieces holding it, the canonical first."""
        out: dict = {}
        for i, idx in enumerate(self.index):
            out.setdefault(idx, []).append(i)
        return out

    def canonical(self) -> list[int]:
        return [ids[0] for ids in self.groups().values()]

    def _pick(self, device) -> list[int]:
        """One piece a distinct block: the one on ``device`` if any,
        else the canonical one."""
        return [next((i for i in ids if self.devices[i] == device), ids[0])
                for ids in self.groups().values()]

    def map(self, fn) -> "ShardedTensor":
        """The same layout with ``fn`` applied to every piece."""
        pieces = [fn(p) for p in self.pieces]
        return dataclasses.replace(self, pieces=pieces,
                                   dtype=pieces[0].dtype)

    def __getitem__(self, r: int) -> "ShardedTensor":
        """Layer ``r`` of a stacked leaf: views of the pieces holding it."""
        keep = [i for i, idx in enumerate(self.index)
                if idx[0][0] <= r < idx[0][1]]
        spec = PartitionSpec(*(list(self.spec)
                               + [None] * self.ndim)[1:self.ndim])
        return ShardedTensor(
            self.shape[1:], self.dtype, NamedSharding(self.mesh, spec),
            [self.index[i][1:] for i in keep],
            [self.devices[i] for i in keep],
            [self.pieces[i][r - self.index[i][0][0]] for i in keep])

    def full(self, device, slot=None) -> torch.Tensor:
        """The whole tensor on ``device`` (all-gather); differentiable
        into the pieces.  A block held whole on ``device`` is returned
        as it is.  ``slot``: the data slot that asks, for `COLLECTIVES`."""
        ids = self._pick(device)
        if len(ids) == 1 and self.devices[ids[0]] == device:
            return self.pieces[ids[0]]
        meta = (self.shape, self.dtype, device,
                [self.index[i] for i in ids], [self.devices[i] for i in ids],
                slot)
        return _AllGather.apply(meta, *[self.pieces[i] for i in ids])

    def slot_pieces(self) -> list[tuple]:
        """``(index, piece)`` of every slot in mesh order (a shared piece
        once per slot), as JAX lists an array's addressable shards."""
        mesh = self.mesh
        where = {(d, idx): i for i, (d, idx) in
                 enumerate(zip(self.devices, self.index))}
        out = []
        for pos in np.ndindex(mesh.devices.shape):
            idx = slot_index(mesh, self.spec, self.shape, pos)
            out.append((idx, self.pieces[where[(mesh.devices[pos], idx)]]))
        return out


def _new_pieces(sharding, shape, dtype, blocks) -> ShardedTensor:
    index, devices = _layout(sharding, shape)
    pieces = []
    for idx, dev in zip(index, devices):
        t = torch.empty(tuple(b - a for a, b in idx), dtype=dtype,
                        device=dev)
        _copy_blocks(t, idx, blocks)
        pieces.append(t)
    return ShardedTensor(tuple(shape), dtype, sharding, index, devices,
                         pieces)


def _place(x, sharding: NamedSharding) -> ShardedTensor:
    if isinstance(x, ShardedTensor):
        blocks = [(x.index[i], x.pieces[i]) for i in x.canonical()]
        return _new_pieces(sharding, x.shape, x.dtype, blocks)
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    whole = tuple((0, n) for n in x.shape)
    return _new_pieces(sharding, tuple(x.shape), x.dtype, [(whole, x)])


def from_blocks(sharding: NamedSharding, shape, dtype,
                blocks) -> ShardedTensor:
    """A placement of the ``shape`` tensor given as ``(index, tensor)``
    blocks that cover it (each data slot's rows, say)."""
    return _new_pieces(sharding, tuple(shape), dtype, list(blocks))


def device_put(tree, shardings):
    """``tree``'s leaves (tensors, numpy arrays or `ShardedTensor`s,
    which are re-placed) placed by the matching `NamedSharding` leaves
    of ``shardings``; each piece is a fresh copy.  A ``None`` sharding
    leaves its leaf as it is."""
    return map_trees(lambda x, sh: x if sh is None else _place(x, sh),
                     tree, shardings)


def gather(tree, device=None):
    """``tree`` with every `ShardedTensor` assembled whole on ``device``
    (default: the first piece's) and other tensors moved there."""
    def one(x):
        if isinstance(x, ShardedTensor):
            dev = device if device is not None else x.devices[0]
            out = torch.empty(x.shape, dtype=x.dtype, device=dev)
            _copy_blocks(out, tuple((0, n) for n in x.shape),
                         [(x.index[i], x.pieces[i]) for i in x._pick(dev)])
            return out
        if torch.is_tensor(x) and device is not None:
            return x.to(device)
        return x

    with torch.no_grad():
        return map_tree(one, tree)


def rows_of(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x`` (a `ShardedTensor` or a tensor) as a
    tensor on ``device``, not differentiable."""
    with torch.no_grad():
        if not isinstance(x, ShardedTensor):
            return torch.as_tensor(x)[lo:hi].to(device)
        shape = (hi - lo,) + tuple(x.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=device)
        _copy_blocks(out, ((lo, hi),) + tuple((0, n) for n in x.shape[1:]),
                     [(x.index[i], x.pieces[i]) for i in x._pick(device)])
        return out


def all_reduce_sum(parts, device) -> torch.Tensor:
    """The sum of ``parts`` (tensors on any slots) on ``device``, added
    in the order given."""
    total, operand = None, 0
    for p in parts:
        operand += _nbytes(p)
        p = p.to(device)
        total = p if total is None else total + p
    record_collective("all-reduce", operand, _nbytes(total), len(parts))
    return total


def sync_replicas(x: ShardedTensor) -> None:
    """In place: every piece of a block replicated on several devices set
    to the sum of its copies (summed on the canonical piece's device)."""
    with torch.no_grad():
        for ids in x.groups().values():
            if len(ids) < 2:
                continue
            total = all_reduce_sum([x.pieces[i] for i in ids],
                                   x.devices[ids[0]])
            for i in ids:
                x.pieces[i].copy_(total.to(x.devices[i]))


def zeros_placed(sharding: NamedSharding, shape, dtype) -> ShardedTensor:
    """Zeros of ``shape`` placed by ``sharding``, allocated piece by
    piece on the slots (never whole on one device)."""
    index, devices = _layout(sharding, tuple(shape))
    pieces = [torch.zeros(tuple(b - a for a, b in idx), dtype=dtype,
                          device=dev) for idx, dev in zip(index, devices)]
    return ShardedTensor(tuple(shape), dtype, sharding, index, devices,
                         pieces)


def placed_bytes(tree) -> dict:
    """Bytes a slot holds of ``tree``'s sharded leaves: ``{"total": all
    pieces, "per_slot": [each slot's pieces, shared pieces counted in
    every slot that holds them]}``."""
    leaves: list = []
    map_tree(lambda x: leaves.append(x) if isinstance(x, ShardedTensor)
             else None, tree)
    if not leaves:
        return {"total": 0, "per_slot": []}
    mesh = leaves[0].mesh
    per = np.zeros(mesh.size, np.int64)
    for x in leaves:
        for s, (_, p) in enumerate(x.slot_pieces()):
            per[s] += p.numel() * p.element_size()
    return {"total": int(sum(x.nbytes for x in leaves)),
            "per_slot": [int(v) for v in per]}


def data_slots(mesh: Mesh, rules: dict, n_rows: int) -> list[tuple]:
    """The data slots that split ``n_rows`` batch rows under ``rules``:
    ``(slot, device, lo, hi)`` each, row-major over the batch axes; the
    slot's device is that of its first slot (other axes at 0)."""
    from .sharding import batch_axes

    axes = batch_axes(rules)
    sizes = [mesh.shape[a] for a in axes]
    n = math.prod(sizes)
    if n_rows % n:
        raise ValueError(f"{n_rows} batch rows do not split over the "
                         f"{n} data slots of {axes}; place a batch of a "
                         f"multiple of {n} rows, or build the rules with "
                         f"make_rules(mesh, kind, global_batch={n_rows})")
    per = n_rows // n
    out = []
    for d, coord in enumerate(np.ndindex(*sizes)):
        dev = mesh.device_at(dict(zip(axes, coord)))
        out.append((d, dev, d * per, (d + 1) * per))
    return out


@dataclasses.dataclass
class SeqShards:
    """One data slot's rows of a decode cache leaf, split along its
    sequence dimension: ``parts`` are ``(lo, hi, view, device)`` in
    order, each view writable in place on its own device."""

    parts: list

    @property
    def length(self) -> int:
        return self.parts[-1][1]


def _slot_rows(x: ShardedTensor, lo: int, hi: int):
    """The pieces of ``x`` holding rows ``[lo, hi)`` whole, grouped by
    their block of the other dimensions; None when a piece holds part of
    those rows only."""
    groups: dict = {}
    for i, idx in enumerate(x.index):
        a, b = idx[0]
        if b <= lo or a >= hi:
            continue
        if a > lo or b < hi:
            return None
        groups.setdefault(idx[1:], []).append(i)
    return groups


def open_cache(tree: dict, ctx, seq_dims: dict) -> tuple[dict, Any]:
    """One layer's decode cache (a dict of sharded leaves) as ``ctx``'s
    data slot sees it: ``(view, close)``.

    When every leaf keeps the slot's rows in one piece on the slot's
    device, the view holds those rows as tensors written in place; when
    every leaf is cut along its ``seq_dims`` dimension only (one piece a
    block), as `SeqShards` the mixer attends piece by piece; otherwise
    the rows are gathered onto the slot's device and ``close()`` writes
    them back into every piece (replicas included)."""
    lo, hi = ctx.rows
    dev = ctx.device
    kinds, views = {}, {}
    for key, x in tree.items():
        groups = _slot_rows(x, lo, hi)
        kinds[key] = "gather"
        if groups is None:
            continue
        if len(groups) == 1:
            ids = next(iter(groups.values()))
            if len(ids) == 1 and x.devices[ids[0]] == dev:
                i = ids[0]
                a = x.index[i][0][0]
                kinds[key], views[key] = "whole", x.pieces[i][lo - a:hi - a]
                continue
        k = seq_dims.get(key)
        if k is None or any(len(ids) > 1 for ids in groups.values()):
            continue
        # a group's key is its block of dims 1.. (dim d at key[d - 1])
        split = [d for d in range(1, x.ndim) if d != k
                 and any(key[d - 1] != (0, x.shape[d]) for key in groups)]
        if split:
            continue
        parts = []
        for key_, (i,) in sorted(groups.items(), key=lambda g: g[0][k - 1]):
            a = x.index[i][0][0]
            s0, s1 = key_[k - 1]
            parts.append((s0, s1, x.pieces[i][lo - a:hi - a], x.devices[i]))
        kinds[key], views[key] = "seq", SeqShards(parts)
    if len(set(kinds.values())) > 1 or "gather" in kinds.values():
        kinds = dict.fromkeys(tree, "gather")
    if all(v == "gather" for v in kinds.values()):
        views = {key: rows_of(x, lo, hi, dev) for key, x in tree.items()}

        def close():
            with torch.no_grad():
                for key, x in tree.items():
                    block = ((lo, hi),) + tuple((0, n) for n in x.shape[1:])
                    for idx, p in zip(x.index, x.pieces):
                        _copy_blocks(p, idx, [(block, views[key])])

        return views, close
    return views, lambda: None
