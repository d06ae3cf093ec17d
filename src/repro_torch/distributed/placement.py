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
  * the model slot's block (`ShardedTensor.block`): the block a slot of
    the ``model`` axis computes with, assembled from the pieces over the
    other axes (the FSDP axis of the train rules) — the same autograd
    function, its group the data size;
  * `all_reduce_sum`: tensors from several slots summed onto one device;
  * `sync_replicas`: every copy of a block set to the sum of the copies;
  * the tensor-parallel moves of an activation between a data slot and
    its model slots: `to_model_slots` (a copy a slot; backward, the
    gradients' all-reduce), `from_model_slots` (the partial sums'
    all-reduce; backward, the gradient handed to each slot),
    `gather_model_parts` (the parts cut along a dimension joined: an
    all-gather), `all_reduce_max`, `reduce_scatter_model` (the partial
    sums reduced, each slot keeping its block of a dimension; backward,
    the all-gather) and `regroup_model` (each slot's parts of a
    dimension re-cut into the ranges each slot asks for: point-to-point
    sends, a collective-permute each way).

`TRAFFIC` counts the bytes the weight all-gathers and their backward
moved.  `COLLECTIVES` counts every collective of this module (and the
int8 all-reduce of `distributed.collectives`) by kind and data slot: its
calls, operand and result bytes, by group size (the pieces gathered or
summed).  On a mesh of ``meta`` slots the copies move nothing and the
counts are all there is: the dry run (`repro_torch.launch.dryrun`)
reads them.

The *issuer* of an op is the device slot that computes it: `issuing`
names it while a model slot's part runs (a flat index into the mesh;
None: the data slot's own work, which the reference replicates over
``model``), and while a dry run traces (`TAGGING`), `tag_graph` marks
the autograd nodes of that part so that its backward is counted there
too (`current_issuer`).  A collective recorded under an issuer is keyed
``(data slot, issuer)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..nn.common import map_tree, map_trees
from .sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["COLLECTIVES", "COLLECTIVE_KINDS", "MODEL_AXIS", "SeqShards",
           "ShardedTensor", "TAGGING", "TRAFFIC", "all_reduce_max",
           "all_reduce_sum", "current_issuer", "data_slots", "device_put",
           "from_blocks", "from_model_slots", "gather", "gather_model_parts",
           "issuing", "open_cache", "placed_bytes", "record_collective",
           "reduce_scatter_model", "regroup_model", "repeat_factor",
           "repeated", "reset_traffic",
           "rows_of", "slot_index", "sync_replicas", "tag_graph",
           "to_model_slots", "zeros_placed"]

Index = tuple  # ((start, stop), ...) a dimension
MODEL_AXIS = "model"

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


# the issuers named by `issuing`, innermost last
_ISSUERS: list = []
# on while a dry run traces: `tag_graph` marks autograd nodes
TAGGING = {"on": False}


@contextlib.contextmanager
def issuing(tag):
    """The ops and collectives inside are the work of the device slot
    ``tag`` (a flat index into the mesh; None: the data slot's own)."""
    _ISSUERS.append(tag)
    try:
        yield
    finally:
        _ISSUERS.pop()


# the multiplicities named by `repeated`, innermost last
_REPEATS: list = []


@contextlib.contextmanager
def repeated(n: int):
    """The ops inside stand for ``n`` identical ones: a loop whose every
    iteration has the same shapes, walked once on ``meta`` tensors, which
    carry no values.  An `OpCounter` counts each op ``n`` times (its
    memory once: an iteration frees what the one before made)."""
    _REPEATS.append(int(n))
    try:
        yield
    finally:
        _REPEATS.pop()


def repeat_factor() -> int:
    """How many ops each op dispatched now stands for (`repeated`)."""
    return math.prod(_REPEATS)


def current_issuer():
    """The innermost `issuing` tag; outside one, in a backward, the tag
    `tag_graph` gave the autograd node being run; else None."""
    if _ISSUERS:
        return _ISSUERS[-1]
    node = torch._C._current_autograd_node()
    return None if node is None else node.metadata.get("issuer")


def tag_graph(tensors, tag) -> None:
    """While `TAGGING` is on: the autograd nodes behind ``tensors`` (a
    tensor or a list), as far back as nodes already tagged, marked as
    the work of ``tag`` so that their backward counts there."""
    if not TAGGING["on"]:
        return
    if torch.is_tensor(tensors):
        tensors = [tensors]
    todo = [t.grad_fn for t in tensors if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or "issuer" in node.metadata:
            continue
        node.metadata["issuer"] = tag
        todo.extend(n for n, _ in node.next_functions)


def record_collective(kind: str, operand_bytes: int, result_bytes: int,
                      group: int, slot=None) -> None:
    """Count one collective of ``kind`` over ``group`` pieces, for data
    slot ``slot`` (keyed ``(slot, issuer)`` under an issuer)."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    issuer = current_issuer()
    if issuer is not None:
        slot = (slot, issuer)
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
    """Pieces → the block ``target`` of the whole tensor on one device;
    the backward cuts its gradient into each piece's part, on the
    piece's device.  Every piece lies inside the target."""

    @staticmethod
    def forward(ctx, meta, *pieces):
        target, dtype, device, index, devices, slot = meta
        out = torch.empty(tuple(b - a for a, b in target), dtype=dtype,
                          device=device)
        _copy_blocks(out, target, zip(index, pieces))
        ctx.meta = ([tuple((a - t, b - t) for (a, b), (t, _)
                           in zip(i, target)) for i in index], devices, slot)
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
        return self._assemble(tuple((0, n) for n in self.shape), device,
                              slot)

    def model_range(self, m: int) -> Index:
        """The block model slot ``m`` computes with: the dimension cut
        over ``model`` at its ``m``-th block, every other dimension whole.
        A dimension cut over ``model`` together with another axis
        raises: no product takes it."""
        n = self.mesh.shape[MODEL_AXIS]
        out = []
        for dim, entry in zip(self.shape, list(self.spec)
                              + [None] * (self.ndim - len(self.spec))):
            axes = _axes(entry)
            if MODEL_AXIS in axes and axes != (MODEL_AXIS,):
                raise ValueError(f"a dimension cut over {entry}: no model "
                                 f"slot computes with a block of it")
            cut = MODEL_AXIS in axes
            size = dim // n if cut else dim
            a = m * size if cut else 0
            out.append((a, a + size))
        return tuple(out)

    def block(self, m: int, device, slot=None) -> torch.Tensor:
        """Model slot ``m``'s block (`model_range`) on ``device``: its
        piece where the slot holds it whole, else assembled from the
        pieces over the other axes (an all-gather over the FSDP axis);
        differentiable into the pieces."""
        return self._assemble(self.model_range(m), device, slot)

    def _assemble(self, target: Index, device, slot) -> torch.Tensor:
        ids = [i for i in self._pick(device)
               if all(a < d and c < b for (a, b), (c, d)
                      in zip(self.index[i], target))]
        for i in ids:
            if any(a < c or b > d for (a, b), (c, d)
                   in zip(self.index[i], target)):
                raise ValueError(f"a piece {self.index[i]} crosses the "
                                 f"block {target}")
        if len(ids) == 1 and self.devices[ids[0]] == device \
                and self.index[ids[0]] == target:
            return self.pieces[ids[0]]
        meta = (target, self.dtype, device,
                [self.index[i] for i in ids], [self.devices[i] for i in ids],
                slot)
        return _AllGather.apply(meta, *[self.pieces[i] for i in ids])

    def slot_of(self, i: int) -> int:
        """The flat mesh index of the first slot holding piece ``i``."""
        mesh = self.mesh
        for pos in np.ndindex(mesh.devices.shape):
            if mesh.devices[pos] == self.devices[i] and slot_index(
                    mesh, self.spec, self.shape, pos) == self.index[i]:
                return int(np.ravel_multi_index(pos, mesh.devices.shape))
        raise ValueError(f"piece {i} is on no slot")

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


class _ToSlots(torch.autograd.Function):
    """A tensor → a copy on each model slot's device (the tensor itself
    where the slot shares its device); the backward sums the slots'
    gradients onto the tensor's device (an all-reduce)."""

    @staticmethod
    def forward(ctx, meta, x):
        devices, home, slot = meta
        ctx.set_materialize_grads(False)
        ctx.meta = (home, slot, len(devices))
        return tuple(x if d == home else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        home, slot, n = ctx.meta
        gs = [g for g in grads if g is not None]
        if not gs:
            return None, None
        total = _summed(gs, home)
        record_collective("all-reduce", sum(map(_nbytes, gs)),
                          _nbytes(total), n, slot)
        return None, total


class _FromSlots(torch.autograd.Function):
    """The model slots' partial sums → their sum on one device (an
    all-reduce); the backward hands the gradient to each slot."""

    @staticmethod
    def forward(ctx, meta, *parts):
        home, devices, slot = meta
        ctx.devices = devices
        total = _summed(parts, home)
        record_collective("all-reduce", sum(map(_nbytes, parts)),
                          _nbytes(total), len(parts), slot)
        return total

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.devices)


class _JoinSlots(torch.autograd.Function):
    """The model slots' parts of a tensor cut along ``dim`` → the tensor
    on one device (an all-gather); the backward cuts its gradient."""

    @staticmethod
    def forward(ctx, meta, *parts):
        home, devices, dim, slot = meta
        ctx.meta = (devices, dim, [p.shape[dim] for p in parts])
        out = torch.cat([p.to(home) for p in parts], dim=dim)
        record_collective("all-gather", sum(map(_nbytes, parts)),
                          _nbytes(out), len(parts), slot)
        return out

    @staticmethod
    def backward(ctx, g):
        devices, dim, sizes = ctx.meta
        return (None,) + tuple(t.to(d) for t, d in
                               zip(g.split(sizes, dim=dim), devices))


class _ScatterSlots(torch.autograd.Function):
    """The model slots' partial sums (each the whole tensor) → slot
    ``m``'s block of ``dim`` of their sum, on its device (a
    reduce-scatter); the backward joins the blocks' gradients on every
    slot (an all-gather)."""

    @staticmethod
    def forward(ctx, meta, *parts):
        devices, dim, slot = meta
        n = len(parts)
        size = parts[0].shape[dim] // n
        out = tuple(_summed([p.narrow(dim, m * size, size) for p in parts],
                            d) for m, d in enumerate(devices))
        ctx.meta = (devices, dim, slot)
        record_collective("reduce-scatter", _nbytes(parts[0]),
                          sum(map(_nbytes, out)), n, slot)
        return out

    @staticmethod
    def backward(ctx, *grads):
        devices, dim, slot = ctx.meta
        out = tuple(torch.cat([g.to(d) for g in grads], dim=dim)
                    for d in devices)
        record_collective("all-gather", sum(map(_nbytes, grads)),
                          _nbytes(out[0]), len(grads), slot)
        return (None,) + out


def _untagged(out) -> None:
    """Mark the autograd node behind ``out`` as the data slot's own, so
    that `tag_graph` stops there: a move between model slots belongs to
    none of them."""
    if TAGGING["on"] and out and out[0].grad_fn is not None:
        out[0].grad_fn.metadata["issuer"] = None


def reduce_scatter_model(parts, dim: int, devices, slot=None) -> list:
    """The sum of the model slots' ``parts`` cut evenly along ``dim``:
    slot ``m``'s block on ``devices[m]`` (reduce-scatter)."""
    out = list(_ScatterSlots.apply((list(devices), dim, slot), *parts))
    _untagged(out)
    return out


class _Regroup(torch.autograd.Function):
    """Parts of a tensor cut along ``dim`` (part ``k`` holding the global
    range ``have[k]``) → for each slot ``m`` one tensor a range of
    ``need[m]``, on its device; the backward sends each range's gradient
    back to the parts holding it (added where several slots asked for
    the same range)."""

    @staticmethod
    def forward(ctx, meta, *parts):
        have, need, devices, dim, tags, slot = meta
        ctx.meta = meta
        ctx.shapes = [p.shape for p in parts]
        out = []
        for m, ranges in enumerate(need):
            moved = 0
            for a, b in ranges:
                pieces = []
                for k, (ha, hb) in enumerate(have):
                    lo, hi = max(a, ha), min(b, hb)
                    if lo >= hi:
                        continue
                    t = parts[k].narrow(dim, lo - ha, hi - lo)
                    if k != m:
                        moved += _nbytes(t)
                    pieces.append(t.to(devices[m]))
                out.append(torch.cat(pieces, dim=dim) if len(pieces) > 1
                           else pieces[0].clone())
            _record_permute(moved, len(have), slot, tags[m])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        have, need, devices, dim, tags, slot = ctx.meta
        sums = [None] * len(have)
        dtype = next(g.dtype for g in grads if g is not None)
        # a range several slots asked for sums their gradients: 16-bit
        # ones added in float32 and rounded once, as `_summed` adds
        wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
            else dtype
        it = iter(grads)
        for m, ranges in enumerate(need):
            moved = 0
            for a, b in ranges:
                g = next(it)
                if g is None:
                    continue
                for k, (ha, hb) in enumerate(have):
                    lo, hi = max(a, ha), min(b, hb)
                    if lo >= hi:
                        continue
                    if sums[k] is None:
                        sums[k] = torch.zeros(ctx.shapes[k], dtype=wide,
                                              device=devices[k])
                    t = g.narrow(dim, lo - a, hi - lo)
                    if k != m:
                        moved += _nbytes(t)
                    sums[k].narrow(dim, lo - ha, hi - lo).add_(
                        t.to(devices[k]))
            _record_permute(moved, len(have), slot, tags[m])
        return (None,) + tuple(None if t is None else t.to(dtype)
                               for t in sums)


def _record_permute(moved: int, group: int, slot, tag) -> None:
    if moved:
        with issuing(tag):
            record_collective("collective-permute", moved, moved, group,
                              slot)


def regroup_model(parts, dim: int, have, need, devices, tags,
                  slot=None) -> list:
    """Re-cut a tensor held by the model slots as ``parts`` along ``dim``
    (part ``k``: the global range ``have[k]``): slot ``m`` receives, on
    ``devices[m]``, one tensor for each range of ``need[m]``, in order.
    What a slot receives from the other slots is recorded as a
    collective-permute issued by it (``tags[m]``), each way."""
    meta = ([tuple(h) for h in have], [list(map(tuple, r)) for r in need],
            list(devices), dim, list(tags), slot)
    flat = list(_Regroup.apply(meta, *parts))
    _untagged(flat)
    out, i = [], 0
    for ranges in need:
        out.append(flat[i:i + len(ranges)])
        i += len(ranges)
    return out


def _summed(parts, device) -> torch.Tensor:
    """The parts added in order on ``device``; 16-bit floats added in
    float32 and rounded once, as a matmul accumulates its products."""
    dtype = parts[0].dtype
    wide = dtype in (torch.bfloat16, torch.float16)
    total = None
    for p in parts:
        p = p.to(device)
        if wide:
            p = p.float()
        total = p if total is None else total + p
    return total.to(dtype) if wide else total


def to_model_slots(x: torch.Tensor, devices, home, slot=None) -> list:
    """``x`` (on ``home``, the data slot's device) as one tensor a model
    slot, on ``devices``; its backward is the gradients' all-reduce."""
    out = list(_ToSlots.apply((list(devices), home, slot), x))
    _untagged(out)
    return out


def from_model_slots(parts, home, devices, slot=None) -> torch.Tensor:
    """The sum of the model slots' ``parts`` on ``home`` (all-reduce)."""
    return _FromSlots.apply((home, list(devices), slot), *parts)


def gather_model_parts(parts, dim: int, home, devices,
                       slot=None) -> torch.Tensor:
    """The model slots' ``parts`` of a tensor cut along ``dim`` joined on
    ``home`` (all-gather)."""
    return _JoinSlots.apply((home, list(devices), dim, slot), *parts)


def all_reduce_max(parts, home, slot=None) -> torch.Tensor:
    """The element-wise maximum of ``parts`` on ``home``, no gradient."""
    with torch.no_grad():
        out = torch.stack([p.to(home) for p in parts]).amax(dim=0)
    record_collective("all-reduce", sum(map(_nbytes, parts)), _nbytes(out),
                      len(parts), slot)
    return out


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
    order, each view writable in place on its own device; ``slots``: the
    flat mesh index of each part's slot (its issuer)."""

    parts: list
    slots: list = dataclasses.field(default_factory=list)

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


def _model_view(x: ShardedTensor, k: int, ctx, lo: int, hi: int):
    """The data slot's rows ``[lo, hi)`` of ``x`` as a `Split` of the
    pieces its model slots hold, cut along dim ``k`` over ``model``
    alone (each part a view of the piece on its slot's device); None
    where the pieces do not lie so."""
    from ..nn.common import Split

    entries = list(x.spec) + [None] * (x.ndim - len(x.spec))
    if entries[k] != MODEL_AXIS or any(
            MODEL_AXIS in _axes(e) for d, e in enumerate(entries) if d != k):
        return None
    parts = []
    for s in ctx.model_slots:
        want = x.model_range(s.m)[1:]
        i = next((i for i, idx in enumerate(x.index)
                  if x.devices[i] == s.device and idx[1:] == want
                  and idx[0][0] <= lo and hi <= idx[0][1]), None)
        if i is None:
            return None
        a = x.index[i][0][0]
        parts.append(x.pieces[i][lo - a:hi - a])
    return Split(parts, k)


def open_cache(tree: dict, ctx, seq_dims: dict,
               model_dims: dict | None = None) -> tuple[dict, Any]:
    """One layer's decode cache (a dict of sharded leaves) as ``ctx``'s
    data slot sees it: ``(view, close)``.

    When every leaf keeps the slot's rows in one piece on the slot's
    device, the view holds those rows as tensors written in place; when
    every leaf is cut along its ``seq_dims`` dimension only (one piece a
    block), as `SeqShards` the mixer attends piece by piece; when every
    leaf is cut over ``model`` along its ``model_dims`` dimension (the
    recurrent states, on a tensor-parallel mesh), as a `Split` of views
    of its model slots' pieces, each read and written in place by its
    slot; otherwise the rows are gathered onto the slot's device and
    ``close()`` writes them back into every piece (replicas
    included)."""
    lo, hi = ctx.rows
    dev = ctx.device
    kinds, views = {}, {}
    for key, x in tree.items():
        groups = _slot_rows(x, lo, hi)
        kinds[key] = "gather"
        if groups is None:
            continue
        k = (model_dims or {}).get(key)
        if k is not None and ctx.tp:
            view = _model_view(x, k, ctx, lo, hi)
            if view is not None:
                kinds[key], views[key] = "model", view
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
        parts, slots = [], []
        for key_, (i,) in sorted(groups.items(), key=lambda g: g[0][k - 1]):
            a = x.index[i][0][0]
            s0, s1 = key_[k - 1]
            parts.append((s0, s1, x.pieces[i][lo - a:hi - a], x.devices[i]))
            slots.append(x.slot_of(i) if TAGGING["on"] else None)
        kinds[key], views[key] = "seq", SeqShards(parts, slots)
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
