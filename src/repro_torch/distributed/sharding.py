"""Logical-axis → mesh-axis rules, the meshes of device slots, and the
filter-bank partition: `repro.distributed.sharding` without JAX.

JAX's mesh is one process driving every device through SPMD; its
counterpart here is one process that keeps each shard's tensors on its
mesh slot's device.  A mesh may name one device in several slots: that
is how a (2, 4) mesh runs on one card or on the CPU, as the reference
runs its meshes on forced host devices.  No process group is involved.

Language models (`Mesh`, `make_mesh`): the reference's parallelism map,

  DP    batch over (pod, data)
  FSDP  the d_model side of every weight over data (ZeRO-3-style)
  TP    heads / ff / vocab / experts over model
  SP    decode KV/latent caches over model, and over (data, model) when
        the decode batch cannot fill the data axis

decides where every leaf is *stored* (`distributed.placement`).  Each
data slot runs its rows; over ``model`` its attention, dense MLP,
embedding and head products split as their weights' pieces lie
(`nn.common.tp_product`), with the residual stream on the data slot's
device, while the MoE FFN, MLA and the recurrent mixers run with their
weights gathered onto it.  `make_rules`, `sanitize_spec`,
`sanitized_shardings` and the batch specs are the reference's, line for
line, over the port's own `PartitionSpec` and `NamedSharding`.

Filter banks (`BankMesh`, `bank_mesh`): filters over ``bank``, channels
or time over ``data``; `partition_bank` and `BankPartition` are the
reference's, line for line, so the port and `repro` cut a bank into the
same shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..nn.common import map_tree, map_trees

__all__ = ["BANK_AXIS", "DATA_AXIS", "BankMesh", "BankPartition", "Mesh",
           "NamedSharding", "PartitionSpec", "bank_filter_costs",
           "bank_mesh", "batch_axes", "batch_pspec", "batch_shardings",
           "data_axes", "data_size", "make_mesh", "make_rules",
           "mesh_bank_shape", "named_sharding", "partition_bank",
           "sanitize_spec", "sanitized_shardings", "tree_shardings"]

BANK_AXIS = "bank"
DATA_AXIS = "data"


# ---------------------------------------------------------------------------
# the language-model mesh, its specs and shardings
# ---------------------------------------------------------------------------


class PartitionSpec:
    """One mesh-axis entry a dimension: ``None`` (replicated), an axis
    name, or a tuple of axis names (the dimension split over their
    product, row-major).  Iterates, indexes and compares as the tuple of
    its entries, as JAX's does; missing trailing entries mean ``None``."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(tuple(e) if isinstance(e, list) else e
                              for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of `torch.device` slots with named axes.

    ``devices`` is an object ndarray of the mesh's shape; a device may
    fill several slots.  ``shape`` maps the axis names to their sizes and
    ``size`` is the slot count, as JAX's ``Mesh`` has them."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, coord: dict):
        """The device of the slot at ``coord`` (axis → index; missing
        axes at 0)."""
        return self.devices[tuple(coord.get(a, 0) for a in self.axis_names)]


def make_mesh(shape, names, devices=None) -> Mesh:
    """A mesh of ``shape`` with axes ``names`` over ``devices`` (names or
    `torch.device`, row-major).  By default the visible CUDA devices,
    and a loud error without one — never a quiet fall back to the CPU;
    one device may fill several slots (``devices=["cpu"] * 8``).  CPU,
    CUDA and ``meta`` slots (a shape-only mesh) are never mixed."""
    import torch

    shape = tuple(int(n) for n in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} vs axis names {names}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh() spans the visible GPUs; pass "
                "devices=['cpu', ...] to build a mesh of CPU slots")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_slot_device(d) for d in devices]
    need = math.prod(shape)
    if need < 1 or need > len(devices):
        raise ValueError(f"a {shape} mesh needs {need} devices, "
                         f"have {len(devices)}")
    devices = devices[:need]
    if len({d.type for d in devices}) > 1:
        raise ValueError("a mesh holds CUDA, CPU or meta slots, not a mix")
    grid = np.empty(need, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), names)


def _slot_device(d):
    import torch

    from ..kernels.runtime import resolve_device

    dev = torch.device(d)
    return dev if dev.type == "meta" else resolve_device(dev)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def batch_axes(rules: dict | None) -> tuple[str, ...]:
    """The mesh axes the rules split the batch over (the port's data
    slots run their rows), as a tuple."""
    e = (rules or {}).get("batch")
    return () if e is None else tuple(e) if isinstance(e, tuple) else (e,)


def make_rules(mesh: Mesh, kind: str = "train",
               global_batch: int | None = None) -> dict[str, Any]:
    """Logical-axis rules for one execution cell."""
    daxes: Any = data_axes(mesh)
    if len(daxes) == 1:
        daxes = daxes[0]
    rules: dict[str, Any] = {
        "batch": daxes,
        "seq": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "heads_flat": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "expert_ff": None,
        "d_model": "data",  # FSDP
        "state": None,
        "layers": None,
        "cache_seq": None,
    }
    if kind == "decode":
        rules["cache_seq"] = "model"
        if global_batch is not None and global_batch < data_size(mesh):
            # batch can't fill the data axis (long-context, batch=1):
            # shard the cache sequence across everything instead
            rules["batch"] = None
            rules["cache_seq"] = (
                ("pod", "data", "model") if "pod" in mesh.axis_names
                else ("data", "model")
            )
    if kind in ("prefill", "decode"):
        # FSDP is a *training* memory trick: at inference, weights are
        # read-only — replicating them over `data` removes a full-model
        # all-gather per step
        rules["d_model"] = None
    return rules


def named_sharding(mesh: Mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _axis_size(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def sanitize_spec(mesh: Mesh, spec: PartitionSpec,
                  shape: tuple[int, ...]) -> PartitionSpec:
    """Drop mesh axes that do not divide their dim: a placement must be
    even.  E.g. kv_heads=2 cannot shard over model=4 → replicated."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return PartitionSpec(*out)


def sanitized_shardings(mesh: Mesh, pspec_tree, shape_tree,
                        tp_fallback_axis: str | None = None):
    """NamedShardings with divisibility enforcement, leaf-wise
    (``shape_tree``'s leaves: anything with a ``.shape``).

    ``tp_fallback_axis``: when a weight ends up with NO use of that mesh
    axis (its TP dim wasn't divisible — e.g. 56 heads on a 16-way axis),
    shard its largest divisible dim instead (the row-parallel layout the
    reference picks for inference)."""

    def one(s, sh):
        shape = tuple(sh.shape)
        spec = sanitize_spec(mesh, s, shape)
        if tp_fallback_axis is not None:
            used = {a for e in spec if e
                    for a in (e if isinstance(e, tuple) else (e,))}
            if tp_fallback_axis not in used and len(shape) >= 2:
                size = mesh.shape[tp_fallback_axis]
                cands = [(dim, i) for i, (dim, e) in
                         enumerate(zip(shape, spec))
                         if e is None and dim % size == 0 and dim >= size]
                if cands:
                    _, idx = max(cands)
                    entries = list(spec)
                    entries[idx] = tp_fallback_axis
                    spec = PartitionSpec(*entries)
        return NamedSharding(mesh, spec)

    return map_trees(one, pspec_tree, shape_tree)


def tree_shardings(mesh: Mesh, pspecs) -> Any:
    return map_tree(lambda s: NamedSharding(mesh, s), pspecs)


def batch_pspec(mesh: Mesh, rules: dict, ndim: int) -> PartitionSpec:
    """Sharding for a (B, S, ...) input batch leaf."""
    return PartitionSpec(rules.get("batch"), *([None] * (ndim - 1)))


def batch_shardings(mesh: Mesh, rules: dict, batch_tree) -> Any:
    return map_tree(
        lambda leaf: NamedSharding(
            mesh, batch_pspec(mesh, rules, len(leaf.shape))),
        batch_tree)


# ---------------------------------------------------------------------------
# the FIR filter-bank mesh and partition
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class BankMesh:
    """An ``(n_bank, n_data)`` grid of `torch.device` slots.

    ``devices[r][j]`` is the device of bank row ``r``, data slot ``j``;
    ``shape`` maps the axis names to their sizes (as JAX's ``Mesh.shape``
    does) and ``size`` is the slot count.
    """

    devices: tuple  # n_bank tuples of n_data torch.device

    @property
    def shape(self) -> dict:
        return {BANK_AXIS: len(self.devices), DATA_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return sum(len(row) for row in self.devices)


def bank_mesh(n_bank: int | None = None, n_data: int = 1,
              devices=None) -> BankMesh:
    """(bank, data) mesh for sharded filter-bank serving.

    ``devices`` lists the slots' devices in row-major order (names or
    `torch.device`; one device may fill several slots); by default every
    visible CUDA device, and a loud error without one — never a quiet
    fall back to the CPU.  ``n_bank`` defaults to the devices given
    divided by ``n_data``.  A 1×1 mesh is valid: `ShardedFilterBankEngine`
    then runs the single-device path.
    """
    from ..kernels.runtime import resolve_device

    if devices is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: bank_mesh() spans the visible GPUs; pass "
                "devices=['cpu', ...] to build a mesh of CPU slots")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_data < 1:
        raise ValueError("n_data must be >= 1")
    if n_bank is None:
        n_bank = max(1, len(devices) // n_data)
    need = n_bank * n_data
    if n_bank < 1 or need > len(devices):
        raise ValueError(f"bank_mesh needs {need} devices ({n_bank}×{n_data}), "
                         f"have {len(devices)}")
    if len({d.type for d in devices[:need]}) > 1:
        raise ValueError("a bank mesh holds CUDA slots or CPU slots, not both")
    return BankMesh(tuple(tuple(devices[r * n_data:(r + 1) * n_data])
                          for r in range(n_bank)))


def mesh_bank_shape(mesh: BankMesh) -> tuple[int, int]:
    """(n_bank, n_data) of a bank mesh; axes it lacks count as size 1."""
    return mesh.shape.get(BANK_AXIS, 1), mesh.shape.get(DATA_AXIS, 1)


@dataclass(frozen=True)
class BankPartition:
    """Filter → bank-shard assignment with caller-order restoration baked in.

    ``assign[s]`` holds the ORIGINAL indices of the filters served by
    shard ``s`` (occupancy-sorted within the shard, so each shard's
    `plan_bank_schedule` sees a homogeneous run).  ``inv`` maps an
    original filter index to its row in the shard-major concatenation of
    per-shard outputs — reassembly is one host-side index permutation.
    ``cost[s]`` is the predicted per-shard work the balancer equalized.
    """

    assign: tuple
    inv: np.ndarray
    cost: np.ndarray

    @property
    def n_shards(self) -> int:
        return len(self.assign)

    @property
    def imbalance(self) -> float:
        """max/mean per-shard predicted cost — 1.0 is a perfect balance."""
        mean = float(self.cost.mean())
        return float(self.cost.max()) / mean if mean > 0 else 1.0


def bank_filter_costs(packed: np.ndarray, taps: int) -> np.ndarray:
    """(B,) predicted per-filter work: BLMAC pulses + the symmetric folds
    (the paper's §3.3 add count, read off the packed trit words)."""
    from ..core.csd import packed_pulse_counts

    return packed_pulse_counts(packed).astype(np.float64) + taps // 2


def partition_bank(
    packed: np.ndarray,
    n_shards: int,
    taps: int,
    cost: np.ndarray | None = None,
    sig: np.ndarray | None = None,
) -> BankPartition:
    """Occupancy-balanced contiguous partition of a packed bank.

    Filters are sorted by layer-occupancy signature (the order
    `plan_bank_schedule` uses), then the sorted run is cut into
    ``n_shards`` contiguous spans of balanced cumulative cost, so every
    shard stays occupancy-homogeneous and no dense shard straggles.
    Shards may carry unequal filter counts; ``n_shards`` is clamped to
    the bank size.  ``cost``/``sig`` let a `BlmacProgram` supply its
    precomputed per-filter costs and signatures.
    """
    from ..core.csd import occupancy_signatures

    packed = np.asarray(packed)
    n_filters = packed.shape[0]
    if n_filters == 0:
        raise ValueError("cannot partition an empty bank")
    n_shards = max(1, min(int(n_shards), n_filters))
    if cost is None:
        cost = bank_filter_costs(packed, taps)
    cost = np.asarray(cost, np.float64)
    if sig is None:
        sig = occupancy_signatures(packed.any(axis=-1))
    order = np.argsort(sig, kind="stable")
    csum = np.cumsum(cost[order])
    total = csum[-1]
    if total <= 0:  # all-zero bank: fall back to equal counts
        bounds = [round(n_filters * s / n_shards) for s in range(n_shards + 1)]
    else:
        bounds = [0]
        for s in range(1, n_shards):
            target = total * s / n_shards
            cut = int(np.searchsorted(csum, target))
            # every shard keeps >= 1 filter and cuts stay monotonic
            cut = min(max(cut, bounds[-1] + 1), n_filters - (n_shards - s))
            bounds.append(cut)
        bounds.append(n_filters)
    assign = tuple(order[bounds[s]: bounds[s + 1]] for s in range(n_shards))
    inv = np.empty(n_filters, np.int64)
    inv[np.concatenate(assign)] = np.arange(n_filters)
    shard_cost = np.array([cost[a].sum() for a in assign])
    return BankPartition(assign=assign, inv=inv, cost=shard_cost)
