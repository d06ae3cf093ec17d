"""The filter-bank half of `repro.distributed.sharding`: the (bank, data)
serving mesh and the occupancy-balanced partition of a bank over it.

JAX's mesh is one process driving every device through `shard_map`; its
counterpart here is one process that keeps each shard's tensors on its
mesh slot's device (`BankMesh`).  A mesh may name one device in several
slots: that is how a (4, 2) mesh runs on one card or on the CPU, as the
reference runs its meshes on forced host devices.  No process group is
involved: the engine dispatches every slot from the calling thread.

`partition_bank` and `BankPartition` are the reference's, line for line,
so the port and `repro` cut a bank into the same shards.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["BANK_AXIS", "DATA_AXIS", "BankMesh", "BankPartition",
           "bank_filter_costs", "bank_mesh", "mesh_bank_shape",
           "partition_bank"]

BANK_AXIS = "bank"
DATA_AXIS = "data"


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
