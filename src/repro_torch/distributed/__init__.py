"""Distributed substrate of the port: the language model's mesh of
device slots, its sharding rules and the (bank, data) mesh and bank
partition (`sharding`), tensors placed on a mesh and the slot
collectives of the data-parallel step (`placement`), the halo exchange of a
time-sharded stream and the int8-compressed data-parallel all-reduce
(`collectives`), the fault taxonomy, injector, watchdog and counters
(`faultbank`) and the fault-tolerant train loop (`fault`) — the parts of
`repro.distributed` the port has taken, without JAX."""
from .collectives import (compressed_psum, compressed_psum_tree,
                          halo_exchange_left, make_compressed_dp_grad_fn)
from .faultbank import (
    DeadlineExceeded,
    FaultInjector,
    FaultStats,
    PendingInvalidated,
    RetriesExhausted,
    ShardCorruption,
    ShardError,
    ShardHealth,
    ShardLost,
    ShardTimeout,
    SimulatedFailure,
    StragglerStats,
    TransientShardError,
)
from .placement import (TRAFFIC, ShardedTensor, all_reduce_sum, device_put,
                        gather, reset_traffic, sync_replicas)
from .sharding import (
    BANK_AXIS,
    DATA_AXIS,
    BankMesh,
    BankPartition,
    Mesh,
    NamedSharding,
    PartitionSpec,
    bank_filter_costs,
    bank_mesh,
    batch_pspec,
    batch_shardings,
    data_axes,
    data_size,
    make_mesh,
    make_rules,
    mesh_bank_shape,
    named_sharding,
    partition_bank,
    sanitize_spec,
    sanitized_shardings,
    tree_shardings,
)

__all__ = [
    "BANK_AXIS",
    "BankMesh",
    "BankPartition",
    "DATA_AXIS",
    "DeadlineExceeded",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "ShardedTensor",
    "TRAFFIC",
    "FaultInjector",
    "FaultStats",
    "PendingInvalidated",
    "RetriesExhausted",
    "ShardCorruption",
    "ShardError",
    "ShardHealth",
    "ShardLost",
    "ShardTimeout",
    "SimulatedFailure",
    "StragglerStats",
    "TrainLoop",
    "TransientShardError",
    "all_reduce_sum",
    "bank_filter_costs",
    "bank_mesh",
    "batch_pspec",
    "batch_shardings",
    "data_axes",
    "data_size",
    "device_put",
    "gather",
    "make_mesh",
    "make_rules",
    "named_sharding",
    "reset_traffic",
    "sanitize_spec",
    "sanitized_shardings",
    "sync_replicas",
    "tree_shardings",
    "compressed_psum",
    "compressed_psum_tree",
    "halo_exchange_left",
    "make_compressed_dp_grad_fn",
    "mesh_bank_shape",
    "partition_bank",
]


def __getattr__(name):
    # the train loop imports `training`, which imports `placement`: load it
    # when asked for, so that importing `training` first finds no cycle
    if name == "TrainLoop":
        from .fault import TrainLoop

        return TrainLoop
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
