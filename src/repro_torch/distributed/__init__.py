"""Distributed substrate of the port: the (bank, data) mesh of device
slots and the bank partition (`sharding`), the halo exchange of a
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
from .fault import TrainLoop
from .sharding import (
    BANK_AXIS,
    DATA_AXIS,
    BankMesh,
    BankPartition,
    bank_filter_costs,
    bank_mesh,
    mesh_bank_shape,
    partition_bank,
)

__all__ = [
    "BANK_AXIS",
    "BankMesh",
    "BankPartition",
    "DATA_AXIS",
    "DeadlineExceeded",
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
    "bank_filter_costs",
    "bank_mesh",
    "compressed_psum",
    "compressed_psum_tree",
    "halo_exchange_left",
    "make_compressed_dp_grad_fn",
    "mesh_bank_shape",
    "partition_bank",
]
