"""Sharded filter-bank serving substrate of the port: the (bank, data)
mesh of device slots and the bank partition (`sharding`), the halo
exchange of a time-sharded stream (`collectives`) and the fault
taxonomy, injector, watchdog and counters (`faultbank`) — the filter-bank
parts of `repro.distributed`, without JAX."""
from .collectives import halo_exchange_left
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
    "TransientShardError",
    "bank_filter_costs",
    "bank_mesh",
    "halo_exchange_left",
    "mesh_bank_shape",
    "partition_bank",
]
