"""The port's compile pipeline: one `BlmacProgram` per bank.

A numpy copy of the parts of `repro.compiler` the filter-bank path needs
(no JAX, no import of `repro`), with the reference's content key and
on-disk formats, so programs and tail snapshots move between the two
packages unchanged:

  * `compile_bank` / `compile_packed` / `program_from_arrays` —
    content-addressed compilation,
  * `BlmacProgram` — the artifact (schedules and pulse tuples memoized
    on it), `save()` / `load()`,
  * `plan_bank_schedule` / `BankSchedule` / `superlayer_schedule` — the
    pack-time scheduler,
  * `cse_pass` / `OptimizedProgram` — cross-filter common-subexpression
    elimination (shared 2-term rows plus a combine matrix),
  * `lower` / `Lowered` / `BACKENDS` — one program, one executable per
    backend (the numpy oracle, K1, K2, the §4 vmachine),
  * `cache_stats` / `clear_caches` — the cache observability point,
  * `TailSnapshot` — overlap-save stream state, keyed to its program.
"""
from .cache import cache_stats, clear_caches
from .lowering import BACKENDS, Lowered, lower
from .optimize import OptimizedProgram, cse_pass
from .program import (BlmacProgram, CompileSpec, PROGRAM_FORMAT_VERSION,
                      ProgramFormatError, compile_bank, compile_packed,
                      program_from_arrays)
from .schedule import (BankSchedule, MAX_BANK_TILE, MERGE_DEFAULT, TileGroup,
                       default_bank_tile, plan_bank_schedule,
                       superlayer_schedule)
from .state import STATE_FORMAT_VERSION, SnapshotFormatError, TailSnapshot

__all__ = [
    "BACKENDS",
    "BankSchedule",
    "BlmacProgram",
    "CompileSpec",
    "Lowered",
    "MAX_BANK_TILE",
    "MERGE_DEFAULT",
    "OptimizedProgram",
    "PROGRAM_FORMAT_VERSION",
    "ProgramFormatError",
    "STATE_FORMAT_VERSION",
    "SnapshotFormatError",
    "TailSnapshot",
    "TileGroup",
    "cache_stats",
    "clear_caches",
    "compile_bank",
    "compile_packed",
    "cse_pass",
    "default_bank_tile",
    "lower",
    "plan_bank_schedule",
    "program_from_arrays",
    "superlayer_schedule",
]
