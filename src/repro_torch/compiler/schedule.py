"""Bank-wide sparsity scheduling: the pack-time half of the compile pipeline.

The port's copy of `repro.compiler.schedule`, unchanged in behaviour:
`plan_bank_schedule` turns a packed-trit bank into a `BankSchedule` — the
occupancy-sorted filter permutation plus per-tile-group *superlayer*
programs, from which `repro_torch.kernels.blmac_fir.bank_terms` builds
the bank kernel's tables (`repro_torch/kernels/csrc/blmac_bank.cu`).  The tests hold every field of the plan
equal to the reference's, so both packages schedule a bank identically.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.csd import occupancy_signatures
from ..tracing import spanned
from .cache import _bump

__all__ = [
    "MERGE_DEFAULT",
    "MAX_BANK_TILE",
    "TileGroup",
    "BankSchedule",
    "superlayer_schedule",
    "plan_bank_schedule",
    "default_bank_tile",
]

MAX_BANK_TILE = 256  # the reference's cap; kept so the plans agree

# CSD layers fused per superlayer contraction; 1 recovers the paper-pure
# one-contraction-per-bit-layer kernel.  The reference's default, kept so
# both packages plan the same schedule for the same bank.
MERGE_DEFAULT = 8


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def default_bank_tile(n_filters: int) -> int:
    """Bank-tile heuristic: whole bank in one tile up to the cap;
    above the cap, size the tile so the padded bank tracks n_filters
    (257 filters → 2 tiles of 136, not 2 tiles of 256)."""
    n = max(n_filters, 1)
    if n <= MAX_BANK_TILE:
        return _pad_to(n, 8)
    n_tiles = -(-n // MAX_BANK_TILE)
    return _pad_to(-(-n // n_tiles), 8)


def superlayer_schedule(
    populated: tuple[int, ...], merge: int
) -> tuple[tuple, int, tuple[int, ...]]:
    """Compile a populated-layer set into a static Horner schedule.

    ``populated`` are the bit-layer indices holding ≥1 pulse anywhere in
    the bank tile.  Greedy MSB-first, layers within a span of ``merge``
    positions fuse into one superlayer (digit values then span
    ±(2^merge − 1), still far inside int32 given the pack-time bound).

    Returns ``(schedule, tail_shift, sel_layers)``:
      * ``schedule`` — tuple of ``(shift_in, ((sel_idx, rel_weight), …))``
        entries, MSB first, flattened into the bank kernel's table;
      * ``tail_shift`` — final left shift down to layer 0;
      * ``sel_layers`` — the packed-layer indices to gather, MSB first
        (``sel_idx`` indexes this tuple).
    """
    if merge < 1:
        raise ValueError("merge must be >= 1")
    layers = sorted((int(lyr) for lyr in populated), reverse=True)
    if not layers:
        return (), 0, ()
    runs: list[list[int]] = [[layers[0]]]
    for lyr in layers[1:]:
        if runs[-1][0] - lyr < merge:  # span (hi − lo) stays < merge
            runs[-1].append(lyr)
        else:
            runs.append([lyr])
    schedule = []
    sel_layers: list[int] = []
    prev_lo = None
    for run in runs:  # each run: descending layer indices
        lo = run[-1]
        shift_in = 0 if prev_lo is None else prev_lo - lo
        parts = tuple(
            (len(sel_layers) + i, lyr - lo) for i, lyr in enumerate(run)
        )
        sel_layers.extend(run)
        schedule.append((shift_in, parts))
        prev_lo = lo
    return tuple(schedule), prev_lo, tuple(sel_layers)


@dataclass(frozen=True)
class TileGroup:
    """A run of consecutive (post-sort) bank tiles sharing one compiled
    schedule — dispatched as one bank-kernel launch."""

    schedule: tuple  # static Horner program (see superlayer_schedule)
    tail_shift: int
    sel_layers: tuple[int, ...]  # packed layer indices gathered, MSB first
    packed: np.ndarray  # (n_tiles * bank_tile, n_sel, n_words) uint32
    n_filters: int  # valid (non-pad) rows covered by this group


@dataclass(frozen=True)
class BankSchedule:
    """Pack-time product of `plan_bank_schedule`: occupancy-sorted filter
    permutation + per-group layer-skip schedules."""

    tile_size: int  # bank_tile
    merge: int
    perm: np.ndarray  # (B,) original index of the filter in permuted slot p
    inv: np.ndarray  # (B,) permuted slot of original filter b
    groups: tuple[TileGroup, ...]
    n_filters: int

    @property
    def n_superlayers(self) -> int:
        """Total scheduled matmuls per grid step, summed over groups —
        the quantity the dense kernel fixed at n_layers per tile."""
        return sum(len(g.schedule) for g in self.groups)

    def group_summaries(self) -> "list[tuple[int, int, int, int]]":
        """One ``(n_bank_tiles, bank_tile, n_superlayers, n_sel_layers)``
        tuple per tile group — the shape `predict_scheduled_us` costs."""
        return [
            (
                g.packed.shape[0] // self.tile_size,
                self.tile_size,
                len(g.schedule),
                len(g.sel_layers),
            )
            for g in self.groups
        ]


@spanned("build.schedule")
def plan_bank_schedule(
    packed: np.ndarray,
    bank_tile: int | None = None,
    merge: int = MERGE_DEFAULT,
) -> BankSchedule:
    """Sort a packed bank into occupancy-homogeneous tiles and compile a
    layer-skip schedule per tile group.

    Filters are ordered by their layer-occupancy signature (a bitmask of
    populated layers), partitioned into ``bank_tile`` rows, and each
    tile's schedule is built from the UNION occupancy of its rows — so a
    tile of truncated / low-precision / narrow-band filters never pays
    for layers only its neighbours populate.  Consecutive tiles with an
    identical schedule fuse into one kernel launch (one `TileGroup`).
    A tile whose union is empty (all-zero filters) is scheduled as a
    constant zero block — no kernel runs at all.

    Prefer `BlmacProgram.schedule()` when you hold a compiled program:
    it memoizes this call per ``(bank_tile, merge)``.
    """
    _bump("schedule_plans")
    packed = np.asarray(packed)
    n_filters, n_layers, n_words = packed.shape
    if bank_tile is None:
        bank_tile = default_bank_tile(n_filters)
    occ = packed.any(axis=-1)  # (B, L) bool: layer populated in filter b
    sig = occupancy_signatures(occ)
    perm = np.argsort(sig, kind="stable")
    inv = np.empty(n_filters, np.int64)
    inv[perm] = np.arange(n_filters)
    b_pad = _pad_to(n_filters, bank_tile)
    occ_p = np.zeros((b_pad, n_layers), bool)
    occ_p[:n_filters] = occ[perm]
    packed_p = np.zeros((b_pad, n_layers, n_words), packed.dtype)
    packed_p[:n_filters] = packed[perm]

    groups: list[TileGroup] = []
    run_tiles: list[int] = []  # tile indices of the open run
    run_key = None
    n_tiles = b_pad // bank_tile

    def close_run():
        if not run_tiles:
            return
        schedule, tail_shift, sel_layers = run_key
        lo = run_tiles[0] * bank_tile
        hi = (run_tiles[-1] + 1) * bank_tile
        sel = (
            packed_p[lo:hi][:, list(sel_layers), :]
            if sel_layers
            else packed_p[lo:hi, :0, :]
        )
        groups.append(
            TileGroup(
                schedule=schedule,
                tail_shift=tail_shift,
                sel_layers=sel_layers,
                packed=np.ascontiguousarray(sel),
                n_filters=min(hi, n_filters) - min(lo, n_filters),
            )
        )

    for ti in range(n_tiles):
        union = occ_p[ti * bank_tile : (ti + 1) * bank_tile].any(axis=0)
        key = superlayer_schedule(tuple(np.nonzero(union)[0]), merge)
        if key != run_key:
            close_run()
            run_tiles = []
            run_key = key
        run_tiles.append(ti)
    close_run()
    return BankSchedule(
        tile_size=bank_tile,
        merge=merge,
        perm=perm,
        inv=inv,
        groups=tuple(groups),
        n_filters=n_filters,
    )
