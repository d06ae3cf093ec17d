"""Device selection and the autotuned bank dispatch.

`repro`'s ``interpret=``/``lane=``/``compiled=`` arguments have no
counterpart here: the tensor's device chooses.  A CPU tensor runs a
kernel's plain PyTorch version; a CUDA tensor launches the kernel.  The
public entry points take ``device=None`` meaning *the GPU*: with no CUDA
device present that is a loud error, never a quiet run on the host —
pass ``device="cpu"`` to ask for the plain versions.

`autotune_bank_dispatch` is the reference's dispatch planner: it sweeps
``(mode, tile, bank_tile, merge)`` candidates through the cost model
(`repro_torch.core.costmodel`) and returns the winning
`BankDispatchPlan` with its `BankSchedule`, keeps an LRU cache keyed on
the program's digest, and accepts or declines a CSE-optimized program
against its parent.  Where the reference takes ``compiled=`` and
``interpret=``, the port takes a ``device``: a CPU device plans with the
reference's ``"interpret"`` constants (the reference's ``compiled=False``
plan, field for field); a CUDA device with the ``"cuda"`` lane's
constants fitted on that card, where a failed probe raises.

`autotune_sharded_dispatch` is the reference's mesh-aware planner: it
sweeps bank-shard counts and the data axis's use over a (bank, data)
mesh, plans every candidate shard with the single-device sweep above,
and scores the candidates with the critical-path model
(`predict_sharded_us`).  On the CPU its plans equal the reference's
``compiled=False`` plans field for field.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..compiler.cache import STATS as _COMPILER_STATS

__all__ = ["DEFAULT_TILE", "MERGE_CANDIDATES", "SPECIALIZE_BANK_MAX",
           "as_device_tensor", "autotune_bank_dispatch",
           "autotune_sharded_dispatch", "dispatch_candidates",
           "resolve_device"]

# output samples per signal tile of the streaming engine (the reference's
# default, kept so both engines frame a stream identically)
DEFAULT_TILE = 512

# The reference's cap on banks that may dispatch per filter (there, each
# filter compiles its own program).  K2 takes any number of filters in one
# launch, so on the card the cap is a choice to price against the measured
# K1/K2 crossover, not a bound; it stays the reference's for now.
SPECIALIZE_BANK_MAX = 32
MERGE_CANDIDATES = (1, 4, 8)
# The reference's measured tile lookup for its interpreter (a cache cliff
# of its blocked accumulate): 256 for wide scheduled tiles, else 512.
WIDE_BANK_TILE = 128


def _default_tile(mode: str, bank_tile: int) -> int:
    return 256 if mode == "scheduled" and bank_tile >= WIDE_BANK_TILE \
        else DEFAULT_TILE


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device, raising when there is none;
    otherwise ``torch.device(device)``, which must be CPU or an existing
    CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but CUDA is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array, tensor or sequence) as a tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def _resolve_program(bank, taps):
    """Accept a `BlmacProgram` (preferred) or a packed operand + taps."""
    from ..compiler import BlmacProgram, compile_packed

    if isinstance(bank, BlmacProgram):
        if taps is not None and int(taps) != bank.taps:
            raise ValueError(f"program is {bank.taps}-tap, got taps={taps}")
        return bank
    if taps is None:
        raise ValueError("taps is required with a packed-operand bank")
    return compile_packed(np.ascontiguousarray(bank), int(taps))


def _lane_of(dev: torch.device):
    """The cost model's lane and constants for ``dev``: the reference's
    ``"interpret"`` set on the CPU, the ``"cuda"`` lane fitted on the card
    (at first use; a failed probe raises)."""
    from ..core.costmodel import (CUDA_LANE, REFERENCE_CALIBRATIONS,
                                  ensure_calibration)

    if dev.type == "cpu":
        return "interpret", REFERENCE_CALIBRATIONS["interpret"]
    return CUDA_LANE, ensure_calibration(CUDA_LANE, dev)


def autotune_bank_dispatch(
    bank,  # BlmacProgram, or (B, n_layers, n_words) uint32 packed operand
    taps: int | None = None,
    channels: int = 1,
    tile: int | None = None,
    chunk_hint: int = 2048,
    device=None,
):
    """Pick ``(mode, tile, bank_tile, merge)`` for a compiled bank.

    Evaluates the cost model over the candidate grid
    (`dispatch_candidates`) — the specialized path (banks of at most
    `SPECIALIZE_BANK_MAX` filters) against the scheduled path at each
    ``(bank_tile, merge)`` — and returns ``(plan, schedule)``: the winning
    `BankDispatchPlan` and, for scheduled mode, the `BankSchedule` it was
    priced with (``None`` for specialized mode).

    ``bank`` is a `BlmacProgram` or a packed operand (then ``taps`` is
    required).  ``chunk_hint`` is the expected samples per dispatch;
    ``tile`` defaults to the reference's lookup on the CPU and to
    `DEFAULT_TILE` on the card.  ``device`` (None: the GPU, raising
    without one) chooses the constants: the reference's on the CPU, the
    ``"cuda"`` lane fitted on the card.

    An `OptimizedProgram` (CSE pass output) is swept over its shared-row
    layout, the fold priced in, and compared with planning its parent:
    when the parent wins the plan carries ``cse="declined"`` with the
    parent's schedule (the engine then runs the parent, with the same
    outputs); otherwise ``cse="optimized"``.  LRU-cached on the program's
    digest and the call's arguments.
    """
    from ..core.costmodel import CUDA_LANE

    program = _resolve_program(bank, taps)
    dev = resolve_device(device)
    lane, cal = _lane_of(dev)
    key = (program.key, channels, tile, chunk_hint, lane,
           cal.device_name if lane == CUDA_LANE else "")
    if key in _AUTOTUNE_CACHE:
        _AUTOTUNE_CACHE.move_to_end(key)
        _COMPILER_STATS["autotune"].hit()
        return _AUTOTUNE_CACHE[key]
    _COMPILER_STATS["autotune"].miss()
    result = dispatch_candidates(program, channels, tile, chunk_hint,
                                 device=dev)[0]
    if program.combine is not None:
        parent_plan, parent_sched = autotune_bank_dispatch(
            program.parent, channels=channels, tile=tile,
            chunk_hint=chunk_hint, device=dev,
        )
        opt_plan, opt_sched = result
        if parent_plan.predicted_us < opt_plan.predicted_us:
            result = (dataclasses.replace(parent_plan, cse="declined"),
                      parent_sched)
        else:
            result = (dataclasses.replace(opt_plan, cse="optimized"),
                      opt_sched)
    _AUTOTUNE_CACHE[key] = result
    while len(_AUTOTUNE_CACHE) > _AUTOTUNE_CACHE_MAX:
        _AUTOTUNE_CACHE.popitem(last=False)
    return result


_AUTOTUNE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_AUTOTUNE_CACHE_MAX = 16  # schedules hold compacted bank copies: keep few


def dispatch_candidates(program, channels: int = 1, tile: int | None = None,
                        chunk_hint: int = 2048, device=None,
                        allow_specialized: bool = True) -> list:
    """Every candidate the planner weighs for ``program`` (as it stands:
    no CSE comparison), cheapest first, as ``(plan, schedule)`` pairs;
    ties keep the reference's sweep order.  On the CPU the reference's
    interpret sweep: merges `MERGE_CANDIDATES`, its tile lookup.  On the
    card the ``"cuda"`` lane: K1 flattens a schedule back to its layers,
    so ``merge`` changes neither its work nor its output and the sweep
    keeps `MERGE_DEFAULT`; the tile is `DEFAULT_TILE`.
    ``allow_specialized=False`` leaves K2 out (the sharded planner's
    all-scheduled policy)."""
    from ..compiler import MERGE_DEFAULT, default_bank_tile
    from ..core.costmodel import BankDispatchPlan

    dev = resolve_device(device)
    lane, cal = _lane_of(dev)
    n_filters = program.n_filters

    def n_tiles(t):
        return max(1, -(-chunk_hint // t))

    cands = []
    if allow_specialized and n_filters <= SPECIALIZE_BANK_MAX:
        t = tile or _default_tile("specialized", 1)
        us = program.predict_specialized_us(channels, n_tiles(t), cal=cal,
                                            tile=t)
        cands.append((BankDispatchPlan("specialized", t, 1, 1, us, lane),
                      None))
    bank_tiles = {default_bank_tile(n_filters)}
    if n_filters > 8:
        bank_tiles.add(min(default_bank_tile(n_filters), 32))
    merges = MERGE_CANDIDATES if lane == "interpret" else (MERGE_DEFAULT,)
    for bt in sorted(bank_tiles):
        for merge in merges:
            schedule = program.schedule(bt, merge)
            t = tile or (_default_tile("scheduled", bt)
                         if lane == "interpret" else DEFAULT_TILE)
            us = program.predict_scheduled_us(channels, n_tiles(t), t, bt,
                                              merge, cal=cal)
            cands.append((BankDispatchPlan("scheduled", t, bt, merge, us,
                                           lane), schedule))
    # stable: equal predictions keep the sweep's order, as the reference's
    # strict `<` keeps the first
    return sorted(cands, key=lambda c: c[0].predicted_us)


# ---------------------------------------------------------------------------
# mesh-aware sharded dispatch planning
# ---------------------------------------------------------------------------


def autotune_sharded_dispatch(
    bank,  # BlmacProgram, or (B, n_layers, n_words) uint32 packed operand
    taps: int | None = None,
    channels: int = 1,
    mesh_shape: "tuple[int, int]" = (1, 1),
    tile: int | None = None,
    chunk_hint: int = 2048,
    force_shards: int | None = None,
    force_data: str | None = None,
    device=None,
):
    """Plan a bank dispatch over an (n_bank, n_data) mesh.

    Sweeps the bank-shard count over {1, 2, 4, …, n_bank} (the program's
    memoized `partition`s), plans every candidate shard — the program's
    memoized `select()` subprogram, the object the sharded engine then
    runs — with the single-device sweep (`dispatch_candidates`, the data
    slot's share of the chunk as its amortization knob), and scores each
    candidate with `predict_sharded_us`.  The unsharded plan competes in
    the same sweep, so ``n_bank_shards == 1`` means sharding does not pay.

    Returns ``(plan, partition, schedules)``: the winning
    `ShardedBankPlan`, its `BankPartition`, and one `BankSchedule` (or
    ``None`` for a specialized shard) per shard.  ``force_shards`` pins
    the shard count; ``force_data`` pins the data axis's use to
    ``"none"``, ``"channels"`` or ``"time"`` (an unavailable mode raises
    ``ValueError``).  ``device`` (None: the GPU, raising without one)
    chooses the constants as in `autotune_bank_dispatch`; the host's
    dispatch cost is priced per launch: on the CPU the reference's (one
    call per tile group with layers, one per filter and channel of a
    specialized shard), on the card one K1 or K2 launch per data slot.

    An `OptimizedProgram` plans its augmented bank (``.bank``; the fold
    runs once on the reassembled result: on the CPU priced at the
    reference's constants, as its host fold; on the card as the fold
    kernel's launch) against its parent, and the winner carries
    ``cse="optimized"`` or ``cse="declined"``.  LRU-cached with
    `autotune_bank_dispatch`'s plans.
    """
    from ..core.costmodel import CUDA_LANE

    program = _resolve_program(bank, taps)
    dev = resolve_device(device)
    lane, cal = _lane_of(dev)
    n_bank, n_data = int(mesh_shape[0]), int(mesh_shape[1])
    key = ("sharded", program.key, channels, n_bank, n_data, tile,
           chunk_hint, force_shards, force_data, lane,
           cal.device_name if lane == CUDA_LANE else "")
    if key in _AUTOTUNE_CACHE:
        _AUTOTUNE_CACHE.move_to_end(key)
        _COMPILER_STATS["autotune"].hit()
        return _AUTOTUNE_CACHE[key]
    _COMPILER_STATS["autotune"].miss()
    args = (channels, n_bank, n_data, tile, chunk_hint, force_shards,
            force_data, dev)
    if program.combine is not None:
        result = _sharded_cse_compare(program, *args)
    else:
        result = _autotune_sharded(program, *args)
    _AUTOTUNE_CACHE[key] = result
    while len(_AUTOTUNE_CACHE) > _AUTOTUNE_CACHE_MAX:
        _AUTOTUNE_CACHE.popitem(last=False)
    return result


def _sharded_cse_compare(program, channels, n_bank, n_data, tile,
                         chunk_hint, force_shards, force_data, dev):
    """Sharded plan of an `OptimizedProgram`: its augmented bank plus the
    fold after reassembly, against its parent; the winner's ``cse`` field
    says which program's rows the partition describes."""
    from ..core.costmodel import CUDA_LANE, predict_combine_us

    opt_plan, opt_part, opt_scheds = _autotune_sharded(
        program.bank, channels, n_bank, n_data, tile, chunk_hint,
        force_shards, force_data, dev)
    # one fold over the reassembled chunk: the reference's host fold on
    # the CPU, the fold kernel's launch over every output on the card
    t = opt_plan.shard_plans[0].tile
    n_tiles = max(1, -(-chunk_hint // t))
    lane, cal = _lane_of(dev)
    if lane == CUDA_LANE:
        combine_us = predict_combine_us(
            program.n_real, program.n_shared, channels, n_tiles, t, cal=cal,
            nnz=program.nnz,
            entries=program.fold_entries(channels, n_tiles * t, cal))
    else:
        combine_us = predict_combine_us(program.n_real, program.n_shared,
                                        channels, n_tiles, t)
    opt_plan = dataclasses.replace(
        opt_plan, predicted_us=opt_plan.predicted_us + combine_us,
        cse="optimized")
    parent = _autotune_sharded(
        program.parent, channels, n_bank, n_data, tile, chunk_hint,
        force_shards, force_data, dev)
    if parent[0].predicted_us < opt_plan.predicted_us:
        return (dataclasses.replace(parent[0], cse="declined"),) + parent[1:]
    return opt_plan, opt_part, opt_scheds


def _shard_candidates(n_bank: int, n_filters: int) -> "list[int]":
    """Bank-shard counts to sweep: powers of two up to the axis, the axis
    itself, all clamped to the bank size."""
    cands = {1}
    c = 2
    while c < n_bank:
        cands.add(c)
        c *= 2
    cands.add(n_bank)
    return sorted({min(c, n_filters) for c in cands})


def _autotune_sharded(program, channels, n_bank, n_data, tile, chunk_hint,
                      force_shards, force_data, dev):
    from ..core.costmodel import (CUDA_LANE, PALLAS_CALL_US, SPEC_CALL_US,
                                  ShardedBankPlan, predict_sharded_us)

    lane, cal = _lane_of(dev)
    if lane == CUDA_LANE:
        call_us, spec_us = cal.call_us, cal.spec_call_us
    else:
        call_us, spec_us = PALLAS_CALL_US, SPEC_CALL_US
    taps = program.taps
    n_filters = program.n_filters
    # the data axis used (channels when C divides it, else time slices
    # with a halo exchange) or left idle: the sweep may decline either axis
    data_cands = [(1, "none", channels, chunk_hint)]
    if n_data > 1:
        if channels % n_data == 0:
            data_cands.append(
                (n_data, "channels", channels // n_data, chunk_hint))
        else:
            data_cands.append(
                (n_data, "time", channels, max(taps, -(-chunk_hint // n_data))))
    if force_data is not None:
        data_cands = [c for c in data_cands if c[1] == force_data]
        if not data_cands:
            raise ValueError(
                f"data mode {force_data!r} is not available on a "
                f"({n_bank}, {n_data}) mesh with {channels} channel(s)")
    if force_shards is not None:
        candidates = [max(1, min(int(force_shards), n_bank, n_filters))]
    else:
        candidates = _shard_candidates(n_bank, n_filters)
    best = None  # (ShardedBankPlan, partition, schedules)
    for nd, data_mode, chan_local, chunk_local in data_cands:
        for n_shards in candidates:
            part = program.partition(n_shards)
            # each shard's free pick, and all-scheduled: only the sharded
            # objective sees that specialized shards load the one host
            policies = (True, False) if data_mode == "none" else (False,)
            for allow_spec in policies:
                plans, schedules, costs, host = [], [], [], []
                for rows in part.assign:
                    sub = program.select(rows)  # memoized shard subprogram
                    plan, schedule = dispatch_candidates(
                        sub, chan_local, tile, chunk_local, device=dev,
                        allow_specialized=allow_spec)[0]
                    plans.append(plan)
                    schedules.append(schedule)
                    costs.append(plan.predicted_us)
                    if lane == CUDA_LANE:  # one launch a data slot
                        host.append(nd * (spec_us if plan.mode ==
                                          "specialized" else call_us))
                    elif plan.mode == "specialized":
                        host.append(len(rows) * chan_local * spec_us)
                    else:
                        host.append(sum(1 for g in schedule.groups
                                        if g.sel_layers) * call_us)
                if allow_spec and not any(
                        p.mode == "specialized" for p in plans):
                    continue  # identical to the all-scheduled variant
                us = predict_sharded_us(costs, nd, data_mode, host_us=host)
                if n_shards == 1 and nd == 1:
                    us = plans[0].predicted_us  # the true unsharded baseline
                if best is None or us < best[0].predicted_us:
                    best = (ShardedBankPlan(n_shards, nd, data_mode,
                                            tuple(plans), us),
                            part, tuple(schedules))
    return best
