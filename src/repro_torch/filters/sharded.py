"""Sharded filter-bank serving: BLMAC banks over a (bank, data) mesh.

The port of `repro.filters.sharded`.  `ShardedFilterBankEngine`
partitions a (B filters × C channels) bank over a `BankMesh` of device
slots (`repro_torch.distributed.bank_mesh`):

  * **bank axis** — filters, assigned by the program's memoized
    `partition` (occupancy-sorted, cost-balanced); every shard runs its
    own `select()` subprogram on its own mesh row: one K1 launch for all
    its tile groups (`bank_schedule_apply` over the shard's `bank_terms`),
    or one K2 launch for all its filters and channels (a
    `SpecializedProgram`).
  * **data axis** — channels when ``C`` divides the axis, otherwise time
    slices of the chunk with an overlap-save halo exchange
    (`halo_exchange_left`): each data slot of a row launches the shard's
    kernel once on its own slice.

Whether sharding pays is the mesh-aware planner's call
(`autotune_sharded_dispatch`): a narrow bank or a short chunk comes back
with ``n_bank_shards == 1``.

`push_async` pads the chunk to the plan's quantum, uploads it once per
distinct device of the mesh, launches every shard and returns a
`PendingChunk` holding the shards' output tensors on their devices — no
copy to the host.  `PendingChunk.result()` gathers the shards' blocks on
the first shard's device (each dispatch owns its output tensors, so a
later push never overwrites a pending one), restores the caller's filter
order there (`BankPartition.inv`) and copies the result back once.  A
bank given with a ``combine`` matrix (the augmented bank of a
CSE-optimized program) has its shared rows folded into its real rows on
that device by the fold kernel (`combine_fold`) before the copy back.

**Fault tolerance** (`repro_torch.distributed.faultbank`): every push
captures a `TailSnapshot`, the host state that makes the chunk
replayable.  A lost shard (a raised `ShardLost`, or the `ShardHealth`
watchdog's timeout) removes its mesh row; the bank is re-partitioned
over the surviving slots (which may repeat a device), the shard count
chosen by `predict_recovery_us`, and every in-flight chunk is replayed
from its snapshot, so the resumed stream is bit-exact with an
uninterrupted one.  A mesh down to one slot falls back to the plain
`FilterBankEngine` of the same program on the survivor.  Corrupted
blocks (the optional integrity probe) are replayed in place and escalate
to loss when they persist; transient errors re-arm the chunk and
propagate for `repro_torch.serving.AsyncBankServer`'s retry.  Counters
surface through ``fault_stats()``.

Every mesh shape agrees with `fir_bit_layers_batch` and with the
reference engine to the last bit on integer inputs.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..distributed.collectives import halo_exchange_left
from ..distributed.faultbank import (FaultStats, PendingInvalidated,
                                     ShardCorruption, ShardError, ShardHealth,
                                     ShardLost, ShardTimeout,
                                     TransientShardError)
from ..distributed.sharding import (BankPartition, BankMesh, bank_mesh,
                                    mesh_bank_shape)

__all__ = ["ShardedFilterBankEngine", "PendingChunk"]


class PendingChunk:
    """In-flight outputs of one `push_async`: per-shard lists of device
    tensors (one a data slot), the reassembly recipe and the chunk's
    replay material (tail snapshot + raw samples).  `result()` copies the
    blocks to the host and is where faults are detected and recovered:
    a lost shard triggers the engine's re-partition and replay, a
    corrupted block is replayed in place, a transient error re-arms the
    chunk and propagates for the server's retry loop."""

    def __init__(self, engine, shard_outs, inv, n_out, offsets,
                 n_filters, channels, snapshot=None, chunk=None,
                 chunk_idx=0):
        self._engine = engine
        self._shard_outs = shard_outs
        self._inv = inv
        self._offsets = offsets
        self.n_out = int(n_out)
        self._shape = (n_filters, channels)
        self._resolved = None
        self._invalid = False
        self.snapshot = snapshot
        self.chunk = chunk
        self.chunk_idx = int(chunk_idx)
        self._heals = 0  # corruption replays consumed on this chunk

    def _rearm(self, shard_outs, offsets, inv) -> None:
        """Swap in a replay's fresh dispatch (possibly from a different
        partition after a recovery re-partition)."""
        self._shard_outs = shard_outs
        self._offsets = offsets
        self._inv = inv

    def invalidate(self) -> None:
        """Mark the chunk unusable (engine reset / terminal failure):
        `result()` will raise `PendingInvalidated`, and the engine stops
        tracking it for replay."""
        self._invalid = True
        self._shard_outs = None
        self.snapshot = None
        self.chunk = None
        eng = self._engine
        if eng is not None and self in eng._inflight:
            eng._inflight.remove(self)

    def result(self) -> np.ndarray:
        """Block until the chunk's outputs are ready → int32 (B, C, n_out).

        Raises `PendingInvalidated` if the engine's stream state moved
        on, re-raises `TransientShardError` after re-arming the chunk
        (the server retries), and raises `ShardLost` only when recovery
        found no surviving slot."""
        if self._resolved is not None:
            return self._resolved
        if self._invalid:
            raise PendingInvalidated(
                "engine stream state moved on before this chunk resolved "
                "(reset() or a terminal failure) — its shard outputs are "
                "stale and will not be reassembled"
            )
        b, c = self._shape
        if self.n_out <= 0:
            self._resolved = np.zeros((b, c, 0), np.int32)
            return self._resolved
        eng = self._engine
        while True:
            try:
                out = eng._materialize(self)
                break
            except ShardCorruption as e:
                eng.fault.detections += 1
                eng.fault.corruptions += 1
                self._heals += 1
                if self._heals > eng.max_heals:
                    # persistent corruption == a lying shard: treat as lost
                    eng._recover(ShardLost(
                        e.shard,
                        f"shard {e.shard}: corruption persisted after "
                        f"{eng.max_heals} replays",
                    ))
                else:
                    eng._replay_one(self)
            except TransientShardError:
                eng.fault.detections += 1
                eng.fault.transients += 1
                eng._replay_one(self)  # re-arm so the next attempt is fresh
                raise
            except ShardLost as e:
                eng._recover(e)  # re-partitions + replays, or re-raises
        self._resolved = np.ascontiguousarray(out)
        self._shard_outs = None  # free the device tensors + replay material
        self.snapshot = None
        self.chunk = None
        if eng is not None and self in eng._inflight:
            eng._inflight.remove(self)
        return self._resolved


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array (a copy from a CUDA device,
    made under that device's guard: the calling thread may be a
    watchdog's worker)."""
    if t.device.type != "cuda":
        return t.numpy()
    with torch.cuda.device(t.device):
        return t.cpu().numpy()


@dataclasses.dataclass
class _Shard:
    """One bank shard's dispatch: ``run(uploads, n)`` launches its kernels
    on the padded chunk already on each device and returns its output
    tensors, one a data slot, to be joined along ``axis`` and cut at
    ``offset``; ``devices`` are the slots' devices."""

    run: object
    offset: int
    axis: int
    devices: tuple


class ShardedFilterBankEngine:
    """Overlap-save streaming FIR bank sharded over a (bank, data) mesh.

    Parameters
    ----------
    qbank : (B, taps) or (taps,) int array, or `BlmacProgram`
        Quantized odd symmetric (type-I) coefficients, compiled once via
        `compile_bank`; a prebuilt or `load()`ed program warm-starts.
        Shard subprograms are the program's memoized `select()` slices,
        shared with the mesh planner.
    channels : int
        Independent input channels C (all filtered by every filter).
    mesh : BankMesh | None
        The (bank, data) mesh of device slots (`bank_mesh`); ``None``
        builds an (n_cards, 1) mesh over every visible CUDA device and
        raises without one.  A 1×1 mesh runs the single-device path.
    n_bank_shards : int | None
        Force the filter-shard count (clamped to the mesh's bank axis);
        ``None`` lets the planner pick, 1 included.
    data_mode : {"none", "channels", "time"} | None
        Force how the data axis is used; ``None`` lets the planner pick.
    tile, merge, chunk_hint
        As `FilterBankEngine`; each shard's mode and tile are planned
        unless ``tile`` pins them.
    fault_injector : FaultInjector | None
        Deterministic chaos hooks (tests and benchmarks), consulted on
        every shard dispatch and materialize.
    shard_timeout : float | None
        Hard per-shard materialize deadline in seconds, escalated to
        `ShardTimeout` → shard loss; ``None`` disables it.
    integrity_check : bool
        Recompute boundary output positions of every shard block on the
        host and raise `ShardCorruption` on a mismatch.
    straggler_factor : float
        `ShardHealth` slow-shard multiple over the running median.
    combine : (n_real, n_shared) int array | None
        The bank's last ``n_shared`` rows are shared rows of a
        CSE-optimized program (`OptimizedProgram.bank` and ``.combine``):
        they are sharded like any row, folded into the first ``n_real``
        rows at reassembly, and the engine returns those ``n_real`` rows.
    """

    def __init__(
        self,
        qbank,
        channels: int = 1,
        mesh: BankMesh | None = None,
        n_bank_shards: int | None = None,
        data_mode: str | None = None,
        tile: int | None = None,
        merge: int | None = None,
        chunk_hint: int = 2048,
        fault_injector=None,
        shard_timeout: float | None = None,
        integrity_check: bool = False,
        straggler_factor: float = 3.0,
        combine=None,
    ):
        from ..compiler import BlmacProgram, compile_bank

        if isinstance(qbank, BlmacProgram):
            program = qbank
        else:
            # float input is truncated, not quantized (the reference's
            # contract): pass floats through `compile_bank`
            program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if mesh is None:
            mesh = bank_mesh()
        self.program = program
        self.qbank = program.qbank
        self.n_filters = program.n_filters
        self.taps = program.taps
        self.channels = int(channels)
        self._halo = self.taps - 1
        self._combine = None
        self.n_out_filters = self.n_filters
        if combine is not None:
            self._combine = np.asarray(combine, np.int64)
            if (self._combine.ndim != 2
                    or sum(self._combine.shape) != self.n_filters):
                raise ValueError(
                    f"combine {self._combine.shape} does not fold "
                    f"{self.n_filters} rows")
            self.n_out_filters = self._combine.shape[0]
        # construction preferences, reused by every recovery re-configure
        self._force_bank = n_bank_shards
        self._force_data = data_mode
        self._tile_arg = tile
        self._merge_arg = merge
        self._chunk_hint = chunk_hint
        self.injector = fault_injector
        self.shard_timeout = shard_timeout
        self.integrity_check = bool(integrity_check)
        self._straggler_factor = float(straggler_factor)
        self.max_heals = 2  # corruption replays per chunk before loss
        self.fault = FaultStats()
        self._plain = None  # set when degraded to the unsharded engine
        self._inflight: list[PendingChunk] = []
        self._chunk_idx = 0
        self._configure(mesh)
        # overlap-save state: the last taps-1 samples of every channel
        self._tail = np.zeros((channels, 0), np.int32)
        self.samples_in = 0
        self.samples_out = 0

    # -- construction helpers ----------------------------------------------

    def _configure(self, mesh: BankMesh, force_shards: int | None = None):
        """(Re)build the mesh-dependent half of the engine: plan,
        partition, per-shard dispatch, chunk quantum and the watchdog.
        Called at construction and by `_recover` with the survivors."""
        from ..kernels.runtime import autotune_sharded_dispatch

        n_bank, n_data = mesh_bank_shape(mesh)
        if n_bank * n_data != mesh.size:
            raise ValueError(f"mesh must be (bank, data)-shaped, got "
                             f"{mesh.shape}")
        force = force_shards if force_shards is not None else self._force_bank
        if force is not None:
            force = max(1, min(int(force), n_bank, self.n_filters))
        self.plan, self.partition, schedules = autotune_sharded_dispatch(
            self.program, channels=self.channels, mesh_shape=(n_bank, n_data),
            tile=self._tile_arg, chunk_hint=self._chunk_hint,
            force_shards=force, force_data=self._force_data,
            device=mesh.devices[0][0],
        )
        if self._merge_arg is not None:
            # re-plan the scheduled shards whose merge differs, keeping each
            # shard's bank tile; predicted_us keeps the planner's estimate
            merge = self._merge_arg
            schedules = tuple(
                self.program.select(rows).schedule(sched.tile_size, merge)
                if sched is not None and sched.merge != merge else sched
                for rows, sched in zip(self.partition.assign, schedules)
            )
            self.plan = dataclasses.replace(
                self.plan,
                shard_plans=tuple(
                    dataclasses.replace(p, merge=merge)
                    if p.mode == "scheduled" else p
                    for p in self.plan.shard_plans
                ),
            )
        self.mesh = mesh
        self.n_bank_shards = self.plan.n_bank_shards
        self.n_data = self.plan.n_data
        self.data_mode = self.plan.data_mode
        # chunk lengths are quantized to a multiple of every shard's tile;
        # time sharding also needs the ×n_data factor (each slot's slice
        # must be tile-aligned and cover the halo it sends rightwards)
        self._quantum = max(p.tile for p in self.plan.shard_plans)
        if self.data_mode == "time":
            self._quantum *= self.n_data
            while self._quantum // self.n_data < self._halo:
                self._quantum *= 2
        self._device_rows = [list(row) for row in mesh.devices]
        self._shards = [
            self._build_shard(self.program.select(rows), plan, schedules[s],
                              mesh.devices[s % n_bank][:self.n_data])
            for s, (rows, plan) in enumerate(
                zip(self.partition.assign, self.plan.shard_plans))
        ]
        self.health = ShardHealth(
            len(self._shards), timeout=self.shard_timeout,
            straggler_factor=self._straggler_factor,
        )

    def _configure_degraded(self, device) -> None:
        """Last-resort recovery target: one surviving slot.  The same
        program runs through the plain `FilterBankEngine` on ``device``
        (its planned packed or specialized path), as one shard."""
        from ..core.costmodel import BankDispatchPlan, ShardedBankPlan
        from .bank import FilterBankEngine

        plain = FilterBankEngine(
            self.program, channels=self.channels, tile=self._tile_arg,
            merge=self._merge_arg, chunk_hint=self._chunk_hint, device=device,
        )
        self._plain = plain
        plan1 = plain.dispatch_plan
        if plan1 is None:
            plan1 = BankDispatchPlan(
                mode=plain.mode, tile=plain.tile,
                bank_tile=plain.bank_tile or 0, merge=plain.merge,
                predicted_us=float("nan"),
            )
        self.plan = ShardedBankPlan(1, 1, "none", (plan1,),
                                    plan1.predicted_us)
        self.n_bank_shards, self.n_data, self.data_mode = 1, 1, "none"
        b = self.n_filters
        self.partition = BankPartition(
            assign=(np.arange(b),), inv=np.arange(b),
            cost=np.asarray([float(self.program.filter_costs.sum())]),
        )
        self._quantum = plain.tile
        self._device_rows = None
        self.mesh = None

        def run_plain(ups, n):
            # the engine's own framing and launch, without its copy back
            return [plain._run(*plain._frame(ups[plain.device][:, :n]))]

        self._shards = [_Shard(run_plain, 0, 2, (plain.device,))]
        self.health = ShardHealth(
            1, timeout=self.shard_timeout,
            straggler_factor=self._straggler_factor,
        )
        self.fault.degraded_since = time.perf_counter()

    def _build_shard(self, subprogram, plan, schedule, devs) -> _Shard:
        """One bank shard's dispatch over its row's data slots ``devs``:
        K2 for a specialized shard (one slot by construction), else K1 on
        the whole chunk, on a channel group per slot, or on a time slice
        per slot after the halo exchange."""
        from ..kernels.blmac_fir import (SpecializedProgram,
                                         bank_schedule_apply, bank_terms,
                                         frame_signal_batch, specialized_call)

        taps, tile = self.taps, plan.tile
        if plan.mode == "specialized":
            dev = devs[0]
            spec = SpecializedProgram(subprogram.pulse_schedules(), taps,
                                      tile, dev)

            def run_specialized(ups, n):
                frames, n_out = frame_signal_batch(ups[dev][:, :n], taps,
                                                   tile)
                y = specialized_call(frames, spec)  # (B_s, C, n_tiles, tile)
                return [y.reshape(y.shape[0], y.shape[1], -1)[:, :, :n_out]]

            return _Shard(run_specialized, 0, 2, (dev,))

        # the shard's K1 tables, built and uploaded once per device
        terms = {d: bank_terms(schedule, taps, d) if d.type == "cuda"
                 else None for d in devs}

        def k1(x, dev):
            frames, n_out = frame_signal_batch(x, taps, tile)
            return bank_schedule_apply(frames, schedule, taps, tile, n_out,
                                       terms=terms[dev])

        if self.n_data == 1:
            dev = devs[0]

            def run_single(ups, n):
                return [k1(ups[dev][:, :n], dev)]

            return _Shard(run_single, 0, 2, (dev,))

        nd, halo = self.n_data, self._halo
        if self.data_mode == "channels":
            per = self.channels // nd

            def run_channels(ups, n):
                return [k1(ups[d][j * per:(j + 1) * per, :n], d)
                        for j, d in enumerate(devs)]

            return _Shard(run_channels, 0, 1, tuple(devs))

        def run_time(ups, n):
            # each slot's slice of the padded chunk, widened by its left
            # neighbour's halo: a self-contained overlap-save window whose
            # outputs are exactly its own samples
            width = ups[devs[0]].shape[1] // nd
            parts = halo_exchange_left(
                [ups[d][:, j * width:(j + 1) * width]
                 for j, d in enumerate(devs)], halo)
            return [k1(x, d) for x, d in zip(parts, devs)]

        # slot 0's halo is zero fill: the first taps − 1 joined outputs are
        # warm-up, trimmed at reassembly
        return _Shard(run_time, halo, 2, tuple(devs))

    # -- streaming API ------------------------------------------------------

    def push_async(self, chunk) -> PendingChunk:
        """Feed (C, n) samples (or (n,) when C == 1); launches every bank
        shard on its mesh row and returns without waiting for the device
        work: the returned `PendingChunk` holds the outputs on their
        devices and a `TailSnapshot` of the pre-push stream state, so the
        chunk can be replayed through a recovered mesh."""
        chunk = np.asarray(chunk.cpu() if torch.is_tensor(chunk) else chunk)
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        if chunk.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got {chunk.shape[0]}"
            )
        idx = self._chunk_idx
        self._chunk_idx += 1
        snap = self.snapshot_tail()
        chunk_i = chunk.astype(np.int32)
        self.samples_in += chunk.shape[1]
        buf = np.concatenate([self._tail, chunk_i], axis=1)
        n = buf.shape[1]
        if n < self.taps:  # still priming
            self._tail = buf
            return PendingChunk(
                self, [], self.partition.inv, 0, [],
                self.n_out_filters, self.channels,
                snapshot=snap, chunk=chunk_i, chunk_idx=idx,
            )
        self._tail = buf[:, n - self._halo:] if self._halo else buf[:, :0]
        n_out = n - self.taps + 1
        outs, offsets = self._dispatch_shards(buf, n, idx)
        self.samples_out += n_out
        p = PendingChunk(
            self, outs, self.partition.inv, n_out, offsets,
            self.n_out_filters, self.channels,
            snapshot=snap, chunk=chunk_i, chunk_idx=idx,
        )
        self._inflight.append(p)
        return p

    def _upload(self, buf: np.ndarray) -> dict:
        """``buf`` padded to the chunk quantum, copied once to every
        distinct device of the shards: {device: (C, n_pad) int32}."""
        n_pad = -(-buf.shape[1] // self._quantum) * self._quantum
        host = torch.from_numpy(np.ascontiguousarray(
            np.pad(buf, ((0, 0), (0, n_pad - buf.shape[1])))))
        devices = {d for sh in self._shards for d in sh.devices}
        return {d: host.to(d) for d in devices}

    def _dispatch_shards(self, buf, n, chunk_idx):
        """Upload the chunk and launch every shard.  A dispatch-time
        `ShardError` (injected or real) is stored in the shard's output
        slot instead of raised: detection and recovery happen at
        `result()`, so `push_async` never blocks on them."""
        ups = self._upload(buf)
        outs, offsets = [], []
        for s, shard in enumerate(self._shards):
            try:
                if self.injector is not None:
                    self.injector.on_dispatch(s, chunk_idx)
                y = shard.run(ups, n)
            except ShardError as e:
                if e.shard is None:
                    e.shard = s
                y = e
            outs.append(y)
            offsets.append(shard.offset)
        return outs, offsets

    def push(self, chunk) -> np.ndarray:
        """Synchronous `push_async` → int32 (B, C, n_out)."""
        return self.push_async(chunk).result()

    def __call__(self, chunk) -> np.ndarray:
        return self.push(chunk)

    def apply_lanes(self, buf) -> np.ndarray:
        """Stateless one-shot bank application over ``channels`` lanes:
        (C, n) int samples with ``n >= taps`` → (B, C, n − taps + 1),
        leaving the overlap-save tail and the stream counters alone.

        The dispatch goes through the same fault path as `push` (its
        replay material is the buffer itself, with an empty tail), so a
        shard lost mid-call is recovered and the call returns the
        recovered result; a `TransientShardError` propagates after the
        pending is invalidated."""
        from ..compiler.state import TailSnapshot

        buf = np.asarray(buf.cpu() if torch.is_tensor(buf) else buf, np.int32)
        if buf.ndim != 2 or buf.shape[0] != self.channels:
            raise ValueError(
                f"expected ({self.channels}, n) lane buffer, "
                f"got shape {buf.shape}"
            )
        if buf.shape[1] < self.taps:
            raise ValueError(
                f"lane buffer has {buf.shape[1]} samples, "
                f"need >= taps ({self.taps})"
            )
        idx = self._chunk_idx
        self._chunk_idx += 1
        # empty-tail snapshot + the raw buffer == complete replay material
        snap = TailSnapshot(
            program_key=self.program.key, channels=self.channels,
            samples_in=0, samples_out=0,
            tail=np.zeros((self.channels, 0), np.int32),
        )
        n = buf.shape[1]
        n_out = n - self.taps + 1
        outs, offsets = self._dispatch_shards(buf, n, idx)
        p = PendingChunk(
            self, outs, self.partition.inv, n_out, offsets,
            self.n_out_filters, self.channels,
            snapshot=snap, chunk=buf, chunk_idx=idx,
        )
        self._inflight.append(p)
        try:
            return p.result()
        except Exception:
            p.invalidate()
            raise

    def reset(self) -> None:
        """Drop all buffered history (start a new stream).  Outstanding
        `PendingChunk`s are invalidated: their ``result()`` raises
        `PendingInvalidated`."""
        for p in list(self._inflight):
            p.invalidate()
        self._inflight = []
        self._tail = np.zeros((self.channels, 0), np.int32)
        self.samples_in = 0
        self.samples_out = 0
        self._chunk_idx = 0

    @property
    def pending(self) -> int:
        """Samples buffered but not yet old enough to finish a window."""
        return self._tail.shape[1]

    # -- tail snapshot / restore (content-addressed stream state) -----------

    def snapshot_tail(self):
        """Freeze the overlap-save stream state as a `TailSnapshot` keyed
        to this engine's program digest (the reference's format)."""
        from ..compiler.state import TailSnapshot

        return TailSnapshot(
            program_key=self.program.key, channels=self.channels,
            samples_in=self.samples_in, samples_out=self.samples_out,
            tail=self._tail.copy(),
        )

    def restore_tail(self, snapshot) -> None:
        """Adopt a `TailSnapshot` captured on this program (validated by
        content key and channels).  Outstanding pendings are invalidated
        first (`reset` semantics)."""
        if snapshot.program_key != self.program.key:
            raise ValueError(
                f"snapshot belongs to program {snapshot.program_key[:12]}…, "
                f"this engine runs {self.program.key[:12]}…"
            )
        if int(snapshot.channels) != self.channels:
            raise ValueError(
                f"snapshot has {snapshot.channels} channels, "
                f"engine has {self.channels}"
            )
        self.reset()
        self._tail = np.asarray(snapshot.tail, np.int32).copy()
        self.samples_in = int(snapshot.samples_in)
        self.samples_out = int(snapshot.samples_out)

    # -- fault detection / recovery -----------------------------------------

    def _materialize(self, p: PendingChunk) -> np.ndarray:
        """Assemble one pending chunk; raises the first shard fault it
        detects (stored dispatch errors, watchdog timeout, integrity-probe
        corruption).  The reference's reassembly, the shard-major
        concatenation permuted by ``inv``, made on the first shard's
        device (the shared rows folded there too), then one copy back."""
        from ..kernels.blmac_fir import combine_fold, combine_table

        parts = []
        for s, (y, off) in enumerate(zip(p._shard_outs, p._offsets)):
            if isinstance(y, ShardError):
                raise y
            parts.append(self._materialize_shard(s, p, y, off))
        dev = parts[0].device
        y = (parts[0] if len(parts) == 1
             else torch.cat([t.to(dev) for t in parts]))
        y = y.index_select(0, torch.as_tensor(p._inv, device=dev))
        if self._combine is not None:
            y = combine_fold(y, combine_table(self._combine, dev))
        return _to_host(y)

    def _materialize_shard(self, s, p, y, off):
        """Shard ``s``'s block of pending chunk ``p`` as a (B_s, C, n_out)
        tensor, its data slots joined on the first slot's device and its
        device work waited for under the watchdog; then the injected
        corruption and the integrity probe."""
        inj = self.injector
        n_out = p.n_out
        axis = self._shards[s].axis
        abandoned = threading.Event()

        def read():
            if inj is not None:
                inj.on_materialize(s, p.chunk_idx)
            if abandoned.is_set():  # the watchdog gave up on this read
                return None
            dev = y[0].device
            full = (y[0] if len(y) == 1
                    else torch.cat([t.to(dev) for t in y], dim=axis))
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            return full[:, :, off: off + n_out]

        t0 = time.perf_counter()
        if self.health.timeout is not None:
            part = self._with_timeout(read, s, abandoned)
        else:
            part = read()
        if self.health.record(s, time.perf_counter() - t0):
            self.fault.stragglers += 1
        if inj is not None:
            part = inj.corrupt(s, p.chunk_idx, part)
        if self.integrity_check:
            self._verify_part(s, part, p)
        return part

    def _with_timeout(self, fn, s, abandoned: threading.Event):
        """Run one shard materialize under the `ShardHealth` deadline;
        expiry escalates to `ShardTimeout` (→ loss).  The worker thread is
        abandoned, not joined, and ``abandoned`` tells it to skip its copy
        once it wakes, so no late device read is left pending."""
        from concurrent.futures import ThreadPoolExecutor
        from concurrent.futures import TimeoutError as FuturesTimeout

        ex = ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(fn)
            try:
                return fut.result(timeout=self.health.timeout)
            except FuturesTimeout:
                abandoned.set()
                raise ShardTimeout(
                    s, f"shard {s} exceeded the {self.health.timeout:.3f}s "
                       f"watchdog timeout"
                ) from None
        finally:
            ex.shutdown(wait=False)

    def _verify_part(self, s, part, p):
        """Boundary integrity probe: recompute this shard's outputs at
        t = 0, the last output and every data-slot boundary on the host
        (int64 dot products over the snapshot tail + raw chunk, exact:
        16-bit coefficients × 32-bit samples × 255 taps stay below 2**54)
        and compare bit for bit modulo 2**32, the kernels' arithmetic
        contract: an output that wrapped is not corruption."""
        rows = self.partition.assign[s]
        full = np.concatenate(
            [np.asarray(p.snapshot.tail, np.int64),
             np.asarray(p.chunk, np.int64)], axis=1,
        )
        n_out = p.n_out
        pos = {0, n_out - 1}
        for j in range(1, self.n_data):
            pos.add(min(max(j * n_out // self.n_data, 0), n_out - 1))
        pos = sorted(pos)
        wins = np.stack([full[:, t: t + self.taps] for t in pos])  # (P,C,taps)
        # astype wraps int64 to int32 (two's complement, modulo 2**32)
        expect = np.einsum("rj,pcj->rpc", self.qbank[rows], wins) \
            .astype(np.int32)
        got = _to_host(part[:, :, pos]).astype(np.int32).transpose(0, 2, 1)
        if not np.array_equal(got, expect):
            raise ShardCorruption(
                s, f"shard {s} failed the boundary integrity probe on "
                   f"chunk {p.chunk_idx}"
            )

    def _recover(self, err: ShardLost) -> None:
        """Handle a detected shard loss: drop the dead mesh row,
        re-partition the bank over the surviving slots (shard count by
        modelled cost), rebuild the dispatch, and replay every in-flight
        chunk from its tail snapshot.  Raises `ShardLost` when no
        surviving slot remains."""
        self.fault.detections += 1
        if isinstance(err, ShardTimeout):
            self.fault.timeouts += 1
        s = err.shard
        rows = self._device_rows
        if self._plain is not None or rows is None or len(rows) <= 1:
            raise ShardLost(
                s, f"shard {s} lost with no surviving devices to "
                   f"re-partition onto: {err}"
            ) from err
        t0 = time.perf_counter()
        self.fault.lost_shards += 1
        if self.injector is not None:
            self.injector.on_shard_removed(s)
        del rows[s]
        n_bank = len(rows)
        n_data = len(rows[0])
        if n_bank == 1 and n_data == 1:
            self._configure_degraded(rows[0][0])
        else:
            devices = [d for row in rows for d in row]
            target = self._choose_recovery_shards(n_bank, n_data)
            self._configure(bank_mesh(n_bank, n_data, devices=devices),
                            force_shards=target)
        self._replay_inflight()
        self.fault.recoveries += 1
        self.fault.last_recovery_s = time.perf_counter() - t0

    def _choose_recovery_shards(self, n_bank: int, n_data: int) -> int:
        """The recovery target's bank-shard count by modelled cost
        (`predict_recovery_us`): the full surviving row count or the power
        of two below it, each paying for its fresh shard schedules and
        the in-flight replay, then its steady state over the horizon.  A
        caller-forced shard count short-circuits the sweep."""
        from ..core.costmodel import predict_recovery_us
        from ..kernels.runtime import autotune_sharded_dispatch

        if self._force_bank is not None:
            return max(1, min(int(self._force_bank), n_bank, self.n_filters))
        replay = sum(p.n_out for p in self._inflight)
        pow2 = 1
        while pow2 * 2 <= n_bank:
            pow2 *= 2
        best, best_us = None, float("inf")
        for cand in sorted({min(n_bank, self.n_filters),
                            min(pow2, self.n_filters)}):
            plan, _, schedules = autotune_sharded_dispatch(
                self.program, channels=self.channels,
                mesh_shape=(n_bank, n_data), tile=self._tile_arg,
                chunk_hint=self._chunk_hint, force_shards=cand,
                force_data=self._force_data, device=self._device_rows[0][0],
            )
            n_scheduled = sum(1 for sc in schedules if sc is not None)
            us = predict_recovery_us(plan.predicted_us, n_scheduled, replay)
            if us < best_us:
                best, best_us = cand, us
        return best

    def _replay_inflight(self) -> None:
        """Re-dispatch every unresolved chunk through the recovered mesh,
        oldest first, each from its own tail snapshot."""
        for p in list(self._inflight):
            self._replay_one(p)

    def _replay_one(self, p: PendingChunk) -> None:
        """Re-dispatch one pending chunk from its tail snapshot and swap
        the fresh shard outputs and the current partition's reassembly
        order into it."""
        buf = np.concatenate(
            [np.asarray(p.snapshot.tail, np.int32), p.chunk], axis=1
        )
        outs, offsets = self._dispatch_shards(buf, buf.shape[1], p.chunk_idx)
        p._rearm(outs, offsets, self.partition.inv)
        self.fault.replayed_chunks += 1
        self.fault.replayed_samples += p.n_out

    # -- introspection ------------------------------------------------------

    def fault_stats(self) -> dict:
        """JSON-ready fault and recovery counters (`FaultStats`) plus the
        live mesh shape, in-flight depth, injected-fault counts and the
        `ShardHealth` heartbeat summary."""
        d = self.fault.as_dict()
        d.update(
            n_bank_shards=self.n_bank_shards,
            n_data=self.n_data,
            data_mode=self.data_mode,
            inflight=len(self._inflight),
            injected=(
                self.injector.faults_injected()
                if self.injector is not None else None
            ),
            health=self.health.summary(),
        )
        return d

    def time_shards(self, chunk, repeats: int = 3) -> np.ndarray:
        """(n_shards,) best-of-``repeats`` seconds per bank shard for one
        ``chunk`` (already on its devices), each shard run alone, without
        touching the stream state: CUDA events around the shard's
        launches on the card (the longest of its devices), the host clock
        around the shard's work on the CPU.  Repeats go round-robin over
        the shards, so one slow spell does not spoil one shard's samples.
        """
        chunk = np.atleast_2d(np.asarray(chunk)).astype(np.int32)
        n = chunk.shape[1]
        if n < self.taps:
            raise ValueError("chunk shorter than the filter")
        ups = self._upload(chunk)

        def once(shard) -> float:
            cuda = sorted({d for d in shard.devices if d.type == "cuda"},
                          key=str)
            if not cuda:
                t0 = time.perf_counter()
                shard.run(ups, n)
                return time.perf_counter() - t0
            marks = {}
            for d in cuda:
                marks[d] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                with torch.cuda.device(d):
                    marks[d][0].record()
            shard.run(ups, n)
            for d in cuda:
                with torch.cuda.device(d):
                    marks[d][1].record()
            for d in cuda:
                torch.cuda.synchronize(d)
            return max(a.elapsed_time(b) for a, b in marks.values()) * 1e-3

        for shard in self._shards:  # warm-up: builds and first launches
            once(shard)
        times = np.full(len(self._shards), np.inf)
        for _ in range(repeats):
            for s, shard in enumerate(self._shards):
                times[s] = min(times[s], once(shard))
        return times

    def describe(self) -> str:
        """One line for logs: mesh, shard modes, balance, predicted cost."""
        modes = ",".join(p.mode[:4] for p in self.plan.shard_plans)
        degraded = " DEGRADED" if self._plain is not None else ""
        return (
            f"sharded-bank B={self.n_filters} C={self.channels} "
            f"mesh=({self.n_bank_shards}x{self.n_data}){degraded} "
            f"data={self.data_mode} modes=[{modes}] "
            f"imbalance={self.partition.imbalance:.2f} "
            f"predicted={self.plan.predicted_us:.0f}us"
        )
