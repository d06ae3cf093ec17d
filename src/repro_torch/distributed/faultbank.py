"""Fault machinery for the sharded BLMAC filter-bank service — the
port's copy of `repro.distributed.faultbank` (numpy only, no JAX).

A replicated fleet of BLMAC machines only earns its keep if losing one
machine does not lose the stream.  This module is the shared substrate
for that:

  * the **error taxonomy** every layer speaks — `ShardLost` (permanent,
    the engine must re-partition), `TransientShardError` (the server
    retries with backoff), `ShardCorruption` (the engine replays the
    chunk), `ShardTimeout` (a watchdog escalation of loss), plus the
    caller-facing `PendingInvalidated` / `RetriesExhausted` /
    `DeadlineExceeded`,
  * a deterministic, test-driven `FaultInjector` — kill shard k at
    chunk n, delay shard k, fail a push transiently, corrupt a shard's
    output block — everything the chaos harness injects,
  * a `ShardHealth` watchdog: per-shard heartbeat wall-times through
    `StragglerStats` and an optional hard per-shard timeout that
    `ShardedFilterBankEngine` escalates to `ShardTimeout`,
  * `FaultStats` — the counter surface behind the engines' and server's
    ``fault_stats()``, next to the compiler's ``cache_stats()``.

Counters and injected faults are the reference's, name for name, so a
chaos run of either package reports the same ``fault_stats()``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = [
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
]


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class ShardError(RuntimeError):
    """Base of the shard-level fault taxonomy; carries the bank-shard
    index the fault was detected on (``None`` when no single shard is
    responsible, e.g. a server-side deadline)."""

    def __init__(self, shard: int | None = None, msg: str | None = None):
        super().__init__(msg or f"shard {shard} failed")
        self.shard = shard


class ShardLost(ShardError):
    """Permanent loss of a bank shard (dead device / repeated corruption
    escalation).  The engine's recovery path re-partitions the bank over
    the surviving mesh rows; re-raised only when no survivors remain."""


class ShardTimeout(ShardLost):
    """The `ShardHealth` hard timeout expired while materializing a
    shard's block — treated as a loss (the watchdog's escalation)."""


class TransientShardError(ShardError):
    """A retriable shard failure (queue hiccup, injected transient).
    The engine re-dispatches the chunk and re-raises; bounded
    retry/backoff is `AsyncBankServer`'s job."""


class ShardCorruption(ShardError):
    """A shard's output block failed the boundary integrity probe.  The
    engine replays the chunk from its tail snapshot; repeated corruption
    on the same chunk escalates to `ShardLost`."""


class PendingInvalidated(RuntimeError):
    """`PendingChunk.result()` after the engine's stream state moved on
    (``reset()`` while the push was in flight, or a terminal server
    failure already consumed it) — the shard outputs would reassemble a
    stale stream, so the error is loud instead."""


class RetriesExhausted(ShardError):
    """`AsyncBankServer` exceeded ``max_retries`` on one chunk; the
    chunk is dropped from the stream and the error propagates — never a
    hang."""


class DeadlineExceeded(ShardError):
    """`AsyncBankServer`'s per-push deadline elapsed before the chunk
    resolved."""


class SimulatedFailure(RuntimeError):
    """Injected process-level failure (train-loop ``fail_at`` and any
    other crash-the-world test hook)."""


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerStats:
    """Wall-time watchdog: records per-step (or per-shard-materialize)
    durations and flags steps slower than ``factor`` × the running
    median of the last 50.  Needs ≥ 5 samples before it will flag."""

    times: list[float] = dataclasses.field(default_factory=list)
    slow_steps: int = 0
    factor: float = 2.0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 5:
            med = float(np.median(self.times[-50:]))
            if dt > self.factor * med:
                self.slow_steps += 1
                return True
        return False


class ShardHealth:
    """Per-shard heartbeat watchdog for a sharded bank engine.

    One `StragglerStats` per bank shard records every materialize
    wall-time; ``timeout`` (seconds, ``None`` = disabled) is the hard
    per-shard deadline the engine enforces around materialization and
    escalates to `ShardTimeout` → `ShardLost`.  ``reset(n)`` rebuilds
    the per-shard series after a recovery re-partition (cumulative
    counters live in `FaultStats`, which survives resets)."""

    def __init__(self, n_shards: int, timeout: float | None = None,
                 straggler_factor: float = 3.0):
        self.timeout = timeout
        self.factor = straggler_factor
        self.reset(n_shards)

    def reset(self, n_shards: int) -> None:
        self.stats = [
            StragglerStats(factor=self.factor) for _ in range(n_shards)
        ]

    @property
    def n_shards(self) -> int:
        return len(self.stats)

    def record(self, shard: int, dt: float) -> bool:
        """Record one materialize wall-time; True if it straggled."""
        return self.stats[shard].record(dt)

    def summary(self) -> dict:
        """JSON-ready per-shard heartbeat summary."""
        return {
            "n_shards": len(self.stats),
            "timeout_s": self.timeout,
            "heartbeats": [len(s.times) for s in self.stats],
            "wall_s": [round(float(sum(s.times)), 6) for s in self.stats],
            "slow_steps": [s.slow_steps for s in self.stats],
        }


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultStats:
    """Cumulative fault counters for one engine (survives recovery
    re-partitions and `ShardHealth` resets).  ``as_dict()`` is the
    JSON-ready surface behind ``fault_stats()``:

      * ``detections`` — faults detected (losses + timeouts +
        corruptions + transients), each detection event once,
      * ``recoveries`` — successful re-partitions onto surviving rows
        (including the final degradation to the unsharded engine),
      * ``lost_shards`` / ``timeouts`` / ``corruptions`` /
        ``transients`` — per-kind detection counts,
      * ``replayed_chunks`` / ``replayed_samples`` — deterministic
        replays from tail snapshots (recovery and corruption heals),
      * ``stragglers`` — materializations flagged slow by `ShardHealth`,
      * ``degraded`` / ``degraded_s`` — whether the engine fell back to
        the single-device `FilterBankEngine`, and for how long.
    """

    detections: int = 0
    recoveries: int = 0
    lost_shards: int = 0
    timeouts: int = 0
    corruptions: int = 0
    transients: int = 0
    replayed_chunks: int = 0
    replayed_samples: int = 0
    stragglers: int = 0
    last_recovery_s: float = 0.0
    degraded_since: float | None = None

    def as_dict(self) -> dict:
        degraded = self.degraded_since is not None
        return {
            "detections": self.detections,
            "recoveries": self.recoveries,
            "lost_shards": self.lost_shards,
            "timeouts": self.timeouts,
            "corruptions": self.corruptions,
            "transients": self.transients,
            "replayed_chunks": self.replayed_chunks,
            "replayed_samples": self.replayed_samples,
            "stragglers": self.stragglers,
            "last_recovery_s": self.last_recovery_s,
            "degraded": degraded,
            "degraded_s": (
                time.perf_counter() - self.degraded_since if degraded else 0.0
            ),
        }


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Deterministic fault injection for `ShardedFilterBankEngine`.

    Faults are armed against **(bank-shard slot, chunk index)**:
    ``chunk`` counts `push_async` calls since engine construction (or
    the last ``reset()``), and ``shard`` means "whatever machine is
    serving bank-shard slot k when chunk n is dispatched" — after a
    recovery re-partition the surviving shards renumber from 0, and
    armed faults keep targeting the renumbered slots.  That makes a
    pre-armed kill grid read exactly like the test reasons about it:
    ``kill(1, 2); kill(1, 5)`` kills slot 1 of the original mesh at
    chunk 2 and slot 1 of the RECOVERED mesh at chunk 5.  When the
    engine removes a lost shard it calls `on_shard_removed`, which
    retires the fired kill so the slot's next occupant is not killed by
    the same corpse.

    All four fault kinds are pure functions of (shard, chunk) and the
    armed state — no randomness, no wall-clock reads — so a chaos grid
    replays identically every run:

      * `kill_shard(k, at_chunk=n)` — every dispatch of shard k for
        chunk ≥ n raises `ShardLost` until the engine removes the shard
        (a dead machine stays dead; chunks already in flight on it get
        replayed through the recovered mesh),
      * `delay_shard(k, at_chunk=n, seconds=t)` — shard k's materialize
        for chunk n sleeps t seconds first (drives the `ShardHealth`
        timeout / straggler paths),
      * `fail_push(k, at_chunk=n, times=m)` — the next m dispatch
        attempts of (k, n) raise `TransientShardError` (drives the
        server's retry/backoff),
      * `corrupt_output(k, at_chunk=n, times=m)` — shard k's
        materialized block for chunk n comes back element-wise damaged
        m times (drives the integrity probe + replay path).
    """

    def __init__(self):
        self._kills: list[dict] = []  # {shard, chunk, fired}
        self._delays: dict[tuple[int, int], float] = {}
        self._transients: dict[tuple[int, int], int] = {}
        self._corruptions: dict[tuple[int, int], int] = {}
        self._injected = {
            "kills": 0, "delays": 0, "transients": 0, "corruptions": 0,
        }

    # -- arming --------------------------------------------------------------

    def kill_shard(self, shard: int, at_chunk: int) -> "FaultInjector":
        self._kills.append(
            {"shard": int(shard), "chunk": int(at_chunk), "fired": False}
        )
        return self

    def delay_shard(self, shard: int, at_chunk: int,
                    seconds: float) -> "FaultInjector":
        self._delays[(int(shard), int(at_chunk))] = float(seconds)
        return self

    def fail_push(self, shard: int, at_chunk: int,
                  times: int = 1) -> "FaultInjector":
        self._transients[(int(shard), int(at_chunk))] = int(times)
        return self

    def corrupt_output(self, shard: int, at_chunk: int,
                       times: int = 1) -> "FaultInjector":
        self._corruptions[(int(shard), int(at_chunk))] = int(times)
        return self

    # -- engine-facing hooks -------------------------------------------------

    def on_dispatch(self, shard: int, chunk: int) -> None:
        """Called before each shard dispatch; raises the armed fault."""
        left = self._transients.get((shard, chunk), 0)
        if left > 0:
            self._transients[(shard, chunk)] = left - 1
            self._injected["transients"] += 1
            raise TransientShardError(
                shard, f"injected transient failure: shard {shard} "
                       f"chunk {chunk} ({left - 1} left)"
            )
        for kill in self._kills:
            if kill["shard"] == shard and chunk >= kill["chunk"]:
                if not kill["fired"]:
                    kill["fired"] = True
                    self._injected["kills"] += 1
                raise ShardLost(
                    shard, f"injected shard loss: shard {shard} died at "
                           f"chunk {kill['chunk']} (dispatching "
                           f"chunk {chunk})"
                )

    def on_materialize(self, shard: int, chunk: int) -> None:
        """Called inside each shard materialize (under the watchdog
        timeout, so an armed delay can trip `ShardTimeout`)."""
        seconds = self._delays.pop((shard, chunk), None)
        if seconds:
            self._injected["delays"] += 1
            time.sleep(seconds)

    def corrupt(self, shard: int, chunk: int, arr: np.ndarray) -> np.ndarray:
        """Called on each shard's materialized block; returns it damaged
        when a corruption is armed for (shard, chunk)."""
        left = self._corruptions.get((shard, chunk), 0)
        if left > 0:
            self._corruptions[(shard, chunk)] = left - 1
            self._injected["corruptions"] += 1
            return arr + 1
        return arr

    def on_shard_removed(self, shard: int) -> None:
        """The engine removed ``shard`` from the mesh: retire the FIRED
        kill targeting it, so the renumbered slot's next occupant is
        not re-killed by the same corpse.  Unfired faults keep their
        slot indices (slot-at-fire-time semantics, see class doc)."""
        self._kills = [
            k for k in self._kills
            if not (k["fired"] and k["shard"] == shard)
        ]

    # -- observability -------------------------------------------------------

    def faults_injected(self) -> dict:
        """Copy of the per-kind injected-fault counters."""
        return dict(self._injected)
