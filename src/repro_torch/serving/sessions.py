"""Multi-tenant session serving: many user streams over ONE compiled bank.

The port of `repro.serving.sessions`: the same schedule of rounds, the
same admission decisions (the reference's cost-model priors) and the
same journal records, over the port's engines, so each tenant's stream
is bit-exact with the reference server's and a journal either package
wrote recovers in the other.  The shared engine runs where ``device``
says (None: the card, raising without one; ``"cpu"``: the kernels'
plain versions).

`AsyncBankServer` double-buffers a single caller; this module is the
production layer above it — a `BankSessionServer` that serves MANY
concurrent user streams over one `BlmacProgram`:

  * **Per-tenant filter selection.**  Each session opens on a subset of
    the bank's filters.  `program.select(rows)` makes the slice cheap
    (memoized array views registered content-addressed in the
    `ProgramCache`) and gives every selection a stable content key — the
    key a paused session's `TailSnapshot` is addressed to.
  * **Continuous batching into shared slots.**  The server owns one
    `FilterBankEngine` with ``n_slots`` channel lanes.  Sessions push
    independently-paced chunks into per-session queues; each `step()`
    packs every ready session's ``tail + queued`` buffer into the lanes
    of ONE batched dispatch (several rounds when more sessions are ready
    than there are lanes) and slices each tenant's rows / valid sample
    range out of the result.  Bit-exactness versus a dedicated
    per-session engine is structural: a lane is exactly the overlap-save
    buffer `FilterBankEngine.push` would have built, lanes are
    arithmetically independent, and everything is int32 — property-
    tested across arbitrary interleavings in ``tests/test_torch_sessions.py``.
  * **Pause / resume.**  `session.pause()` flushes the session and
    freezes its stream as a `TailSnapshot` keyed to the session's
    *selection* subprogram (and stamped with the session id —
    the compiler-side ``session`` field); `resume_session()` re-admits
    it bit-exactly, in this process or after a restart.
  * **Zero-downtime hot-swap.**  `session.swap_filters(rows)` retargets
    one session (its queue is flushed under the old selection first, so
    a swap never mixes output shapes); `server.swap_program(coeffs)`
    recompiles through the content-addressed `ProgramCache`, builds and
    warms the NEW engine while the OLD program keeps serving, then
    drains and flips atomically — per-session tails carry over because
    they are raw input history, not program state.
  * **Admission control and eviction.**  `open_session` is gated by
    `core.costmodel.predict_session_step_us`: a session is admitted only
    while the predicted batching step stays inside ``step_budget_us``.
    When over budget the server first parks idle sessions (LRU) —
    parking is an internal snapshot, and a push to a parked session
    transparently re-admits it — and only then rejects with
    `AdmissionRejected`.
  * **Sessions × shards.**  The shared lanes can run on a
    `repro_torch.filters.ShardedFilterBankEngine` of the same program
    (pass ``engine=``): `apply_lanes` dispatches through the sharded
    engine's `select()` subprograms, so a shard lost / timed out /
    corrupted mid-`step()` triggers its recovery — re-partition over the
    survivors, bit-exact replay — **inside the call**, with per-tenant
    fault isolation: only the sessions packed into the failed dispatch
    round ride the replay (no other session's output is reordered or
    dropped), transient shard errors get a bounded in-step retry, and
    `fault_stats()` attributes faults per session.  Admission control
    reads the ENGINE'S LIVE PLAN, which every recovery rebuilds, so
    after a shard loss the server prices steps against the degraded
    mesh (and `serve_stats()['degraded']` flips once the engine has
    fallen back to the 1×1 plain lowering).
  * **Durability.**  Attach a `repro_torch.serving.journal.SessionJournal`
    (``journal=`` path) and every state transition — session registry,
    pushed chunks, delivered-sample watermarks, cadenced quiescent-point
    snapshots — is written ahead to a CRC-framed segment log.
    `BankSessionServer.recover(path, program)` rebuilds every session
    bit-exactly after a `SIGKILL`: torn tail records are truncated,
    journaled chunks replay from the last snapshot, and regenerated
    output below each session's delivered watermark is trimmed so
    clients see no duplicates and no gaps.
  * **Observability.**  `serve_stats()` (per-session p50/p99 latency,
    batch occupancy, queue depth, admission rejections, swap/eviction
    counters, degraded flag, journal counters) lands next to the
    compiler's `cache_stats()` and the fault layer's `fault_stats()`.

The server is host-side and single-threaded by design (like
`AsyncBankServer`): callers interleave ``push`` / ``step`` / ``pull``
from one thread, and determinism of the batching schedule is part of
the bit-exactness contract.
"""
from __future__ import annotations

import itertools
import os
import time
from collections import deque

import numpy as np

__all__ = ["AdmissionRejected", "BankSession", "BankSessionServer"]

#: per-session latency samples kept for the p50/p99 estimators
LATENCY_WINDOW = 256


class AdmissionRejected(RuntimeError):
    """`open_session` (or re-admission of a parked session) would push the
    predicted batching step past the server's ``step_budget_us`` — or past
    ``max_sessions`` — and no idle session could be evicted to make room.

    Carries ``predicted_us`` (the step latency the admission would have
    cost) and ``budget_us`` so callers can implement backpressure.
    """

    def __init__(self, msg: str, predicted_us: float, budget_us: float):
        super().__init__(msg)
        self.predicted_us = float(predicted_us)
        self.budget_us = float(budget_us)


class BankSession:
    """One tenant stream: a filter selection plus overlap-save state.

    Handles are created by `BankSessionServer.open_session` /
    `resume_session`; all methods delegate to the server (which owns the
    shared engine and the batching schedule).
    """

    def __init__(self, server: "BankSessionServer", session_id: str, rows):
        self._server = server
        self.session_id = session_id
        self.rows = np.asarray(rows, np.int64)
        self.subkey = server.program.select(self.rows).key
        # overlap-save state (one lane): last ≤ taps−1 input samples
        self.tail = np.zeros((1, 0), np.int32)
        self.samples_in = 0
        self.samples_out = 0
        # independently-paced input: (chunk, enqueue_monotonic) pairs
        self.queue: list = []
        self.queued_samples = 0
        # outputs computed but not yet pulled, each (len(rows), n_i)
        self.outbox: list = []
        self.latencies = deque(maxlen=LATENCY_WINDOW)
        self.last_active = 0  # server step-sequence of last activity
        self.parked = False
        self.closed = False
        # durability / fault-attribution state
        self.seq = 0  # chunks pushed over the session lifetime
        self.delivered = 0  # samples handed to the caller (pull watermark)
        self.faults = 0  # dispatch-round faults this session rode through
        self.serves_since_snap = 0
        # rotation material: the last quiescent-point snapshot plus every
        # chunk pushed after it (pruned at each new snapshot, so memory is
        # bounded by the snapshot cadence)
        self._wal_snap: dict | None = None
        self._wal_chunks: list = []

    # -- conveniences that delegate to the server ---------------------------

    def push(self, chunk) -> None:
        self._server.push(self, chunk)

    def pull(self) -> np.ndarray:
        return self._server.pull(self)

    def pause(self):
        return self._server.pause_session(self)

    def swap_filters(self, rows) -> np.ndarray:
        return self._server.swap_filters(self, rows)

    def close(self) -> None:
        self._server.close_session(self)

    @property
    def pending(self) -> int:
        """Samples queued or tail-buffered but not yet served."""
        return self.queued_samples + self.tail.shape[1]


class BankSessionServer:
    """Serve many concurrent filter-selection streams over one program.

    Parameters
    ----------
    program : `repro_torch.compiler.BlmacProgram` or (B, taps) int array
        The compiled bank every session selects from (arrays are
        compiled via the content-addressed `compile_bank`).
    n_slots : int
        Channel lanes of the shared engine — sessions batched per
        dispatch round.  More ready sessions than slots simply take
        ceil(ready / n_slots) rounds per step.
    step_budget_us : float | None
        Admission budget: a session is admitted only while
        `predict_session_step_us(dispatch_us, active + 1, n_slots)`
        stays ≤ this.  None disables cost-model admission control.
    max_sessions : int | None
        Hard cap on concurrently *active* (non-parked) sessions.
    auto_step : bool
        When True (default) every `push` runs a batching step, so a
        single-caller loop behaves like `FilterBankEngine.push`.  Set
        False to drive `step()` yourself and batch many sessions' pushes
        into shared rounds (what the benchmark and a real event loop do).
    engine : engine instance | None
        A prebuilt lane engine to serve on instead of the default
        single-device `FilterBankEngine` — in practice a
        `repro_torch.filters.ShardedFilterBankEngine` of the SAME program with
        ``channels == n_slots`` (sessions × shards).  Faults inside its
        `apply_lanes` recover per the engine's own machinery; the server
        adds bounded transient retry, per-session fault attribution and
        post-recovery load shedding.  `swap_program` is a loud error
        with an injected engine (the server cannot rebuild a mesh it
        does not own).
    journal : str | os.PathLike | SessionJournal | None
        Write-ahead journal directory (see `repro_torch.serving.journal`).
        The directory must not already hold a journal — recover an
        existing one with `BankSessionServer.recover`.
    journal_fsync : bool
        False keeps SIGKILL durability (unbuffered appends) but skips
        the power-loss fsyncs.
    snapshot_every : int
        Quiescent-point snapshot cadence: a session's tail+counters are
        re-journaled after this many served rounds (shorter replays,
        more snapshot bytes).
    segment_bytes : int
        Journal segment size that triggers an atomic checkpoint
        rotation.
    max_step_retries : int
        Transient shard errors absorbed per dispatch round before the
        error propagates to the `step()` caller.
    mode, tile, chunk_hint
        Forwarded to the shared `FilterBankEngine` (ignored when
        ``engine`` is injected).
    device : str | torch.device | None
        Where the shared engine (and `swap_program`'s replacement) runs:
        None is the card and raises without one, ``"cpu"`` the kernels'
        plain versions.  Ignored when ``engine`` is injected.
    """

    def __init__(
        self,
        program,
        n_slots: int = 8,
        step_budget_us: float | None = None,
        max_sessions: int | None = None,
        auto_step: bool = True,
        mode: str = "auto",
        tile: int | None = None,
        device=None,
        chunk_hint: int = 2048,
        engine=None,
        journal=None,
        journal_fsync: bool = True,
        snapshot_every: int = 8,
        segment_bytes: int = 4 << 20,
        max_step_retries: int = 2,
    ):
        from ..compiler import BlmacProgram, compile_bank
        from ..filters import FilterBankEngine

        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if not isinstance(program, BlmacProgram):
            program = compile_bank(np.atleast_2d(np.asarray(program)))
        self.program = program
        self.n_slots = int(n_slots)
        self.step_budget_us = step_budget_us
        self.max_sessions = max_sessions
        self.auto_step = bool(auto_step)
        self._engine_kw = dict(
            mode=mode, tile=tile, device=device, chunk_hint=chunk_hint
        )
        if engine is not None:
            eng_prog = getattr(engine, "program", None)
            if eng_prog is None or eng_prog.key != program.key:
                raise ValueError(
                    "injected engine runs a different program than the "
                    "server (content keys differ) — sessions would select "
                    "rows of the wrong bank"
                )
            if int(engine.channels) != self.n_slots:
                raise ValueError(
                    f"injected engine has {engine.channels} channel lanes, "
                    f"server needs n_slots={self.n_slots}"
                )
            self.engine = engine
            self._engine_injected = True
        else:
            self.engine = FilterBankEngine(
                program, channels=self.n_slots, **self._engine_kw
            )
            self._engine_injected = False
        self.sessions: dict = {}  # session_id -> BankSession (incl. parked)
        self._ids = itertools.count()
        self._seq = 0  # monotone activity clock for LRU decisions
        self.snapshot_every = int(snapshot_every)
        self.max_step_retries = int(max_step_retries)
        # counters for serve_stats()
        self.steps = 0
        self.rounds = 0
        self.chunks_in = 0
        self.chunks_out = 0
        self.samples_in = 0
        self.samples_out = 0
        self.admission_rejections = 0
        self.evictions = 0
        self.filter_swaps = 0
        self.program_swaps = 0
        self.step_retries = 0  # transient faults absorbed inside step()
        self.session_faults = 0  # dispatch-round faults attributed to tenants
        self._lane_fill = 0  # lanes carrying a session, across all rounds
        self.journal = None
        if journal is not None:
            from .journal import SessionJournal

            if not isinstance(journal, SessionJournal):
                journal = SessionJournal(
                    os.fspath(journal),
                    program_key=program.key,
                    taps=program.taps,
                    n_filters=program.n_filters,
                    segment_bytes=segment_bytes,
                    fsync=journal_fsync,
                )
            if journal._seg_index >= 0:
                raise ValueError(
                    f"{journal.path} already holds a journal — a fresh "
                    f"server would supersede it; rebuild the crashed one "
                    f"with BankSessionServer.recover() instead"
                )
            self.journal = journal
            self._journal_rotate()  # commit the (empty) birth checkpoint

    # -- admission / eviction -----------------------------------------------

    def _dispatch_us(self) -> float:
        """Per-round dispatch latency estimate feeding admission control.
        Reads the engine's LIVE plan first — on a sharded engine that is
        `ShardedBankPlan`, rebuilt by every fault recovery, so admission
        automatically re-prices against a degraded mesh (the 1×1
        fallback's plan may carry a NaN prediction, which falls through
        to the coarse fixed-overhead floor).  That floor is the
        reference's TPU-interpret prior, kept so that admission decides
        as `repro`'s does; it is no estimate of the card."""
        from ..core.costmodel import PALLAS_CALL_US, STEP_US

        plan = getattr(self.engine, "plan", None)  # sharded: live mesh plan
        if plan is None:
            plan = getattr(self.engine, "dispatch_plan", None)
        if plan is not None:
            us = float(plan.predicted_us)
            if np.isfinite(us):
                return us
        return PALLAS_CALL_US + STEP_US

    def _degraded(self) -> bool:
        """True once the (sharded) engine has fallen back to the 1×1
        plain lowering — the last rung of graceful degradation."""
        fault = getattr(self.engine, "fault", None)
        return bool(
            fault is not None
            and getattr(fault, "degraded_since", None) is not None
        )

    def _active(self) -> int:
        return sum(
            1 for s in self.sessions.values() if not s.parked and not s.closed
        )

    def _journal_us(self, n_active: int) -> float:
        """Flat per-step WAL bill for the cost model: one chunk append
        per active session plus the group-commit fsync."""
        if self.journal is None:
            return 0.0
        from ..core.costmodel import JOURNAL_APPEND_US, JOURNAL_SYNC_US

        return JOURNAL_APPEND_US * n_active + (
            JOURNAL_SYNC_US if self.journal.fsync else 0.0
        )

    def predicted_step_us(self, extra_sessions: int = 0) -> float:
        """Modelled latency of one batching step with the current active
        population plus ``extra_sessions`` hypothetical admissions,
        priced against the engine's CURRENT (possibly degraded) plan and
        the journal's per-step overhead."""
        from ..core.costmodel import predict_session_step_us

        n = self._active() + extra_sessions
        return predict_session_step_us(
            self._dispatch_us(), n, self.n_slots,
            journal_us=self._journal_us(n),
        )

    def _park_idle_lru(self) -> bool:
        """Park the least-recently-active idle session to make room.
        Parking is internal state only (the lane model has no per-session
        device residency), so a parked session's handle stays valid and
        its next `push` re-admits it transparently."""
        idle = [
            s for s in self.sessions.values()
            if not s.parked and not s.closed and s.queued_samples == 0
        ]
        if not idle:
            return False
        victim = min(idle, key=lambda s: s.last_active)
        victim.parked = True
        self.evictions += 1
        return True

    def _shed_to_budget(self) -> int:
        """Post-recovery load shedding: after the engine re-plans onto a
        smaller (or degraded) mesh, the SAME active population may no
        longer fit the step budget — park idle LRU sessions until the
        predicted step fits again (or nothing idle remains).  Returns
        the number of sessions parked."""
        shed = 0
        if self.step_budget_us is None:
            return shed
        while (
            self.predicted_step_us() > self.step_budget_us
            and self._park_idle_lru()
        ):
            shed += 1
        return shed

    def _admit(self, what: str) -> None:
        """Gate one admission (open / resume / un-park) on the cost model,
        parking idle LRU sessions until the predicted step fits."""
        while True:
            over_cap = (
                self.max_sessions is not None
                and self._active() + 1 > self.max_sessions
            )
            predicted = self.predicted_step_us(extra_sessions=1)
            over_budget = (
                self.step_budget_us is not None
                and predicted > self.step_budget_us
            )
            if not over_cap and not over_budget:
                return
            if self._park_idle_lru():
                continue
            self.admission_rejections += 1
            budget = (
                float(self.step_budget_us)
                if self.step_budget_us is not None
                else float("inf")
            )
            raise AdmissionRejected(
                f"{what}: predicted step {predicted:.0f}us exceeds budget "
                f"{budget:.0f}us (active={self._active()}, "
                f"slots={self.n_slots}) and no idle session to evict",
                predicted_us=predicted,
                budget_us=budget,
            )

    def _readmit(self, session: BankSession) -> None:
        self._admit(f"re-admit session {session.session_id}")
        session.parked = False

    # -- write-ahead journal plumbing ---------------------------------------

    def _journal_append(self, rec: dict, sync: bool = False) -> None:
        if self.journal is not None:
            self.journal.append(rec, sync=sync)

    @staticmethod
    def _snap_record(session: BankSession, w: dict) -> dict:
        from .journal import encode_array

        return {
            "t": "snap",
            "sid": session.session_id,
            "seq": int(w["seq"]),
            "samples_in": int(w["samples_in"]),
            "samples_out": int(w["samples_out"]),
            "delivered": int(w["delivered"]),
            "tail": encode_array(w["tail"]),
        }

    def _maybe_snapshot(self, session: BankSession, force: bool = False):
        """Record a quiescent-point snapshot — nothing queued, everything
        computed delivered — at the configured cadence.  Tracked in
        memory unconditionally (it is also rotation material) and
        journaled when a journal is attached."""
        if (
            session.queued_samples
            or session.outbox
            or session.delivered != session.samples_out
        ):
            return  # not quiescent: a snapshot here could lose samples
        if not force and session.serves_since_snap < self.snapshot_every:
            return
        w = session._wal_snap
        if w is not None and w["seq"] == session.seq \
                and w["delivered"] == session.delivered:
            return  # nothing advanced since the last snapshot
        session._wal_snap = {
            "seq": session.seq,
            "samples_in": session.samples_in,
            "samples_out": session.samples_out,
            "delivered": session.delivered,
            "tail": session.tail.copy(),
        }
        session._wal_chunks = [
            (q, c) for q, c in session._wal_chunks if q > session.seq
        ]
        session.serves_since_snap = 0
        if self.journal is not None:
            self.journal.append(
                self._snap_record(session, session._wal_snap), sync=True
            )

    def _journal_checkpoint_records(self) -> list:
        """Condense the full live state into the record list a rotation
        (or a post-recovery re-attach) seeds its fresh segment with:
        per session, the registry entry, the last quiescent snapshot,
        every chunk pushed since it, and the delivered watermark."""
        from .journal import encode_array

        recs = []
        for s in self.sessions.values():
            recs.append({
                "t": "open",
                "sid": s.session_id,
                "rows": [int(r) for r in s.rows],
            })
            w = s._wal_snap
            if w is not None:
                recs.append(self._snap_record(s, w))
            for q, c in s._wal_chunks:
                recs.append({
                    "t": "chunk", "sid": s.session_id,
                    "seq": int(q), "data": encode_array(c),
                })
            if s.delivered > (int(w["delivered"]) if w else 0):
                recs.append({
                    "t": "pull", "sid": s.session_id,
                    "delivered": int(s.delivered),
                })
        return recs

    def _journal_rotate(self) -> None:
        self.journal.start_segment(self._journal_checkpoint_records())

    # -- session lifecycle ---------------------------------------------------

    def open_session(self, rows, session_id: str | None = None) -> BankSession:
        """Open a stream serving ``rows`` of the bank (original filter
        indices).  Warms the selection subprogram through the
        `ProgramCache` and runs admission control before the session can
        occupy a lane."""
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            raise ValueError("a session must select at least one filter")
        if rows.min() < 0 or rows.max() >= self.program.n_filters:
            raise ValueError(
                f"filter rows out of range for a {self.program.n_filters}-"
                f"filter bank: {rows}"
            )
        if session_id is None:
            session_id = f"s{next(self._ids)}"
        if session_id in self.sessions:
            raise ValueError(f"session id {session_id!r} already open")
        self._admit(f"open session {session_id}")
        s = BankSession(self, session_id, rows)
        self._seq += 1
        s.last_active = self._seq
        self.sessions[session_id] = s
        self._journal_append(
            {"t": "open", "sid": session_id, "rows": [int(r) for r in s.rows]},
            sync=True,
        )
        return s

    def close_session(self, session: BankSession) -> None:
        session.closed = True
        if self.sessions.pop(session.session_id, None) is not None:
            self._journal_append(
                {"t": "close", "sid": session.session_id}, sync=True
            )

    def pause_session(self, session: BankSession):
        """Flush the session, freeze its stream as a `TailSnapshot`
        addressed to its *selection* subprogram and stamped with the
        session id, and close it (freeing its admission slot).  The
        snapshot (plus the same ``rows``) is everything
        `resume_session` needs — here or in another process.  Outputs
        computed by the flush stay in the handle's outbox: `pull` works
        on a closed session, so nothing is lost if the caller pauses
        before draining."""
        from ..compiler.state import TailSnapshot

        self._check_open(session)
        if session.queued_samples:
            self.step()
        snap = TailSnapshot(
            program_key=session.subkey,
            channels=1,
            samples_in=session.samples_in,
            samples_out=session.samples_out,
            tail=session.tail.copy(),
            session=session.session_id,
        )
        self.close_session(session)
        return snap

    def resume_session(
        self, snapshot, rows, session_id: str | None = None
    ) -> BankSession:
        """Re-admit a paused stream bit-exactly.  The snapshot must be
        addressed to `program.select(rows)` — resuming under a different
        selection (or a different program) is a loud ValueError."""
        rows = np.asarray(rows, np.int64).ravel()
        expect = self.program.select(rows).key
        if snapshot.program_key != expect:
            raise ValueError(
                f"snapshot belongs to selection {snapshot.program_key[:12]}…,"
                f" rows {rows.tolist()} of this program are {expect[:12]}…"
            )
        if int(snapshot.channels) != 1:
            raise ValueError(
                f"session snapshots are single-lane, got "
                f"{snapshot.channels} channels"
            )
        s = self.open_session(
            rows, session_id=session_id or snapshot.session or None
        )
        s.tail = np.asarray(snapshot.tail, np.int32).copy()
        s.samples_in = int(snapshot.samples_in)
        s.samples_out = int(snapshot.samples_out)
        # a resumed stream starts quiescent: everything computed before
        # the pause was delivered (or rode away in the pause snapshot)
        s.delivered = s.samples_out
        self._maybe_snapshot(s, force=True)
        return s

    # -- hot swap ------------------------------------------------------------

    def swap_filters(self, session: BankSession, rows) -> np.ndarray:
        """Retarget one session to a new filter selection.  Queued input
        is flushed under the OLD selection first (a swap never mixes
        output shapes in the outbox); returns those final old-selection
        outputs.  The overlap-save tail carries over — it is raw input
        history, selection-independent — so the new selection's stream
        continues gaplessly."""
        self._check_open(session)
        if session.queued_samples:
            self.step()
        out = self.pull(session)
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            raise ValueError("a session must select at least one filter")
        if rows.min() < 0 or rows.max() >= self.program.n_filters:
            raise ValueError(
                f"filter rows out of range for a {self.program.n_filters}-"
                f"filter bank: {rows}"
            )
        session.rows = rows
        session.subkey = self.program.select(rows).key  # warm via cache
        self.filter_swaps += 1
        self._journal_append(
            {
                "t": "select",
                "sid": session.session_id,
                "rows": [int(r) for r in rows],
            },
            sync=True,
        )
        # the flush above delivered everything: snapshot the swap point so
        # a crash never replays pre-swap chunks under the new selection
        self._maybe_snapshot(session, force=True)
        return out

    def swap_program(self, coeffs, spec=None) -> None:
        """Zero-downtime server-wide program swap.  The replacement is
        compiled through the content-addressed `ProgramCache`
        (recompiling identical content is a cache hit) and its engine is
        built and warmed while the OLD program keeps serving; only then
        are all sessions drained under the old program and the engine
        flipped atomically.  Tap count must match — per-session tails
        are taps−1 samples of raw input history and carry over unchanged,
        which is what makes the swap seamless mid-stream."""
        from ..compiler import BlmacProgram, compile_bank
        from ..filters import FilterBankEngine

        if self._engine_injected:
            raise ValueError(
                "swap_program is not supported on an injected engine — "
                "the server cannot rebuild a sharded mesh it does not "
                "own; build the new engine yourself and start a new "
                "server (or construct the server without engine=)"
            )
        if isinstance(coeffs, BlmacProgram):
            new_prog = coeffs
        else:
            new_prog = compile_bank(np.atleast_2d(np.asarray(coeffs)), spec)
        if new_prog.taps != self.program.taps:
            raise ValueError(
                f"cannot hot-swap a {new_prog.taps}-tap program into a "
                f"{self.program.taps}-tap stream (tails would be invalid)"
            )
        for s in self.sessions.values():
            if s.rows.max() >= new_prog.n_filters:
                raise ValueError(
                    f"session {s.session_id} selects row {int(s.rows.max())}"
                    f" but the new program has {new_prog.n_filters} filters"
                )
        # build + warm the new engine while the old one still serves
        new_engine = FilterBankEngine(
            new_prog, channels=self.n_slots, **self._engine_kw
        )
        # drain every queued chunk under the OLD program, then flip
        self.step()
        self.program = new_prog
        self.engine = new_engine
        for s in self.sessions.values():
            s.subkey = new_prog.select(s.rows).key
        self.program_swaps += 1
        if self.journal is not None:
            # the journal is content-addressed to ONE program: re-key it
            # and rotate so the fresh segment's checkpoint belongs to the
            # new digest.  Caveat (documented): outputs computed under
            # the OLD program but not yet pulled at a crash regenerate
            # under the NEW program after recovery.
            self.journal.program_key = new_prog.key
            self._journal_rotate()

    # -- streaming -----------------------------------------------------------

    def _check_open(self, session: BankSession) -> None:
        if session.closed or session.session_id not in self.sessions:
            raise ValueError(f"session {session.session_id!r} is closed")

    def push(self, session: BankSession, chunk) -> None:
        """Enqueue (n,) samples on one session's independently-paced
        stream.  Pushing to a parked session re-admits it (possibly
        parking another idle session).  With ``auto_step`` the push also
        runs a batching step, so outputs land in the outbox immediately."""
        self._check_open(session)
        if session.parked:
            self._readmit(session)
        chunk = np.asarray(chunk)
        if chunk.ndim == 2 and chunk.shape[0] == 1:
            chunk = chunk[0]
        if chunk.ndim != 1:
            raise ValueError(
                f"session chunks are 1-D sample vectors, got {chunk.shape}"
            )
        chunk = chunk.astype(np.int32, copy=False)
        self._seq += 1
        session.last_active = self._seq
        if chunk.shape[0]:
            # write-ahead: the chunk is journaled (and SIGKILL-durable)
            # before any queue or counter can observe it
            session.seq += 1
            session._wal_chunks.append((session.seq, chunk))
            if self.journal is not None:
                from .journal import encode_array

                self.journal.append({
                    "t": "chunk",
                    "sid": session.session_id,
                    "seq": session.seq,
                    "data": encode_array(chunk),
                })
            session.queue.append((chunk, time.monotonic()))
            session.queued_samples += int(chunk.shape[0])
            session.samples_in += int(chunk.shape[0])
            self.chunks_in += 1
            self.samples_in += int(chunk.shape[0])
        if self.auto_step:
            self.step()

    def pull(self, session: BankSession) -> np.ndarray:
        """Drain a session's computed outputs as one gapless
        (len(rows), n) int32 array (n may be 0).  The delivered-sample
        watermark is journaled BEFORE the data is returned, so recovery
        never re-delivers samples the caller already has."""
        if not session.outbox:
            self._maybe_snapshot(session)
            return np.zeros((session.rows.size, 0), np.int32)
        out, session.outbox = session.outbox, []
        out = np.concatenate(out, axis=1) if len(out) > 1 else out[0]
        if out.shape[1]:
            session.delivered += int(out.shape[1])
            self._journal_append({
                "t": "pull",
                "sid": session.session_id,
                "delivered": session.delivered,
            })
        self._maybe_snapshot(session)
        return out

    def _ready_sessions(self) -> list:
        """Consume priming-only queues into tails (no kernel work) and
        return the sessions that can produce ≥ 1 output, oldest queued
        chunk first (deterministic batching order)."""
        ready = []
        for s in self.sessions.values():
            if s.parked or s.closed or not s.queue:
                continue
            total = s.tail.shape[1] + s.queued_samples
            if total < self.program.taps:  # still priming: absorb, no lane
                data = np.concatenate([c for c, _ in s.queue])
                now = time.monotonic()
                for _, ts in s.queue:
                    s.latencies.append(now - ts)
                self.chunks_out += len(s.queue)
                s.queue = []
                s.queued_samples = 0
                s.tail = np.concatenate([s.tail, data[None, :]], axis=1)
                continue
            ready.append(s)
        ready.sort(key=lambda s: s.queue[0][1])
        return ready

    def _dispatch_lanes(self, buf, batch) -> np.ndarray:
        """One dispatch round through the shared engine, with the fault
        contract the sharded engine needs: transient shard errors get a
        bounded retry (the call is stateless, so a retry is a clean
        re-dispatch), any detection the engine's recovery machinery
        handled DURING the call is attributed to exactly the sessions in
        this round, and a recovery re-plan immediately re-prices the
        budget (shedding idle load if the degraded mesh no longer fits).
        Per-tenant isolation is structural: sessions outside ``batch``
        have no samples in ``buf``, so neither the fault nor the replay
        can touch their streams."""
        fault = getattr(self.engine, "fault", None)
        d0 = fault.detections if fault is not None else 0
        attempts = 0
        try:
            while True:
                try:
                    return self.engine.apply_lanes(buf)
                except Exception as e:
                    from ..distributed.faultbank import TransientShardError

                    if not isinstance(e, TransientShardError):
                        raise
                    attempts += 1
                    self.step_retries += 1
                    if attempts > self.max_step_retries:
                        raise
        finally:
            d1 = fault.detections if fault is not None else 0
            if d1 > d0:
                self.session_faults += d1 - d0
                for s in batch:
                    s.faults += 1
                self._shed_to_budget()

    def step(self) -> int:
        """Run one batching step: serve EVERY ready session, packing up
        to ``n_slots`` of them per dispatch round.  Returns the number of
        sessions served.  Idempotent when nothing is queued.

        Fault isolation: a round that raises (transient retries
        exhausted, or a terminal shard loss) leaves ITS sessions' queues
        intact — nothing is consumed until the round's outputs exist —
        while rounds already completed in this step keep their outputs.
        With a journal attached the step ends with one group-commit
        fsync covering every chunk/pull record appended since the last."""
        ready = self._ready_sessions()
        if not ready:
            return 0
        self.steps += 1
        taps = self.program.taps
        served = 0
        try:
            for r0 in range(0, len(ready), self.n_slots):
                batch = ready[r0:r0 + self.n_slots]
                lane_bufs = []
                for s in batch:
                    data = np.concatenate([c for c, _ in s.queue])
                    lane_bufs.append(
                        np.concatenate([s.tail[0], data])
                    )
                lane_len = max(b.shape[0] for b in lane_bufs)
                buf = np.zeros((self.n_slots, lane_len), np.int32)
                for lane, b in enumerate(lane_bufs):
                    buf[lane, : b.shape[0]] = b
                y = self._dispatch_lanes(buf, batch)
                # y: (B_full, n_slots, lane_len - taps + 1)
                self.rounds += 1
                self._lane_fill += len(batch)
                now = time.monotonic()
                for lane, s in enumerate(batch):
                    valid = lane_bufs[lane].shape[0]
                    n_out = valid - taps + 1
                    s.outbox.append(
                        np.ascontiguousarray(y[s.rows, lane, :n_out])
                    )
                    s.tail = lane_bufs[lane][None, valid - (taps - 1):] \
                        if taps > 1 else np.zeros((1, 0), np.int32)
                    s.samples_out += n_out
                    self.samples_out += n_out
                    for _, ts in s.queue:
                        s.latencies.append(now - ts)
                    self.chunks_out += len(s.queue)
                    s.queue = []
                    s.queued_samples = 0
                    s.serves_since_snap += 1
                    self._seq += 1
                    s.last_active = self._seq
                    served += 1
        finally:
            if self.journal is not None:
                self.journal.sync()  # group commit
                if self.journal.needs_rotation:
                    self._journal_rotate()
        return served

    def flush(self) -> int:
        """Serve everything currently queued (alias for one `step`)."""
        return self.step()

    # -- observability -------------------------------------------------------

    def serve_stats(self) -> dict:
        """Serving-layer observability, one JSON-able dict — the session
        analogue of the compiler's `cache_stats()` and the fault layer's
        `fault_stats()`."""

        def _pct(samples, q):
            # None, not an IndexError, for a fresh server / all-parked
            # population with no latency samples yet
            if samples is None or len(samples) == 0:
                return None
            return float(np.percentile(np.asarray(samples), q)) * 1e3

        all_lat = []
        per_session = {}
        for s in self.sessions.values():
            lat = list(s.latencies)
            all_lat.extend(lat)
            per_session[s.session_id] = {
                "rows": int(s.rows.size),
                "parked": bool(s.parked),
                "queue_depth": len(s.queue),
                "queued_samples": int(s.queued_samples),
                "samples_in": int(s.samples_in),
                "samples_out": int(s.samples_out),
                "delivered": int(s.delivered),
                "faults": int(s.faults),
                "latency_p50_ms": _pct(lat, 50),
                "latency_p99_ms": _pct(lat, 99),
            }
        return {
            "sessions": len(self.sessions),
            "active": self._active(),
            "parked": sum(1 for s in self.sessions.values() if s.parked),
            "slots": self.n_slots,
            "steps": self.steps,
            "rounds": self.rounds,
            "occupancy": (
                self._lane_fill / (self.rounds * self.n_slots)
                if self.rounds else 0.0
            ),
            "queue_depth": sum(
                len(s.queue) for s in self.sessions.values()
            ),
            "chunks_in": self.chunks_in,
            "chunks_out": self.chunks_out,
            "samples_in": self.samples_in,
            "samples_out": self.samples_out,
            "admission_rejections": self.admission_rejections,
            "evictions": self.evictions,
            "filter_swaps": self.filter_swaps,
            "program_swaps": self.program_swaps,
            "step_retries": self.step_retries,
            "session_faults": self.session_faults,
            "degraded": self._degraded(),
            "predicted_step_us": self.predicted_step_us(),
            "step_budget_us": self.step_budget_us,
            "latency_p50_ms": _pct(all_lat, 50),
            "latency_p99_ms": _pct(all_lat, 99),
            "journal": (
                self.journal.stats() if self.journal is not None else None
            ),
            "per_session": per_session,
        }

    def fault_stats(self) -> dict:
        """Fault observability through the serving layer: the engine's
        own counters (mesh shape, detections, recoveries, injected
        faults…) when it has any, plus the server's per-tenant
        attribution — which sessions rode through a faulted dispatch
        round, and how often."""
        eng_stats = getattr(self.engine, "fault_stats", None)
        d = dict(eng_stats()) if callable(eng_stats) else {}
        d["step_retries"] = self.step_retries
        d["session_faults"] = self.session_faults
        d["per_session"] = {
            sid: int(s.faults) for sid, s in self.sessions.items()
        }
        return d

    # -- crash recovery ------------------------------------------------------

    def close(self) -> None:
        """Flush and close the journal (if any) — the clean-shutdown
        twin of `recover`; the server object stays usable journal-less."""
        if self.journal is not None:
            self.journal.close()
            self.journal = None

    @classmethod
    def recover(
        cls,
        path,
        program,
        *,
        engine=None,
        journal_fsync: bool = True,
        segment_bytes: int = 4 << 20,
        **kwargs,
    ):
        """Rebuild a crashed server from its write-ahead journal.

        ``path`` is the journal directory of the dead process;
        ``program`` is the same bank (coefficients or a compiled
        `BlmacProgram`) — validated against the journal's program
        digest, so recovering under the wrong bank is a loud
        `JournalFormatError`, never a silently wrong stream.

        The rebuild is bit-exact and exactly-once: a torn tail record
        (the process died mid-append) is truncated at the last valid
        record; each session is restored from its last quiescent
        snapshot; journaled chunks after the snapshot are re-pushed and
        re-served through the engine; and the regenerated output below
        the session's journaled delivered-watermark is trimmed, so the
        first post-recovery `pull` continues the stream with no
        duplicates and no gaps.  Admission control is suspended during
        the rebuild (the journal already admitted these sessions once)
        and the server re-attaches to ``path`` with one atomic
        checkpoint rotation.  Extra ``kwargs`` (``n_slots``,
        ``step_budget_us``, ``engine`` …) configure the new server as
        usual."""
        from ..compiler import BlmacProgram, compile_bank
        from .journal import (JournalFormatError, SessionJournal,
                              decode_array)

        if not isinstance(program, BlmacProgram):
            program = compile_bank(np.atleast_2d(np.asarray(program)))
        header, records = SessionJournal.replay(path)
        if header.get("program_key") != program.key:
            raise JournalFormatError(
                f"{os.fspath(path)}: journal belongs to program "
                f"{str(header.get('program_key', '?'))[:12]}…, recovery "
                f"was offered {program.key[:12]}…"
            )
        server = cls(program, engine=engine, journal=None, **kwargs)
        # fold the log into per-session material: registry, last
        # snapshot, undigested chunks, delivered watermark
        reg: dict = {}
        for rec in records:
            t = rec.get("t")
            sid = rec.get("sid")
            if t == "open":
                reg[sid] = {
                    "rows": rec["rows"], "snap": None,
                    "chunks": [], "delivered": 0,
                }
            elif t == "close":
                reg.pop(sid, None)
            elif sid not in reg:
                continue  # record for a session closed later in the log
            elif t == "select":
                reg[sid]["rows"] = rec["rows"]
            elif t == "chunk":
                reg[sid]["chunks"].append(
                    (int(rec["seq"]), decode_array(rec["data"]))
                )
            elif t == "snap":
                r = reg[sid]
                r["snap"] = rec
                r["chunks"] = [
                    (q, c) for q, c in r["chunks"] if q > int(rec["seq"])
                ]
                r["delivered"] = max(r["delivered"], int(rec["delivered"]))
            elif t == "pull":
                reg[sid]["delivered"] = max(
                    reg[sid]["delivered"], int(rec["delivered"])
                )
        saved = (server.step_budget_us, server.max_sessions, server.auto_step)
        server.step_budget_us = None
        server.max_sessions = None
        server.auto_step = False
        try:
            for sid, r in reg.items():
                s = server.open_session(
                    np.asarray(r["rows"], np.int64), session_id=sid
                )
                snap = r["snap"]
                if snap is not None:
                    s.tail = np.atleast_2d(
                        decode_array(snap["tail"]).astype(np.int32)
                    )
                    s.samples_in = int(snap["samples_in"])
                    s.samples_out = int(snap["samples_out"])
                    s.seq = int(snap["seq"])
                    s._wal_snap = {
                        "seq": s.seq,
                        "samples_in": s.samples_in,
                        "samples_out": s.samples_out,
                        "delivered": int(snap["delivered"]),
                        "tail": s.tail.copy(),
                    }
                s.delivered = max(
                    int(r["delivered"]),
                    int(snap["delivered"]) if snap is not None else 0,
                )
                for _, chunk in sorted(r["chunks"], key=lambda t_: t_[0]):
                    server.push(s, chunk)
            server.step()  # regenerate every session's post-snapshot output
            for sid, r in reg.items():
                s = server.sessions[sid]
                base = (
                    int(r["snap"]["samples_out"])
                    if r["snap"] is not None else 0
                )
                drop = s.delivered - base
                if drop <= 0:
                    continue
                out = (
                    np.concatenate(s.outbox, axis=1)
                    if len(s.outbox) > 1
                    else (s.outbox[0] if s.outbox
                          else np.zeros((s.rows.size, 0), np.int32))
                )
                if drop > out.shape[1]:
                    raise JournalFormatError(
                        f"{os.fspath(path)}: session {sid} journaled a "
                        f"delivered watermark {s.delivered} beyond its "
                        f"replayable output {base + out.shape[1]} — "
                        f"chunk records are missing"
                    )
                trimmed = np.ascontiguousarray(out[:, drop:])
                s.outbox = [trimmed] if trimmed.shape[1] else []
        finally:
            (server.step_budget_us, server.max_sessions,
             server.auto_step) = saved
        # re-attach at the same path: one atomic checkpoint rotation
        # supersedes (and deletes) the crashed process's segments
        server.journal = SessionJournal(
            path,
            program_key=program.key,
            taps=program.taps,
            n_filters=program.n_filters,
            segment_bytes=segment_bytes,
            fsync=journal_fsync,
        )
        server._journal_rotate()
        return server
