"""Double-buffered serving over a sharded BLMAC filter bank — the port's
copy of `repro.serving.engine.AsyncBankServer` (pure Python over the
engine's ``push_async → PendingChunk`` contract; no JAX)."""
from __future__ import annotations

__all__ = ["AsyncBankServer"]


class AsyncBankServer:
    """Double-buffered request path over a sharded BLMAC filter bank.

    Wraps `repro_torch.filters.ShardedFilterBankEngine` (or anything with its
    ``push_async → PendingChunk`` contract) behind a bounded in-flight
    queue: ``submit(chunk)`` dispatches the chunk's kernels onto the
    mesh and returns immediately, so the host frames and enqueues chunk
    ``k+1`` while the devices are still filtering chunk ``k`` — the
    classic serve-side latency hide.  ``depth`` bounds the outstanding
    chunks (2 = double buffering); when the queue is full, ``submit``
    resolves the OLDEST chunk first and returns its outputs, giving a
    strict-ordered stream with no unbounded device-memory growth.

    Failure semantics (see `repro_torch.distributed.faultbank`): permanent
    shard loss is the ENGINE's job — it re-partitions and replays, and
    the server never sees it unless no device survived.  What the
    server owns is the bounded-liveness contract on top:

      * `TransientShardError` from a chunk's ``result()`` is retried up
        to ``max_retries`` times with exponential backoff (the engine
        re-arms the chunk before re-raising, so each retry is a fresh
        dispatch); the budget exhausting raises `RetriesExhausted`,
      * ``deadline_s`` bounds one chunk's total resolve time across all
        its attempts; expiry raises `DeadlineExceeded`,
      * each backoff sleep is capped at ``max_backoff_s`` AND clamped to
        the remaining deadline budget, so an exponential backoff can
        never sleep past ``deadline_s`` before re-checking,
      * a failed chunk is dropped from the stream (its pending is
        invalidated so a late ``result()`` cannot resurrect stale
        outputs) and the error PROPAGATES to the caller — never a hang,
      * chunks that already RESOLVED inside the same ``submit``/``drain``
        call are never discarded by a later chunk's terminal failure:
        they are buffered and delivered (oldest first) by the next
        ``submit``/``drain`` call, so the surviving stream stays gapless
        around the dropped chunk,
      * strict output order is preserved across failures and mid-flight
        recoveries: chunks resolve oldest-first, and a recovery replay
        happens inside the oldest chunk's ``result()`` before any newer
        chunk is touched.

    ``fault_stats()`` surfaces the server's retry/failure counters next
    to the engine's detection/recovery counters.

    Typical loop::

        server = AsyncBankServer(engine)
        for chunk in stream:
            for done in server.submit(chunk):
                consume(done)          # (B, C, n_out) int32
        for done in server.drain():
            consume(done)
    """

    def __init__(self, engine, depth: int = 2, max_retries: int = 3,
                 backoff_s: float = 0.01, deadline_s: float | None = None,
                 max_backoff_s: float = 1.0):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if max_backoff_s <= 0:
            raise ValueError("max_backoff_s must be > 0")
        self.engine = engine
        self.depth = int(depth)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.deadline_s = deadline_s
        self._inflight: list = []
        self._ready: list = []  # resolved outputs not yet delivered
        self.chunks_in = 0
        self.chunks_out = 0
        self.retries = 0
        self.retries_exhausted = 0
        self.deadline_expired = 0
        self.failed_chunks = 0

    @property
    def program(self):
        """The engine's compiled `repro_torch.compiler.BlmacProgram` (None for
        engines that predate the compile pipeline) — `save()` it so the
        next serving process warm-starts without recompiling."""
        return getattr(self.engine, "program", None)

    def _resolve(self, pending):
        """Resolve ONE pending chunk under the retry/deadline budget.

        Transient errors sleep an exponentially growing backoff and
        retry (the engine re-armed the chunk before raising, so each
        ``result()`` attempt is a fresh dispatch).  Each sleep is capped
        at ``max_backoff_s`` and clamped to the remaining ``deadline_s``
        budget — the doubling can never overshoot the deadline, so a
        tight deadline expires on time instead of after a stray
        multi-second sleep.  On a terminal failure — budget exhausted,
        deadline elapsed, or a permanent error — the pending is
        invalidated (dropped from the stream and from the engine's
        replay set) and the error propagates."""
        import time

        from ..distributed.faultbank import (DeadlineExceeded,
                                             RetriesExhausted,
                                             TransientShardError)

        t0 = time.monotonic()
        delay = min(self.backoff_s, self.max_backoff_s)
        failures = 0
        while True:
            try:
                return pending.result()
            except TransientShardError as e:
                failures += 1
                elapsed = time.monotonic() - t0
                if self.deadline_s is not None and elapsed >= self.deadline_s:
                    self.deadline_expired += 1
                    self._drop(pending)
                    raise DeadlineExceeded(
                        e.shard,
                        f"chunk missed its {self.deadline_s:.3f}s deadline "
                        f"after {failures} attempt(s) ({elapsed:.3f}s "
                        f"elapsed)",
                    ) from e
                if failures > self.max_retries:
                    self.retries_exhausted += 1
                    self._drop(pending)
                    raise RetriesExhausted(
                        e.shard,
                        f"chunk failed {failures} attempt(s) "
                        f"(max_retries={self.max_retries}): {e}",
                    ) from e
                self.retries += 1
                sleep_s = delay
                if self.deadline_s is not None:
                    # never sleep past the deadline: wake exactly at it,
                    # give the chunk one final attempt, and let the check
                    # above expire it
                    sleep_s = min(
                        sleep_s, self.deadline_s - (time.monotonic() - t0)
                    )
                if sleep_s > 0:
                    time.sleep(sleep_s)
                delay = min(delay * 2, self.max_backoff_s)
            except Exception:
                # permanent: unrecoverable loss, invalidated pending, …
                self._drop(pending)
                raise

    def _drop(self, pending) -> None:
        """Remove a terminally failed chunk from the stream: out of the
        server queue (so the NEXT submit/drain resolves the next-oldest
        chunk, not the dead one again) and invalidated on the engine
        side (so a late ``result()`` raises instead of resurrecting
        stale outputs, and recovery replays stop tracking it)."""
        self.failed_chunks += 1
        if pending in self._inflight:
            self._inflight.remove(pending)
        invalidate = getattr(pending, "invalidate", None)
        if callable(invalidate):
            invalidate()

    def _take_ready(self) -> list:
        """Outputs that resolved during a previous call whose drain loop
        then failed terminally — delivered (oldest first) ahead of this
        call's own resolves, so a dropped chunk never takes its already-
        resolved elders down with it."""
        done, self._ready = self._ready, []
        return done

    def submit(self, chunk) -> list:
        """Dispatch one chunk; returns the list of chunk outputs that
        RESOLVED to make room (possibly empty, never more than one under
        steady state).  Raises on a terminally failed chunk (see class
        docstring) — the failed chunk is dropped, the rest of the
        stream's order is unaffected, and any outputs that resolved
        before the failure are buffered for the next ``submit``/
        ``drain`` call (never discarded)."""
        import numpy as np

        done = self._take_ready()
        try:
            while len(self._inflight) >= self.depth:
                pending = self._inflight[0]
                out = self._resolve(pending)  # raises AFTER dropping
                self._inflight.pop(0)
                done.append(out)
                self.chunks_out += 1
        except Exception:
            self._ready = done  # deliver with the next call
            raise
        pending = self.engine.push_async(np.asarray(chunk))
        self._inflight.append(pending)
        self.chunks_in += 1
        return done

    def drain(self) -> list:
        """Resolve every in-flight chunk, oldest first.  On a terminal
        failure the outputs resolved so far are buffered and delivered
        by the next ``submit``/``drain`` call."""
        done = self._take_ready()
        try:
            while self._inflight:
                out = self._resolve(self._inflight[0])
                self._inflight.pop(0)
                done.append(out)
                self.chunks_out += 1
        except Exception:
            self._ready = done
            raise
        return done

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def fault_stats(self) -> dict:
        """Server retry/failure counters merged with the engine's
        detection/recovery counters (``engine`` key; ``None`` for
        engines without a ``fault_stats`` surface)."""
        eng_stats = getattr(self.engine, "fault_stats", None)
        return {
            "retries": self.retries,
            "retries_exhausted": self.retries_exhausted,
            "deadline_expired": self.deadline_expired,
            "failed_chunks": self.failed_chunks,
            "chunks_in": self.chunks_in,
            "chunks_out": self.chunks_out,
            "inflight": len(self._inflight),
            "buffered": len(self._ready),
            "engine": eng_stats() if callable(eng_stats) else None,
        }
