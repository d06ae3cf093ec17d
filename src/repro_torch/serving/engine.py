"""Serving: prefill and decode steps and a batched greedy LM engine
(`ServeEngine`), the port of `repro.serving.engine`'s LM half; and the
double-buffered request path over a sharded BLMAC filter bank
(`AsyncBankServer`, pure Python over the engine's ``push_async →
PendingChunk`` contract).

Caches are the per-stage stacked trees `forward` returns with
``make_cache``; decode walks (stage params, stage cache) in lock-step and
writes each token's entries into the cache in place.  Variable prompt
lengths are supported for attention archs by voiding the cache positions
past each prompt (pos = −1 ⇒ masked); recurrent archs (ssd / rglru) take
equal-length prompts only — their state cannot be position-masked after
the fact.

On a mesh (``mesh=``, ``rules=``; decode rules by default) the
parameters are placed as `repro`'s dry run places them
(``sanitized_shardings(…, param_pspecs(…), tp_fallback_axis="model")``)
and the caches by `cache_pspecs`.  Each data slot computes its rows of
the batch, its products split over its model slots
(`nn.common.tp_product`: no weight of theirs is gathered, as the
decode rules replicate ``d_model``); a cache sharded over ``cache_seq``
is attended piece by piece (sequence-parallel decode), the SSD and
RG-LRU states cut over ``model`` are read and written in their model
slots' pieces (prefill places each slot's part where it lies), other
cache leaves are read and written in their pieces.  Each slot's logits
are joined over vocab on its device (an all-gather), then assembled on
the first data slot's device.
"""
from __future__ import annotations

import torch

from ..distributed.placement import data_slots, from_blocks, rows_of
from ..distributed.sharding import (NamedSharding, PartitionSpec, make_rules,
                                    sanitize_spec, sanitized_shardings)
from ..kernels.runtime import as_device_tensor, resolve_device
from ..nn.common import ShardCtx, Split, map_tree, map_trees, torch_dtype
from ..nn.model import as_tree, decode_step, forward

__all__ = ["AsyncBankServer", "ServeEngine", "abstract_caches",
           "cache_pspecs", "make_decode_fn", "make_prefill_fn"]


def _slot_batch(batch, lo: int, hi: int, dev) -> dict:
    return {k: rows_of(v, lo, hi, dev) for k, v in batch.items()}


def _pos_sharding(mesh, rules, b: int) -> NamedSharding:
    return NamedSharding(mesh, sanitize_spec(
        mesh, PartitionSpec(rules.get("batch")), (b,)))


def make_prefill_fn(cfg, cache_len: int, mesh=None, rules=None):
    recurrent = any(k in ("ssd", "rglru") for k in cfg.block_pattern)
    cdt = torch_dtype(cfg.compute_dtype)

    def positions(batch, dev):
        leaf = batch.get("tokens", batch.get("embeds"))
        b, s = leaf.shape[0], leaf.shape[1]
        lengths = batch.get("lengths")
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if lengths is not None and not recurrent:
            lengths = lengths.to(device=dev, dtype=torch.int32)
            pos = torch.where(pos < lengths[:, None], pos, -1)
            next_pos = lengths
        else:
            next_pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        return pos, next_pos

    def prefill(params, batch):
        leaf = batch.get("tokens", batch.get("embeds"))
        pos, next_pos = positions(batch, leaf.device)
        ctx = ShardCtx(positions=pos, compute_dtype=cdt,
                       make_cache=True, cache_len=cache_len)
        logits, _, caches = forward(params, batch, cfg, ctx)
        return logits, {"caches": caches, "pos": next_pos}

    def prefill_mesh(params, batch):
        b = next(iter(batch.values())).shape[0]
        slots = data_slots(mesh, rules, b)
        home = slots[0][1]
        logits, blocks, nexts = [], [], []
        for d, dev, lo, hi in slots:
            sb = _slot_batch(batch, lo, hi, dev)
            pos, next_pos = positions(sb, dev)
            ctx = ShardCtx(positions=pos, compute_dtype=cdt,
                           make_cache=True, cache_len=cache_len,
                           rules=rules, mesh=mesh, data_slot=d, device=dev,
                           rows=(lo, hi))
            lg, _, caches = forward(params, sb, cfg, ctx)
            logits.append(lg.to(home))
            blocks.append(((lo, hi), caches))
            nexts.append((((lo, hi),), next_pos))
        shard = sanitized_shardings(mesh, cache_pspecs(cfg, rules),
                                    _global_shapes(blocks[0][1], b))

        def place(sh, *slot_leaves):
            cut = _cache_blocks(slot_leaves[0])
            t0 = cut[0][1]
            return from_blocks(sh, (t0.shape[0], b) + _extent(cut), t0.dtype, [
                (((0, t.shape[0]), rows) + index, t)
                for (rows, _), leaf in zip(blocks, slot_leaves)
                for index, t in _cache_blocks(leaf)])

        caches = map_trees(place, shard, *[c for _, c in blocks])
        pos = from_blocks(_pos_sharding(mesh, rules, b), (b,), torch.int32,
                          nexts)
        return torch.cat(logits), {"caches": caches, "pos": pos}

    return prefill if mesh is None else prefill_mesh


def _cache_blocks(leaf) -> list[tuple]:
    """A data slot's stacked cache leaf as ``(index of dims 2.., tensor)``
    blocks: a tensor whole, a `Split` (a recurrent state cut over the
    model slots) part by part, each where it lies."""
    if not isinstance(leaf, Split):
        return [(tuple((0, n) for n in leaf.shape[2:]), leaf)]
    out, at = [], 0
    for t in leaf.parts:
        n = t.shape[leaf.dim]
        out.append((tuple((at, at + n) if d == leaf.dim else (0, t.shape[d])
                          for d in range(2, t.ndim)), t))
        at += n
    return out


def _extent(blocks) -> tuple:
    """The dims 2.. of the tensor ``blocks`` cover."""
    return tuple(max(idx[d][1] for idx, _ in blocks)
                 for d in range(len(blocks[0][0])))


def _global_shapes(tree, b: int):
    """A slot's stacked cache tree as ``meta`` tensors of the whole
    batch's shapes (``b`` rows on dim 1)."""
    def one(leaf):
        blocks = _cache_blocks(leaf)
        t = blocks[0][1]
        return torch.empty((t.shape[0], b) + _extent(blocks), dtype=t.dtype,
                           device="meta")

    return map_tree(one, tree)


def make_decode_fn(cfg, mesh=None, rules=None):
    cdt = torch_dtype(cfg.compute_dtype)

    def decode(params, batch, state):
        pos = state["pos"]  # (B,)
        ctx = ShardCtx(positions=pos[:, None], compute_dtype=cdt)
        logits, caches = decode_step(params, batch, state["caches"], ctx, cfg)
        return logits, {"caches": caches, "pos": pos + 1}

    def decode_mesh(params, batch, state):
        pos = state["pos"]  # a ShardedTensor (B,)
        slots = data_slots(mesh, rules, pos.shape[0])
        home = slots[0][1]
        logits = []
        for d, dev, lo, hi in slots:
            sb = _slot_batch(batch, lo, hi, dev)
            ctx = ShardCtx(positions=rows_of(pos, lo, hi, dev)[:, None],
                           compute_dtype=cdt, rules=rules, mesh=mesh,
                           data_slot=d, device=dev, rows=(lo, hi))
            lg, _ = decode_step(params, sb, state["caches"], ctx, cfg)
            logits.append(lg.to(home))
        return torch.cat(logits), {"caches": state["caches"],
                                   "pos": pos.map(lambda t: t + 1)}

    return decode if mesh is None else decode_mesh


def abstract_caches(cfg, batch: int, cache_len: int):
    """``meta``-tensor cache tree matching `forward(make_cache=True)`:
    shapes and dtypes, never allocated."""
    from ..nn.attention import cache_size
    from ..nn.model import stage_plan

    dt = torch_dtype(cfg.compute_dtype)

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def slot_cache(meta, repeat):
        b = batch
        if meta.mixer == "attn":
            w = cache_size(cache_len, meta.window)
            hkv, dh = cfg.n_kv_heads, cfg.head_dim_
            # (B, Hkv, W, Dh): the decode layout
            return {
                "k": sds((repeat, b, hkv, w, dh), dt),
                "v": sds((repeat, b, hkv, w, dh), dt),
                "pos": sds((repeat, b, w), torch.int32),
            }
        if meta.mixer == "mla":
            return {
                "c_kv": sds((repeat, b, cache_len, cfg.kv_lora_rank), dt),
                "k_rope": sds((repeat, b, cache_len, cfg.qk_rope_dim), dt),
                "pos": sds((repeat, b, cache_len), torch.int32),
            }
        if meta.mixer == "ssd":
            ch = cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
            return {
                "state": sds((repeat, b, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dt),
                "conv_tail": sds((repeat, b, cfg.conv_width - 1, ch), dt),
            }
        # rglru
        return {
            "h": sds((repeat, b, cfg.rglru_width), torch.float32),
            "conv_tail": sds((repeat, b, cfg.conv_width - 1,
                              cfg.rglru_width), dt),
        }

    return [
        tuple(slot_cache(m, st.repeat) for m in st.metas)
        for st in stage_plan(cfg)
    ]


def cache_pspecs(cfg, rules):
    """PartitionSpecs mirroring `abstract_caches`."""
    from ..nn.model import stage_plan

    P = PartitionSpec
    b = rules.get("batch")
    cs = rules.get("cache_seq")
    # a mesh axis may appear once per spec: when the cache sequence is
    # sharded over `model` (SP decode), the kv-head dim must stay replicated
    cs_axes = set(cs) if isinstance(cs, tuple) else {cs}
    kvh = rules.get("kv_heads")
    if kvh in cs_axes:
        kvh = None

    def slot_spec(meta):
        if meta.mixer == "attn":
            return {
                "k": P(None, b, kvh, cs, None),
                "v": P(None, b, kvh, cs, None),
                "pos": P(None, b, cs),
            }
        if meta.mixer == "mla":
            return {
                "c_kv": P(None, b, cs, None),
                "k_rope": P(None, b, cs, None),
                "pos": P(None, b, cs),
            }
        if meta.mixer == "ssd":
            return {
                "state": P(None, b, rules.get("heads"), None, None),
                "conv_tail": P(None, b, None, rules.get("heads_flat")),
            }
        return {
            "h": P(None, b, rules.get("ff")),
            "conv_tail": P(None, b, None, rules.get("ff")),
        }

    return [
        tuple(slot_spec(m) for m in st.metas) for st in stage_plan(cfg)
    ]


class ServeEngine:
    """Minimal batched greedy engine over the prefill/decode steps, on
    ``device`` (``None``: the GPU, raising without one), or on the slots
    of ``mesh`` under ``rules`` (default ``make_rules(mesh, "decode")``).
    ``params``: a `LanguageModel`, a nested tree or a flat ``"/"``-keyed
    dict (what `quantize_param_tree` returns), moved to the device or
    placed on the mesh; float32 parameters are cast to
    ``cfg.compute_dtype`` where they are used."""

    def __init__(self, cfg, params, cache_len: int = 4096, device=None,
                 mesh=None, rules=None):
        self.cfg = cfg
        self.cache_len = cache_len
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.params = map_tree(
                lambda t: torch.as_tensor(t).to(self.device), as_tree(params))
        else:
            from ..distributed.placement import device_put
            from ..nn.common import param_pspecs
            from ..nn.model import model_decls

            rules = rules if rules is not None else make_rules(mesh, "decode")
            self.device = mesh.devices.flat[0]
            tree = map_tree(torch.as_tensor, as_tree(params))
            self.params = device_put(tree, sanitized_shardings(
                mesh, param_pspecs(model_decls(cfg), rules), tree,
                tp_fallback_axis="model"))
        self.rules = rules
        self._prefill = make_prefill_fn(cfg, cache_len, mesh, rules)
        self._decode = make_decode_fn(cfg, mesh, rules)

    @torch.inference_mode()
    def prefill(self, prompts):
        """(B, S) int tokens → (logits (B, S, V) float32, decode state)."""
        tokens = as_device_tensor(prompts, self.device).to(torch.int32)
        return self._prefill(self.params, {"tokens": tokens})

    @torch.inference_mode()
    def decode(self, tokens, state):
        """(B,) tokens at ``state``'s positions → (logits (B, 1, V),
        the next state); the state's caches are updated in place."""
        tok = as_device_tensor(tokens, self.device).to(torch.int32)
        return self._decode(self.params, {"token": tok.reshape(-1, 1)}, state)

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int = 16,
                 with_logits: bool = False):
        """prompts: (B, S) int tokens (equal length).  Greedy argmax;
        returns int32 (B, max_new_tokens) on the engine's device.
        ``max_new_tokens=0`` returns an empty (B, 0) tensor — the prefill
        argmax is NOT an emitted token.  ``with_logits``: also the (B, V)
        float32 logits each emitted token was chosen from."""
        tokens = as_device_tensor(prompts, self.device).to(torch.int32)
        if max_new_tokens <= 0:
            out = torch.zeros((tokens.shape[0], 0), dtype=torch.int32,
                              device=self.device)
            return (out, []) if with_logits else out
        logits, state = self.prefill(tokens)
        steps = [logits[:, -1, :]]
        tok = torch.argmax(steps[0], dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, state = self.decode(tok, state)
            steps.append(logits[:, -1, :])
            tok = torch.argmax(steps[-1], dim=-1).to(torch.int32)
            out.append(tok)
        out = torch.stack(out, dim=1)  # (B, max_new_tokens)
        return (out, steps) if with_logits else out


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
