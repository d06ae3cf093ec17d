"""Deterministic, sharded, resumable synthetic token pipeline.

The port's copy of `repro.data.pipeline` (numpy only): the same seed and
step give the same arrays, byte for byte.

Every batch is a pure function of (seed, step) via counter-based Philox
RNG — a restart at step k replays exactly the stream a non-failing run
would have seen (the property the fault-tolerance test asserts).  Shards
slice the global batch so each data-parallel group loads only its rows.

Two distributions:
  * ``uniform`` — i.i.d. tokens (throughput benchmarking),
  * ``markov``  — x_{t+1} = (a·x_t + c) mod V with ε-noise: a learnable
    next-token structure, so integration tests can assert loss ↓.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "markov"  # uniform | markov
    noise: float = 0.1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed affine map per seed for the markov structure
        r = np.random.Generator(np.random.Philox(key=cfg.seed))
        self._a = int(r.integers(1, cfg.vocab_size - 1)) | 1  # odd ⇒ bijective mod 2^k-ish
        self._c = int(r.integers(0, cfg.vocab_size))

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=step)
        )

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        r = self._rng(step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        if cfg.kind == "uniform":
            toks = r.integers(0, v, size=(b, s + 1), dtype=np.int32)
        else:
            toks = np.empty((b, s + 1), np.int32)
            toks[:, 0] = r.integers(0, v, size=b)
            noise = r.random((b, s)) < cfg.noise
            rand = r.integers(0, v, size=(b, s), dtype=np.int32)
            for t in range(s):
                nxt = (toks[:, t].astype(np.int64) * self._a + self._c) % v
                toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
            "mask": np.ones((b, s), np.float32),
        }

    def shard_batch_at(self, step: int, shard: int, n_shards: int):
        """Rows owned by data shard `shard` — deterministic slicing."""
        g = self.global_batch_at(step)
        b = self.cfg.global_batch
        if b % n_shards:
            raise ValueError(f"batch {b} not divisible by {n_shards} shards")
        lo = shard * (b // n_shards)
        hi = lo + b // n_shards
        return {k: v[lo:hi] for k, v in g.items()}
