"""Bounded, instrumented caches for the port's compile pipeline.

The port's copy of `repro.compiler.cache`: one content-addressed program
cache (a `BlmacProgram` is compiled at most once per distinct bank
content), hit/miss stats of the caches that key on a program's digest
(the dispatch planner's and the CSE pass's memo) and event counters for
the expensive recomputations (CSD packings, schedule plans, CSE mines,
§4 machine-cycle computes).
`cache_stats()` is the single observability point; it also reports the
bank kernel's table cache and the specialized-kernel LRU, whose entries
hold device-resident tables.
"""
from __future__ import annotations

import collections
import importlib
from dataclasses import dataclass

__all__ = ["CacheStat", "ProgramCache", "cache_stats", "clear_caches",
           "PROGRAM_CACHE", "STATS", "COUNTERS"]


@dataclass
class CacheStat:
    """Hit/miss counters for one cache domain."""

    hits: int = 0
    misses: int = 0

    def hit(self) -> None:
        self.hits += 1

    def miss(self) -> None:
        self.misses += 1

    def reset(self) -> None:
        self.hits = self.misses = 0


class ProgramCache:
    """LRU cache of compiled `BlmacProgram`s, content-addressed.

    One program may be registered under several keys (its quantized-
    coefficient digest and its packed-trit digest), so a bank compiled
    from coefficients is found again by a caller holding only the packed
    operand, and vice versa.  Past ``max_entries`` keys the least
    recently used entry is dropped.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = int(max_entries)
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.stat = CacheStat()

    def get(self, key):
        prog = self._entries.get(key)
        if prog is None:
            self.stat.miss()
            return None
        self._entries.move_to_end(key)
        self.stat.hit()
        return prog

    def put(self, prog, *keys) -> None:
        for key in keys:
            self._entries[key] = prog
            self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.stat.reset()


PROGRAM_CACHE = ProgramCache()

# hit/miss stats of caches that live outside this module but key on program
# digests or schedules: the dispatch planner's (kernels/runtime.py
# `_AUTOTUNE_CACHE`), the optimized-program memo (compiler/optimize.py
# `_CSE_MEMO`, whose hits are `cse_pass` calls answered without re-mining)
# and K1's host tables (kernels/blmac_fir.py `_TERMS_CACHE`, one entry per
# schedule and device)
STATS: "dict[str, CacheStat]" = {
    "autotune": CacheStat(),
    "cse": CacheStat(),
    "terms": CacheStat(),
}

# event counters: each key counts actual recomputation events, not lookups
COUNTERS = collections.Counter()


def _bump(event: str, n: int = 1) -> None:
    COUNTERS[event] += n


def _module(name: str):
    # the submodule, not a same-named function its package re-exports
    return importlib.import_module(name, __package__)


def cache_stats() -> dict:
    """Hits/misses/size of every compile-pipeline cache, plus the
    recomputation counters, as a JSON-ready dict (the reference's fields
    less its jit cache)::

        {"program": {"hits", "misses", "size"},
         "autotune": {"hits", "misses", "size"},
         "cse": {"hits", "misses", "size"},
         "terms": {"hits", "misses", "size"},
         "specialized": {"hits", "misses", "size"},
         "counters": {"csd_packings": ..., "schedule_plans": ...,
                      "cse_passes": ..., "machine_cycle_computes": ...,
                      ...}}
    """
    fir = _module("..kernels.blmac_fir")
    info = fir.specialized_program.cache_info()
    sizes = {"autotune": len(_module("..kernels.runtime")._AUTOTUNE_CACHE),
             "cse": len(_module(".optimize")._CSE_MEMO),
             "terms": len(fir._TERMS_CACHE)}
    out = {
        "program": {
            "hits": PROGRAM_CACHE.stat.hits,
            "misses": PROGRAM_CACHE.stat.misses,
            "size": len(PROGRAM_CACHE),
        },
    }
    for name, size in sizes.items():
        out[name] = {"hits": STATS[name].hits, "misses": STATS[name].misses,
                     "size": size}
    out["specialized"] = {
        "hits": info.hits, "misses": info.misses, "size": info.currsize,
    }
    out["counters"] = dict(COUNTERS)
    return out


def clear_caches() -> None:
    """Empty every compile-pipeline cache and zero the counters (a test
    isolation hook; the caches are bounded)."""
    PROGRAM_CACHE.clear()
    _module("..kernels.runtime")._AUTOTUNE_CACHE.clear()
    _module(".optimize")._CSE_MEMO.clear()
    for stat in STATS.values():
        stat.reset()
    fir = _module("..kernels.blmac_fir")
    fir._TERMS_CACHE.clear()
    fir.specialized_program.cache_clear()
    COUNTERS.clear()
