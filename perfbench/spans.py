"""The program's own host spans in a traced run: the ``repro_torch.*``
ranges (`repro_torch.tracing`) that `torch.profiler` recorded inside each
``bench.call``, read from the Chrome trace that `trace.read_trace`
exported for the run (``out/trace/<cell>.json``).

The file is parsed once a run.  It is taken as this run's only where
its kernel events, counted by name, are those of ``rec.trace.kernels``:
a file left by another run reads as nothing.  A program without spans
reads as nothing too."""
from __future__ import annotations

import bisect
import functools
import json
import statistics
from pathlib import Path

__all__ = ["PREFIX", "TRACE_DIR", "calls", "device_calls", "median_ms"]

PREFIX = "repro_torch."
TRACE_DIR = Path(__file__).resolve().parent / "out" / "trace"


@functools.lru_cache(maxsize=1)
def _parse(path: str, mtime_ns: int, size: int) -> tuple:
    """(kernel events by name, per ``bench.call`` in order of start the
    tuple of its program spans as (name less the prefix, start s, end
    s)); the file's time and size are the cache's key."""
    with open(path) as f:
        raw = json.load(f)
    counts: dict = {}
    bench, spans = [], []
    for ev in raw.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name, cat = str(ev.get("name", "")), ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        if cat == "kernel":
            counts[name] = counts.get(name, 0) + 1
        elif cat == "user_annotation" and name == "bench.call":
            bench.append((s, e))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, e))
    bench.sort()
    starts = [s for s, _ in bench]
    per_call: list = [[] for _ in bench]
    for name, s, e in sorted(spans, key=lambda sp: sp[1]):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= bench[i][1]:
            per_call[i].append((name, s, e))
    return counts, tuple(tuple(c) for c in per_call)


def calls(rec) -> tuple | None:
    """The traced calls' program spans, one tuple a ``bench.call``; None
    where the run was not traced, its trace file is missing or another
    run's, or no call holds a program span."""
    if rec.trace is None:
        return None
    path = TRACE_DIR / f"{rec.cell}.json"
    try:
        st = path.stat()
    except OSError:
        return None
    counts, per_call = _parse(str(path), st.st_mtime_ns, st.st_size)
    if counts != {n: len(ts) for n, ts in rec.trace.kernels.items()}:
        return None
    if not any(per_call):
        return None
    return per_call


def device_calls(rec) -> tuple | None:
    """`calls`, where the traced run saw device time (on the CPU the
    launch spans hold the plain computation, not a launch)."""
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return calls(rec)


def _covered_s(spans) -> float:
    total, edge = 0.0, float("-inf")
    for _, s, e in sorted(spans, key=lambda sp: sp[1]):
        if e > edge:
            total += e - max(s, edge)
            edge = e
    return total


def median_ms(rec, prefixes: tuple) -> float | None:
    """The median over the traced calls that hold one of the spans whose
    names start with one of ``prefixes`` of the host time those spans
    cover (their union: a nested span is not counted twice), in ms."""
    per_call = device_calls(rec)
    if per_call is None:
        return None
    times = [_covered_s([sp for sp in c if sp[0].startswith(prefixes)])
             for c in per_call if any(sp[0].startswith(prefixes) for sp in c)]
    return statistics.median(times) * 1e3 if times else None
