"""Reads a traced sub-window: the profiler's device events and the
benchmark's own host spans (``bench.call`` around each entry call,
``bench.wait.<k>`` around the wait for block k), from the Chrome trace
that `torch.profiler` exports."""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["DEVICE_CATS", "TraceData", "read_trace", "summarize"]

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver",
                       "user_annotation"})
TOP = 10


@dataclass
class TraceData:
    """The traced window's device time: ``kernels`` maps each device
    operation's name to its durations in seconds (every complete event
    in the trace), ``busy_s`` is the union of device operations inside
    the window and ``window_s`` its length."""

    kernels: dict
    busy_s: float
    window_s: float
    breakdown: dict


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(host, starts, at: float) -> str:
    """What the host was doing at ``at``: the benchmark's span and the
    innermost operation that contain it."""
    span, inner, inner_dur = "host", None, None
    i = bisect.bisect_right(starts, at)
    for name, cat, s, e in reversed(host[max(0, i - 400):i]):
        if e < at:
            continue
        if cat == "user_annotation" and name.startswith("bench."):
            if span == "host":
                span = "bench.wait" if name.startswith("bench.wait") \
                    else name
        elif inner_dur is None or e - s < inner_dur:
            inner, inner_dur = name, e - s
    return span if inner is None else f"{span} > {inner}"


def summarize(events: list, w0: float, w1: float) -> tuple:
    """``events``: (name, cat, start, end) in seconds.  Returns the busy
    seconds inside [w0, w1], the device operations that took most of it
    and the longest idle time by what the host was doing, each a list of
    [name, seconds]."""
    dev = [(max(s, w0), min(e, w1), n) for n, c, s, e in events
           if c in DEVICE_CATS and e > w0 and s < w1]
    busy = _union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy)
    by_op: dict = {}
    for s, e, n in dev:
        by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s)
    host = sorted(((n, c, s, e) for n, c, s, e in events if c in HOST_CATS),
                  key=lambda h: h[2])
    starts = [h[2] for h in host]
    by_host: dict = {}
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            label = _label(host, starts, edge)
            by_host[label] = by_host.get(label, 0.0) + (s - edge)
        edge = max(edge, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]

    return busy_s, top(by_op), top(by_host)


def read_trace(tracer, path: Path, depth: int) -> TraceData:
    """Export ``tracer``'s profile to ``path`` and read it: the window
    runs from the host's ``depth + 1``-th sight of a block complete under
    the profiler (the pipeline full of traced blocks) to its sight of the
    last traced block complete."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tracer.prof.export_chrome_trace(str(path))
    with open(path) as f:
        raw = json.load(f)
    events = []
    for ev in raw.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        events.append((str(ev.get("name", "")), ev.get("cat", ""), s,
                       s + float(ev["dur"]) * 1e-6))
    waits = {}
    for n, c, s, e in events:
        if c == "user_annotation" and n.startswith("bench.wait."):
            waits[int(n.rsplit(".", 1)[1])] = e
    done = sorted(waits)
    if len(done) <= depth:
        raise RuntimeError(f"the trace saw {len(done)} blocks complete")
    w0, w1 = waits[done[depth]], waits[done[-1]]
    busy_s, ops, idle = summarize(events, w0, w1)
    kernels: dict = {}
    for n, c, s, e in events:
        if c == "kernel":
            kernels.setdefault(n, []).append(e - s)
    return TraceData(kernels, busy_s, w1 - w0,
                     {"device_ops": ops, "idle_gaps": idle})
