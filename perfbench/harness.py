"""The general harness: one cell of `BENCHMARK.json`, run once.

Everything that belongs to one cell is found by name in files of its own:

* ``workloads/<cell>.json``: the configuration, the traffic, the entry,
  the chips, the judge's sample size and the traced sub-window;
* ``configs/<config>.json``: the design of the bank and the sample width;
* ``traffic/<traffic>.json``: channels, samples a block, the pool of
  blocks and the depth of the closed loop;
* ``entries/<entry>.py``: ``make(qbank, device)`` → the call under test,
  ``counters()`` → the program's launch counters;
* ``metrics/<metric>.py``: ``read(record)`` → the metric's value, or
  ``None`` where the record holds nothing to read.

`run_cell` sets up (designs the bank, draws the pool of blocks on the
device from the seed, warms up), runs the closed loop for the window,
judges a sample of every block the window completed against the plain
reference, and returns the result line.
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from perfbench.design import design_bank
from perfbench.reference import fir_at, unravel
from perfbench.work import call_work

__all__ = ["BENCH_DIR", "FORBIDDEN", "NAME_RE", "Cell", "Record", "Judge",
           "closed_loop", "forbidden_modules", "load_cell", "load_module",
           "make_pool", "run_cell"]

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
# blocks the loop runs before the window: the first compiles the bank
# and builds the kernels' tables, the rest fill the pipeline
WARM_CALLS = 4
# blocks whose samples share one device buffer of the judge
CHUNK = 256


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell: its files, read by name, and the metrics that
    `BENCHMARK.json` asks of it."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name``: its workload file, the configuration and traffic
    files that it names, and the metrics of `BENCHMARK.json` (beside the
    benchmark's folder) that apply to it."""
    if not NAME_RE.fullmatch(name):
        raise ValueError(f"bad cell name {name!r}")
    bench_dir = Path(bench_dir)
    bench = _json(bench_dir.parent / "BENCHMARK.json")
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path}")
    wl = _json(path)
    config = _json(bench_dir / "configs" / f"{wl['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    return Cell(
        name, wl, config, traffic,
        [m for m in bench["end_to_end"] if _applies(m, name)],
        [m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir,
    )


def make_pool(seed: int, traffic: dict, sample_bits: int,
              device) -> torch.Tensor:
    """The pool of blocks: int32 (pool, C, T) samples of ``sample_bits``
    signed bits, drawn on the device by a generator seeded with
    ``seed``.  The same seed gives the same blocks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    half = 1 << (sample_bits - 1)
    return torch.randint(
        -half, half, (traffic["pool"], traffic["channels"],
                      traffic["samples"]),
        generator=gen, device=device, dtype=torch.int32)


def _judge_seed(seed: int) -> int:
    # a stream apart from the pool's, fixed by the run's seed
    return (int(seed) * 6364136223846793005 + 1442695040888963407) % (1 << 64)


class Judge:
    """Takes a sample of every block's outputs as the window produces
    them (a few thousand positions drawn on the device from the seed, read
    with one gather), and afterwards compares each sample with the plain
    reference, drawing the same positions again."""

    def __init__(self, seed: int, shape: tuple, n: int, device):
        self.seed, self.shape, self.n = seed, tuple(shape), int(n)
        self.device = torch.device(device)
        self.gen = self._gen()
        self.ok: list = []  # per block: whether its outputs were well formed
        self.chunks: list = []  # the samples, CHUNK blocks to a buffer
        self.failed = 0  # blocks malformed or wrong, once verified

    def _gen(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_judge_seed(self.seed))
        return gen

    def _draw(self, gen) -> torch.Tensor:
        total = int(np.prod(self.shape))
        return torch.randint(0, total, (self.n,), generator=gen,
                             device=self.device)

    def take(self, y) -> None:
        flat = self._draw(self.gen)
        k = len(self.ok)
        if k % CHUNK == 0:
            self.chunks.append(torch.empty((CHUNK, self.n), dtype=torch.int32,
                                           device=self.device))
        ok = (torch.is_tensor(y) and tuple(y.shape) == self.shape
              and y.dtype == torch.int32 and y.device == self.device)
        if ok:
            torch.take(y, flat, out=self.chunks[-1][k % CHUNK])
        self.ok.append(ok)

    @property
    def blocks(self) -> int:
        return len(self.ok)

    def verify(self, pool: torch.Tensor, qbank: torch.Tensor) -> dict:
        """Mismatches, the widest gap and the blocks not judged, each with
        its limit (0: the outputs are exact integers)."""
        gen = self._gen()
        mismatches, widest, unjudged, wrong = 0, 0, 0, 0
        for k, ok in enumerate(self.ok):
            flat = self._draw(gen)
            if not ok:
                unjudged += 1
                continue
            got = self.chunks[k // CHUNK][k % CHUNK]
            b, c, t = unravel(flat, self.shape)
            want = fir_at(pool[k % pool.shape[0]], qbank, b, c, t)
            gap = (got.to(torch.int64) - want).abs()
            n_bad = int((gap != 0).sum())
            mismatches += n_bad
            wrong += n_bad > 0
            widest = max(widest, int(gap.max()))
        self.failed = unjudged + wrong
        return {"mismatches": {"value": mismatches, "limit": 0},
                "max_abs_diff": {"value": widest, "limit": 0},
                "unjudged_blocks": {"value": unjudged, "limit": 0}}


class _Done:
    """A block's completion as the host sees it: a CUDA event recorded
    after the entry returned (its outputs are then ready), or nothing on
    the CPU, where the call returns its outputs."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@dataclass
class Tracer:
    """A `torch.profiler` sub-window of the loop: started before block
    ``first`` is issued and stopped once the host has seen block ``last``
    complete.  `trace.read_trace` takes the window from the host's
    ``depth + 1``-th sight of a block complete under the profiler to its
    sight of block ``last``."""

    first: int
    last: int
    prof: object = None
    active: bool = False
    done: bool = False

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.start()
        self.active = True

    def stop(self) -> None:
        if self.active:
            self.prof.stop()
            self.active = False
            self.done = True


def closed_loop(entry, pool: torch.Tensor, depth: int, device, *,
                seconds: float | None = None, calls: int | None = None,
                judge: Judge | None = None, tracer: Tracer | None = None):
    """Issue the pool's blocks in turn, ``depth`` in flight: block k + 1
    is handed to the entry before the host waits on block k.  Stops
    issuing after ``calls`` blocks or ``seconds`` from the first, the
    profiler's start and stop left out (and, when traced, not before the traced
    blocks are done), then waits for those in flight.  Returns per-block (due, enqueued, ready) host times."""
    device = torch.device(device)
    times: list = []
    inflight: collections.deque = collections.deque()

    def finish():
        nonlocal paused
        k, due, enq, done, _ = inflight.popleft()
        if tracer is not None and tracer.active:
            with torch.profiler.record_function(f"bench.wait.{k}"):
                done.wait()
            if k == tracer.last:
                t = perf_counter()
                tracer.stop()
                paused += perf_counter() - t
        else:
            done.wait()
        times.append((due, enq, perf_counter()))

    def more() -> bool:
        if calls is not None:
            return k < calls
        return (perf_counter() - t0 - paused < seconds
                or (tracer is not None and not tracer.done))

    k = 0
    # the profiler's start and stop stall the loop for seconds: the clock
    # leaves them out, so a traced run times as many untraced calls
    paused = 0.0
    t0 = perf_counter()
    while more():
        x = pool[k % pool.shape[0]]
        if tracer is not None and k == tracer.first:
            t = perf_counter()
            tracer.start()
            paused += perf_counter() - t
        if tracer is not None and tracer.active:
            due = perf_counter()
            with torch.profiler.record_function("bench.call"):
                y = entry(x)
        else:
            due = perf_counter()
            y = entry(x)
        enq = perf_counter()
        done = _Done(device)
        if judge is not None:
            judge.take(y)
        inflight.append((k, due, enq, done, y))
        del y
        if len(inflight) >= depth:
            finish()
        k += 1
    while inflight:
        finish()
    return times


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@dataclass
class Record:
    """What one run recorded, for the metric readers: the work a call
    does, set-up, the window's per-block host times, the enqueue spans of
    the untraced calls, the program's launch counters over the window,
    and, in a traced run, the profiler's device events and host spans."""

    cell: str
    work: dict
    setup_s: float
    times: list
    host_ms: list
    counters: dict
    trace: object = None
    peaks: dict | None = None

    @property
    def calls(self) -> int:
        return len(self.times)

    @property
    def window_s(self) -> float:
        return self.times[-1][2] - self.times[0][0]

    @property
    def latencies_s(self) -> list:
        return [ready - due for due, _, ready in self.times]


def _peaks(bench_dir: Path, kind: str) -> dict | None:
    for entry in _json(bench_dir / "peaks.json")["devices"]:
        if entry["match"] in kind:
            return entry
    return None


def _periods_ms(times) -> dict | None:
    """Median, 99th percentile and longest time between two blocks'
    completions, as the host saw them."""
    ready = [r for _, _, r in times]
    gaps = np.diff(ready) * 1e3
    if not gaps.size:
        return None
    return {"p50": float(np.median(gaps)),
            "p99": float(np.percentile(gaps, 99)), "max": float(gaps.max())}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, entry_wrap=None, log=None) -> dict:
    """Set up, warm up, run the window, judge it; the result line as a
    dict (``checks`` last).  ``entry_wrap`` wraps the call under test (the
    control and the planted faults use it)."""
    device = torch.device(device)
    wl, traffic = cell.workload, cell.traffic
    marks = [("start", perf_counter())]
    bits = int(cell.config["sample_bits"])
    qbank = design_bank(cell.config["design"])
    work = call_work(qbank, traffic["channels"], traffic["samples"],
                     cell.config["design"]["coeff_bits"])
    entries = load_module(cell.bench_dir / "entries" / f"{wl['entry']}.py")
    entry = entries.make(qbank, device)
    if entry_wrap is not None:
        entry = entry_wrap(entry)
    marks.append(("design", perf_counter()))
    pool = make_pool(seed, traffic, bits, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("pool", perf_counter()))
    depth = int(traffic["depth"])
    shape = (qbank.shape[0], traffic["channels"], work["n_out"])
    n_sample = int(wl["check_samples"])

    # warm up every shape of the window: the call, the event, the gather
    closed_loop(entry, pool, depth, device, calls=WARM_CALLS,
                judge=Judge(seed + 1, shape, n_sample, device))
    marks.append(("warm-up", perf_counter()))
    if log is not None:
        log(f"set-up: imports {marks[0][1] - t_start:.3f} s, " + ", ".join(
            f"{name} {t - prev:.3f} s" for (name, t), (_, prev)
            in zip(marks[1:], marks)) + f"; since process start "
            f"{marks[-1][1] - t_start:.3f} s")
    judge = Judge(seed, shape, n_sample, device)
    tracer = None
    if trace:
        first = int(wl["trace_skip"])
        tracer = Tracer(first, first + int(wl["trace_calls"]))
    before = entries.counters()
    # the harness's own objects pile up over the window: no collection
    # of them may stall the loop
    gc.collect()
    gc.disable()
    try:
        times = closed_loop(entry, pool, depth, device, seconds=seconds,
                            judge=judge, tracer=tracer)
    finally:
        gc.enable()
    after = entries.counters()
    setup_s = times[0][0] - t_start
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    traced = set()
    trace_data = None
    if tracer is not None:
        from perfbench.trace import read_trace

        traced = set(range(tracer.first, tracer.last + 1))
        trace_data = read_trace(
            tracer, cell.bench_dir / "out" / "trace" / f"{cell.name}.json",
            depth)
    host_ms = [(enq - due) * 1e3 for k, (due, enq, _) in enumerate(times)
               if k not in traced]
    if log is not None and trace:
        log(f"entry host spans: {len(host_ms)} untraced calls of "
            f"{len(times)}")
    counters = {name: after[name] - before[name] for name in after}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rec = Record(cell.name, work, setup_s, times, host_ms, counters,
                 trace_data, _peaks(cell.bench_dir, kind))

    del entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = perf_counter()
    checks = judge.verify(pool, torch.as_tensor(qbank, device=device))
    if log is not None:
        log(f"reference: {judge.blocks} blocks x {n_sample} outputs "
            f"in {perf_counter() - t_ref:.3f} s")

    metrics = {}
    for m in cell.metrics(trace):
        reader = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = rec.calls
    correct = attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips if device.type == "cuda" else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": judge.failed,
              "metrics": metrics, "device": dev,
              "cell": cell.name, "seed": int(seed),
              "periods_ms": _periods_ms(times)}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = trace_data.breakdown
    if rec.peaks is not None and trace:
        result["peaks"] = rec.peaks
    result["checks"] = checks
    return result
