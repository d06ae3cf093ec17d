"""The program's spans as the benchmark reads them (`perfbench/spans.py`
and the four readers built on it): a hand-written trace gives known
medians and counts, a trace from another run reads as nothing, and a
traced CPU run of each cell exports every call's spans while the
readers, with no device time to go by, report nothing (CPU)."""
from __future__ import annotations

import json
import shutil
import time

import pytest

import _cells
from perfbench import spans
from perfbench.harness import Record, load_module, run_cell
from perfbench.trace import TraceData

ROOT = _cells.ROOT
READERS = ("lookup_host_ms", "plan_host_ms", "launch_host_ms",
           "rebuilds_per_call")
# each traced call of the cells' entry: the root, then its stages
K1_CALL = ["blmac_fir_bank", "compile.lookup", "plan", "frame", "launch.k1"]
K2_CALL = ["blmac_fir_bank", "compile.lookup", "plan", "frame", "launch.k2",
           "frame", "stack"]


def reader(name):
    return load_module(ROOT / "perfbench" / "metrics" / f"{name}.py")


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _p(name, ts, dur):
    return _x(spans.PREFIX + name, ts, dur)


# two calls, microseconds: the second holds a rebuild; one K1 launch
EVENTS = [
    _x("bench.call", 0, 1000),
    _p("blmac_fir_bank", 10, 980),
    _p("compile.lookup", 20, 600),
    _p("plan", 630, 40),
    _p("frame", 700, 100),
    _p("launch.k1", 810, 150),
    _x("bench.call", 2000, 1500),
    _p("blmac_fir_bank", 2010, 1480),
    _p("compile.lookup", 2020, 400),
    _p("plan", 2430, 500),
    _p("build.schedule", 2440, 480),
    _p("frame", 2940, 120),
    _p("launch.k1", 3070, 300),
    _p("build.library", 3080, 100),  # inside the launch: counted once
    _x("blmac_bank_kernel", 900, 5000, cat="kernel"),
    _x("cudaLaunchKernel", 900, 5, cat="cuda_runtime"),
    _p("plan", 5000, 10),  # outside every bench.call: not a call's
]


def _record(tmp_path, monkeypatch, events, kernels, busy_s=1.0,
            cell="cell.test"):
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path)
    (tmp_path / f"{cell}.json").write_text(
        json.dumps({"traceEvents": events}))
    trace = TraceData(kernels, busy_s, 2.0, {})
    return Record(cell, {}, 0.0, [(0.0, 0.0, 1.0)], [], {}, trace)


def test_a_written_trace_gives_its_medians_and_count(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, EVENTS,
                  {"blmac_bank_kernel": [5e-3]})
    per_call = spans.calls(rec)
    assert [[n for n, _, _ in c] for c in per_call] == [
        K1_CALL, K1_CALL[:3] + ["build.schedule"] + K1_CALL[3:]
        + ["build.library"]]
    got = {name: reader(name).read(rec) for name in READERS}
    assert got["lookup_host_ms"] == pytest.approx((0.6 + 0.4) / 2)
    assert got["plan_host_ms"] == pytest.approx((0.04 + 0.5) / 2)
    assert got["launch_host_ms"] == pytest.approx((0.25 + 0.42) / 2)
    assert got["rebuilds_per_call"] == 1.0


def test_another_runs_trace_reads_as_nothing(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, EVENTS,
                  {"blmac_bank_kernel": [5e-3, 5e-3]})
    assert spans.calls(rec) is None
    assert all(reader(name).read(rec) is None for name in READERS)


def test_no_device_time_or_no_program_span_reads_as_nothing(tmp_path,
                                                            monkeypatch):
    rec = _record(tmp_path, monkeypatch, EVENTS,
                  {"blmac_bank_kernel": [5e-3]}, busy_s=0.0)
    assert spans.calls(rec) is not None
    assert all(reader(name).read(rec) is None for name in READERS)
    bare = [e for e in EVENTS if not e["name"].startswith(spans.PREFIX)]
    rec = _record(tmp_path, monkeypatch, bare, {"blmac_bank_kernel": [5e-3]},
                  cell="cell.bare")
    assert spans.calls(rec) is None
    assert all(reader(name).read(rec) is None for name in READERS)


@pytest.mark.parametrize("name, want", [("sweep127.block48", K1_CALL),
                                        ("fir127.array64", K2_CALL)])
def test_a_traced_cpu_run_exports_every_calls_spans(tmp_path, monkeypatch,
                                                    name, want):
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(spans, "TRACE_DIR", bench / "out" / "trace")
    cell = _cells.small_cell(name, bench_dir=bench)
    result = run_cell(cell, 2**31 + 17, 0.05, True, "cpu",
                      time.perf_counter())
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    rec = Record(cell.name, {}, 0.0, [], [], {},
                 TraceData({}, 0.0, result["device"]["window_s"], {}))
    per_call = spans.calls(rec)
    assert per_call is not None
    assert len(per_call) >= int(cell.workload["trace_calls"])
    for c in per_call:
        assert [n for n, _, _ in c] == want
        root = c[0]
        assert all(root[1] <= s and e <= root[2] for _, s, e in c[1:])
