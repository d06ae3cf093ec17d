"""The port's spans (`repro_torch.tracing`) on the CPU: a shared null
context while no profiler records, and under `torch.profiler` the
entry's spans in order, nested in its root, with a rebuild's
``build.*`` spans on a cold call only; K1's table cache in
`cache_stats()`.  The card's half (each ``launch.k1`` span holds one K1
launch) is in `tests/test_torch_cuda.py`."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.compiler import cache_stats, clear_caches, compile_bank
from repro_torch.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro_torch.kernels import blmac_fir_bank
from repro_torch.kernels.blmac_fir import bank_terms

ROOT = "repro_torch.blmac_fir_bank"
WARM_K1 = ["compile.lookup", "plan", "frame", "launch.k1"]
WARM_K2 = ["compile.lookup", "plan", "frame", "launch.k2", "frame", "stack"]


def _signal(channels=2, samples=700, seed=0):
    return np.random.default_rng(seed).integers(-128, 128, (channels, samples))


def _spans(fn):
    """Run ``fn`` under a CPU profiler; its ``repro_torch.*`` spans as
    (name less the prefix, start, end), in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name[len(tracing.PREFIX):], e.time_range.start,
            e.time_range.end) for e in prof.events()
           if e.name.startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _call_spans(spans):
    """Each root span's name and its children's names, in order; every
    child lies inside its root."""
    calls = []
    for name, s, e in spans:
        if tracing.PREFIX + name == ROOT:
            calls.append((s, e, []))
            continue
        owner = [c for c in calls if c[0] <= s and e <= c[1]]
        assert owner, f"{name} outside every root span"
        owner[-1][2].append(name)
    return [c[2] for c in calls]


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    a, b = tracing.span("plan"), tracing.span("launch.k1")
    assert a is b and isinstance(a, contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    q = spread_lowpass_qbank(8, 31)
    x = _signal()
    for bank in (q, q[:1]):  # K1's path and the one-filter fast path
        y = blmac_fir_bank(x, bank, device="cpu")
        assert np.array_equal(y.numpy(), fir_bit_layers_batch(x, bank))


def test_span_records_under_the_profiler_and_stops_with_it():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        inside = tracing.span("probe")
        with inside:
            torch.zeros(3).add_(1)
    assert not isinstance(inside, contextlib.nullcontext)
    assert "repro_torch.probe" in [e.name for e in prof.events()]
    assert isinstance(tracing.span("probe"), contextlib.nullcontext)


@pytest.mark.parametrize("n_filters, want", [(8, WARM_K1), (1, WARM_K2)],
                         ids=["k1", "k2"])
def test_a_warm_call_emits_its_spans_in_order(n_filters, want):
    q = spread_lowpass_qbank(8, 31)[:n_filters]
    x = _signal()
    blmac_fir_bank(x, q, device="cpu")  # cold: compiled and planned
    out = {}

    def call():
        out["y"] = blmac_fir_bank(x, q, device="cpu")

    calls = _call_spans(_spans(call))
    assert calls == [want]
    assert np.array_equal(out["y"].numpy(), fir_bit_layers_batch(x, q))


@pytest.mark.parametrize("n_filters, builds",
                         [(8, {"build.program", "build.schedule"}),
                          (1, {"build.program", "build.specialized"})],
                         ids=["k1", "k2"])
def test_a_cold_call_emits_its_builds_and_a_second_none(n_filters, builds):
    clear_caches()
    q = spread_lowpass_qbank(8, 31)[:n_filters]
    x = _signal(seed=n_filters)

    def twice():
        blmac_fir_bank(x, q, device="cpu")
        blmac_fir_bank(x, q, device="cpu")

    cold, warm = _call_spans(_spans(twice))
    assert {n for n in cold if n.startswith("build.")} == builds
    assert not [n for n in warm if n.startswith("build.")]
    counters = cache_stats()["counters"]
    assert counters["bank_compiles"] == 1
    assert counters.get("schedule_plans", 0) == (n_filters > 1)


def test_cache_stats_report_k1_tables_and_clear_caches_zeroes_them():
    clear_caches()
    assert cache_stats()["terms"] == {"hits": 0, "misses": 0, "size": 0}
    keys = list(cache_stats())
    assert keys.index("terms") + 1 == keys.index("specialized")
    prog = compile_bank(spread_lowpass_qbank(8, 31))
    sched = prog.schedule()

    def twice():
        first = bank_terms(sched, prog.taps, "cpu")
        assert bank_terms(sched, prog.taps, "cpu") is first

    spans = _spans(twice)
    assert [n for n, _, _ in spans] == ["build.terms"]
    assert cache_stats()["terms"] == {"hits": 1, "misses": 1, "size": 1}
    clear_caches()
    assert cache_stats()["terms"] == {"hits": 0, "misses": 0, "size": 0}
