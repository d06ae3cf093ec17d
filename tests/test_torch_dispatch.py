"""The port's dispatch planner and cost model against `repro`'s.

On the CPU the port plans with the reference's constants, so
`autotune_bank_dispatch(..., device="cpu")` must equal
`repro.kernels.runtime.autotune_bank_dispatch(..., compiled=False)` field
for field — ``predicted_us`` and the CSE verdict included — for plain and
CSE-optimized programs over channels 1–4 and chunk hints 512–4096, and an
auto engine must pick the reference engine's mode, tile and verdict.  The
``"cuda"`` lane's sweep and formulas are checked on the host with given
constants (its fit runs on the card: `tests/test_torch_cuda.py`).
"""
import importlib
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import repro.compiler as rc
import repro_torch.compiler as tc
from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro.filters import FilterBankEngine as RefEngine
from repro.filters import spread_lowpass_qbank
from repro.kernels.runtime import autotune_bank_dispatch as ref_autotune
from repro_torch.core import costmodel as cm
from repro_torch.filters import FilterBankEngine
from repro_torch.kernels import SPECIALIZE_BANK_MAX, autotune_bank_dispatch
from repro_torch.kernels import runtime as rt

tk = importlib.import_module("repro_torch.kernels.blmac_fir")

BANKS = {
    "random": lambda: random_type1_bank(12, 31, seed=1),
    "sweep": lambda: sampled_sweep_bank(63, n_div=10, n_filters=24),
    "adversarial": lambda: adversarial_bank(31),
    "spread": lambda: spread_lowpass_qbank(32, 31),
    "wide": lambda: random_type1_bank(300, 15, seed=2, density=0.3),
}
HINTS = (512, 1024, 2048, 4096)


def _programs(bank, optimized):
    q = BANKS[bank]()
    port, ref = tc.compile_bank(q), rc.compile_bank(q)
    if optimized:
        port, ref = tc.cse_pass(port), rc.cse_pass(ref)
    return port, ref


def _same_plan(port, ref):
    plan, sched = port
    rplan, rsched = ref
    assert type(plan).__name__ == "BankDispatchPlan"
    assert asdict(plan) == asdict(rplan)
    assert (sched is None) == (rsched is None)
    if sched is not None:
        assert (sched.tile_size, sched.merge) == (rsched.tile_size,
                                                  rsched.merge)
        assert np.array_equal(sched.perm, rsched.perm)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_plan_equals_the_reference_on_the_cpu(bank, optimized, channels):
    port, ref = _programs(bank, optimized)
    for hint in HINTS:
        got = autotune_bank_dispatch(port, channels=channels,
                                     chunk_hint=hint, device="cpu")
        want = ref_autotune(ref, channels=channels, chunk_hint=hint,
                            compiled=False)
        _same_plan(got, want)
        assert got[0].lane == "interpret"
        assert (got[0].cse != "") == optimized


@pytest.mark.parametrize("tile", [128, 1024])
def test_plan_with_a_forced_tile_equals_the_reference(tile):
    port, ref = _programs("sweep", True)
    _same_plan(autotune_bank_dispatch(port, channels=2, tile=tile,
                                      device="cpu"),
               ref_autotune(ref, channels=2, tile=tile))


@pytest.mark.parametrize("bank", ["adversarial", "random", "spread", "wide"])
def test_auto_engine_picks_the_reference_engines_plan(bank):
    q = BANKS[bank]()
    for optimized in (False, True):
        port_p, ref_p = _programs(bank, optimized)
        eng = FilterBankEngine(port_p, channels=2, mode="auto", device="cpu")
        plan, _ = ref_autotune(ref_p, channels=2)
        assert asdict(eng.dispatch_plan) == asdict(plan)
        assert eng.mode == ("packed" if plan.mode == "scheduled"
                            else "specialized")
        assert eng.tile == plan.tile
        if plan.cse == "declined":
            assert eng.program is port_p.parent
        assert eng.n_filters == len(q)
        if eng.mode == "packed":
            assert (eng.bank_tile, eng.merge) == (plan.bank_tile, plan.merge)
    if bank == "adversarial":  # the reference engine itself, once
        ref_eng = RefEngine(rc.cse_pass(rc.compile_bank(q)), channels=2,
                            mode="auto", interpret=True)
        assert asdict(eng.dispatch_plan) == asdict(ref_eng.dispatch_plan)
        assert eng.mode == ref_eng.mode and eng.tile == ref_eng.tile


def test_the_plan_cache_counts_and_keys_on_the_program():
    tc.clear_caches()
    prog = tc.compile_bank(BANKS["random"]())
    first = autotune_bank_dispatch(prog, device="cpu")
    assert autotune_bank_dispatch(prog, device="cpu") is first
    assert autotune_bank_dispatch(prog.packed, 31, device="cpu") is first
    stats = tc.cache_stats()["autotune"]
    assert (stats["hits"], stats["misses"], stats["size"]) == (2, 1, 1)
    assert autotune_bank_dispatch(prog, channels=3, device="cpu") \
        is not first
    with pytest.raises(ValueError):
        autotune_bank_dispatch(prog, taps=15, device="cpu")
    with pytest.raises(ValueError):
        autotune_bank_dispatch(prog.packed, device="cpu")
    for i in range(rt._AUTOTUNE_CACHE_MAX + 4):
        autotune_bank_dispatch(prog, chunk_hint=100 + i, device="cpu")
    assert len(rt._AUTOTUNE_CACHE) == rt._AUTOTUNE_CACHE_MAX


def test_the_planner_needs_a_device_it_can_price(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = tc.compile_bank(BANKS["random"]())
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune_bank_dispatch(prog)
    with pytest.raises(RuntimeError, match="CUDA"):
        FilterBankEngine(prog, mode="auto")
    with pytest.raises(RuntimeError):
        cm.calibrate_backend("cuda", "cpu")
    with pytest.raises(ValueError):
        cm.calibrate_backend("interpret", "cpu")


def test_candidates_are_sorted_and_the_plan_is_the_first():
    # 32 filters: K2 and one bank tile; 300: no K2, bank tiles 152 and 32
    for bank, n in (("spread", 1 + 3), ("wide", 2 * 3)):
        prog = tc.compile_bank(BANKS[bank]())
        cands = rt.dispatch_candidates(prog, channels=2, device="cpu")
        us = [c[0].predicted_us for c in cands]
        assert us == sorted(us) and len(cands) == n
        plan, _ = autotune_bank_dispatch(prog, channels=2, device="cpu")
        assert asdict(plan) == asdict(cands[0][0])


# -- the "cuda" lane, priced on the host with given constants -----------------

CUDA_CAL = cm.BackendCalibration(
    lane="cuda", spec_call_us=20.0, spec_walk_us=0.01, spec_op_us=1e-6,
    sms=132,
    call_us=25.0, walk_us=0.05, step_us=0.0, mac_us=1e-9, unpack_us=0.0,
    byte_us=3e-7, fold_call_us=22.0, fold_byte_us=3e-7, fold_op_us=2e-7,
    spec_tc_call_us=18.0, spec_tc_byte_us=2e-7,
    source="fitted", device_name="test card")


def test_the_cuda_sweep_keeps_one_merge_and_the_default_tile(monkeypatch):
    monkeypatch.setattr(rt, "_lane_of", lambda dev: ("cuda", CUDA_CAL))
    prog = tc.compile_bank(BANKS["spread"]())
    cands = rt.dispatch_candidates(prog, channels=1, chunk_hint=4096,
                                   device="cpu")
    assert all(p.lane == "cuda" for p, _ in cands)
    sched = [p for p, _ in cands if p.mode == "scheduled"]
    assert {p.merge for p in sched} == {tc.MERGE_DEFAULT}
    assert {p.tile for p in sched} == {rt.DEFAULT_TILE}
    assert len(sched) == 1  # one bank tile for 32 filters
    spec = [p for p, _ in cands if p.mode == "specialized"][0]
    outs = 8 * rt.DEFAULT_TILE
    adds = 32 * outs * (31 // 2 + prog.mean_pulses)
    # 32 filters × 8 tiles of 512 at 16 outputs a thread: 256 warps, fewer
    # than 4 an SM of 132, so 4 outputs a thread, each filter's walk in 4
    # segments of taps (a tile's 128 threads, 4 times, in a block of 512)
    walk = 4 * (31 // 2 + prog.pulse_counts.max()) / 4
    assert spec.predicted_us == pytest.approx(20.0 + walk * 0.01
                                              + adds * 1e-6)
    wide = tc.compile_bank(BANKS["wide"]())
    assert wide.n_filters > SPECIALIZE_BANK_MAX
    assert all(p.mode == "scheduled" for p, _ in
               rt.dispatch_candidates(wide, device="cpu"))


def test_the_cuda_lane_prices_k2s_tensor_cores_by_bytes():
    """Where `specialized_route` takes the tensor cores (the fir127
    cell's 1 filter × 64 channels × 1,024 tiles), K2 is priced by its
    bytes (4 in and 4 out an output) at that design's own constants; a
    short push keeps the walk's formula; on a card of 132 SMs the
    calibration's walk probes all take the walk and its tensor-core
    probes the tensor cores."""
    outs = 64 * 1024 * 1024
    assert cm.predict_specialized_us(1, 64, 1024, 127, 263.0, cal=CUDA_CAL,
                                     tile=1024) == \
        pytest.approx(18.0 + 8 * outs * 2e-7)
    walk = 4 * (127 // 2 + 263.0) / 2  # 4 outputs a thread, 2 segments
    assert tk.specialized_walk(1, 2, 2, 1024, 132, 127, 263.0) == walk
    assert cm.predict_specialized_us(1, 2, 2, 127, 263.0, cal=CUDA_CAL,
                                     tile=1024) == pytest.approx(
        20.0 + walk * 0.01 + 2 * 2048 * (127 // 2 + 263.0) * 1e-6)
    for f, taps, n in cm.SPEC_PROBES:
        assert tk.specialized_route(f, 1, -(-n // 512), 512, 132,
                                    taps) == "walk"
    for f, taps, n in cm.SPEC_TC_PROBES:
        assert tk.specialized_route(f, 1, -(-n // 512), 512, 132,
                                    taps) == "wgmma"


def test_the_cuda_lane_prices_k1_by_its_terms_and_bytes():
    prog = tc.compile_bank(BANKS["sweep"]())
    sched = prog.schedule()
    work = tk.bank_work(sched, prog.spec.sample_bits)
    assert len(work) == len(sched.groups)
    macs = sum(t * n for t, n in work) * 64 * tk.bank_k(63) * 3 * 1024
    walk = max(n for _, n in work) * tk.bank_k(63) // 32
    want = (25.0 + walk * 0.05 + 4 * prog.n_filters * 3 * 1024 * 3e-7
            + macs * 1e-9)
    assert prog.predict_scheduled_us(3, 2, 512, cal=CUDA_CAL) == \
        pytest.approx(want)
    with pytest.raises(ValueError):
        cm.predict_scheduled_us(1, 1, 512, 32, sched.group_summaries(),
                                cal=CUDA_CAL)
    opt = tc.cse_pass(prog)
    fold = cm.predict_combine_us(opt.n_real, opt.n_shared, 3, 2, 512,
                                 cal=CUDA_CAL, nnz=opt.nnz)
    assert fold == pytest.approx(
        22.0 + 4 * 3 * 1024 * (2 * opt.n_real + opt.n_shared) * 3e-7
        + opt.nnz * 3 * 1024 * 2e-7)
    # the optimized program prices the fold kernel's table: its pairs of
    # real rows' shared rows, padding included, instead of the nonzeros
    entries = opt.fold_entries(3, 1024, CUDA_CAL)
    table = tk.combine_table(opt.combine, "cpu")
    assert entries == table.layout(table.groups_for(3, 1024, 132)).entries
    assert entries >= opt.nnz // 2
    assert opt.fold_entries(3, 1024, None) is None
    paired = cm.predict_combine_us(opt.n_real, opt.n_shared, 3, 2, 512,
                                   cal=CUDA_CAL, nnz=opt.nnz,
                                   entries=entries)
    assert paired == pytest.approx(fold + (entries - opt.nnz) * 3 * 1024
                                   * 2e-7)
    assert opt.predict_scheduled_us(3, 2, 512, cal=CUDA_CAL) == \
        pytest.approx(opt.bank.predict_scheduled_us(3, 2, 512, cal=CUDA_CAL)
                      + paired)
    with pytest.raises(ValueError):
        cm.predict_combine_us(4, 2, 1, 1, 512, cal=CUDA_CAL)
    assert cm.predict_combine_us(4, 0, 1, 1, 512, cal=CUDA_CAL) == 0.0


@pytest.mark.parametrize("bank", ["adversarial", "sweep", "spread"])
def test_k1_work_and_tables_do_not_depend_on_merge(bank):
    """K1 flattens a schedule back to its layers: its tables, hence its
    work and its output, are the same for every merge."""
    prog = tc.compile_bank(BANKS[bank]())
    base = tk.bank_terms(prog.schedule(None, 1), prog.taps, "cpu")
    for merge in (4, 8, 16, 32):
        sched = prog.schedule(None, merge)
        terms = tk.bank_terms(sched, prog.taps, "cpu")
        for name in ("digits", "tiles", "groups", "terms", "dest"):
            assert np.array_equal(getattr(terms, name), getattr(base, name))
        assert tk.bank_work(sched) == tk.bank_work(prog.schedule(None, 1))
        assert [n for _, n in tk.bank_work(sched, 32)] == \
            terms.groups[:, 1].tolist()


def test_sample_planes_of_the_cost_model():
    assert [tk.sample_plane_count(b) for b in (8, 14, 16, 20, 32)] == \
        [2, 2, 3, 3, 4]


def test_the_fit_is_nonnegative_least_squares():
    rng = np.random.default_rng(0)
    rows = [[1.0, b, m] for b, m in zip(rng.uniform(1e5, 1e8, 8),
                                        rng.uniform(1e8, 1e11, 8))]
    times = [20.0 + 3e-7 * b + 1e-9 * m for _, b, m in rows]
    assert np.allclose(cm._fit(rows, times), [20.0, 3e-7, 1e-9], rtol=1e-6)
    # a column that would come out negative is dropped, the rest refitted
    times = [20.0 - 1e-8 * b + 1e-9 * m for _, b, m in rows]
    coef = cm._fit(rows, times)
    assert (coef >= 0).all() and coef[1] == 0.0


def test_calibration_files_are_keyed_on_the_card(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    assert cm.calibration_path() == str(tmp_path / "calibration.json")
    assert cm.get_calibration("interpret") is \
        cm.REFERENCE_CALIBRATIONS["interpret"]
    monkeypatch.setattr(cm, "_device_name", lambda dev: "test card")
    assert cm.get_calibration("cuda") is None
    import json

    (tmp_path / "calibration.json").write_text(json.dumps(
        {"cuda": {"test card": asdict(CUDA_CAL),
                  "other card": asdict(replace(CUDA_CAL,
                                               device_name="other card"))}}))
    assert cm.get_calibration("cuda") == CUDA_CAL
    assert cm.ensure_calibration("cuda") == CUDA_CAL
    monkeypatch.setattr(cm, "_device_name", lambda dev: "a third card")
    assert cm.get_calibration("cuda") is None
    # an entry of another layout (a field missing) is fitted again
    old = asdict(replace(CUDA_CAL, device_name="a third card"))
    del old["spec_tc_byte_us"]
    (tmp_path / "calibration.json").write_text(json.dumps(
        {"cuda": {"a third card": old}}))
    assert cm.get_calibration("cuda") is None
    with pytest.raises(ValueError):
        cm.get_calibration("mosaic")


@pytest.mark.parametrize("probe,args", [
    ("_probe_bank", (64, 63, 600)),
    ("_probe_specialized", (3, 31, 600)),
    ("_probe_specialized_tc", (2, 31, 600)),
    ("_probe_fold", (16, 9, 4, 600, 0)),
    ("_probe_fold", (40, 30, 6, 600, 1)),  # clustered columns: pairs share
])
def test_calibration_probes_run_their_kernels(probe, args):
    """Each probe of the fit runs its kernel's wrapper (the plain version
    on the CPU) and reports the work the formula prices."""
    fn, work = getattr(cm, probe)(*args, torch.device("cpu"))
    y = fn()
    assert y.dtype == torch.int32 and all(v > 0 for v in work)
    if probe == "_probe_bank":
        b, taps, n = args
        assert work[1] == 4 * b * n and tuple(y.shape) == (b, 1, n)
    elif probe == "_probe_fold":
        n_real, n_shared, per_row, n, clustered = args
        assert work[0] == 4 * n * (2 * n_real + n_shared)
        assert tuple(y.shape) == (n_real, 1, n)
        # the work is the kernel's table entries (pairs of rows) a sample
        assert work[1] % n == 0 and work[1] // n >= n_real * per_row // 4
    elif probe == "_probe_specialized_tc":  # 4 bytes in, 4 out an output
        assert len(work) == 1 and work[0] == 8 * 2 * 1024
        assert tuple(y.shape) == (2, 1, 2, 512)
    else:
        assert len(work) == 2 and y.shape[0] == args[0]


def test_k2_keeps_four_outputs_a_thread_on_a_small_grid():
    # a tile of 512 at 16 outputs a thread is one warp a block
    assert tk.specialized_outs(1, 2, 4, 512, 132) == 4
    assert tk.specialized_outs(256, 1, 8, 512, 132) == 16  # 2,048 warps
    assert tk.specialized_outs(65, 1, 8, 512, 132) == 4  # 520 warps
    assert tk.specialized_outs(66, 1, 8, 512, 132) == 16  # 528 warps
    assert tk.specialized_outs(1, 1, 2048, 512, 132) == 16
    assert tk.specialized_outs(1, 1, 1, 512, 0) == 16  # no SMs: the default
    for tile in (128, 512, 1024, 4096):
        threads, cols, _, _ = tk.specialized_geometry(tile, 63, 100, 4)
        assert cols == threads * 4 and threads <= tk.SPECIALIZED_MAX_THREADS
        assert cols >= min(tile, tk.SPECIALIZED_MAX_THREADS * 4)
    with pytest.raises(ValueError):
        tk.specialized_geometry(512, 63, 100, 8)
