"""The port's §2.4 RLE programs, §4 machines and §3.3 counts against `repro`.

Same digits in, same codes, outputs, cycles and fit masks out: the RLE
encoders (scalar and batch) on random and adversarial digit matrices,
zero-run overflow included; the scalar `FirBlmacMachine` and the
vectorized `FirBlmacVMachine` with and without ``fused_last_add`` and
``start_overhead``; the §3.3 add counts and §4 cycle counts; the
quantizers (`po2_quantize`, `csd_plane_quantize`); the program's
memoized `machine_cycles` with its raise and counter; and Table 4 at
``n_div = 20`` against `repro` and ``BENCH_machine.json``.  Tolerance 0
everywhere: integers and exact float64 products.
"""
import json
import pathlib
from dataclasses import asdict

import numpy as np
import pytest

import repro.compiler as rc
import repro.core as rcore
import repro_torch.compiler as tc
import repro_torch.core as tcore
from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro.filters import design_bank
from repro_torch.filters import sweep_bank, sweep_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _digit_cases():
    rng = np.random.default_rng(0)
    cases = {
        "random": rng.integers(-1, 2, (5, 40, 16)).astype(np.int8),
        "sparse": (rng.integers(-1, 2, (6, 64, 17))
                   * (rng.random((6, 64, 17)) < 0.05)).astype(np.int8),
        "empty": np.zeros((3, 12, 16), np.int8),
        "adjacent": np.ones((2, 8, 5), np.int8),
        "one_pulse_each_end": np.zeros((2, 64, 16), np.int8),
        "naf_sweep": tcore.csd_digits(
            sampled_sweep_bank(127, n_div=10, n_filters=6)[:, :64], 16),
    }
    cases["one_pulse_each_end"][0, 0, 0] = 1
    cases["one_pulse_each_end"][1, 63, 15] = -1
    return cases


DIGITS = _digit_cases()


@pytest.mark.parametrize("case", sorted(DIGITS))
def test_rle_batch_and_scalar_match_reference(case):
    d = DIGITS[case]
    pb, rb = tcore.encode_digits_batch(d), rcore.encode_digits_batch(d)
    assert np.array_equal(pb.codes, rb.codes)
    assert np.array_equal(pb.n_codes, rb.n_codes)
    assert np.array_equal(pb.n_pulses, rb.n_pulses)
    assert np.array_equal(pb.fits(64), rb.fits(64))
    assert np.array_equal(tcore.code_count_batch(d),
                          rcore.code_count_batch(d))
    assert np.array_equal(tcore.max_zrun_batch(d),
                          rcore.rle.max_zrun_batch(d))
    for b in range(d.shape[0]):
        ps, rs = tcore.encode_digits(d[b]), rcore.encode_digits(d[b])
        assert ps.codes.dtype == rs.codes.dtype == np.uint8
        assert np.array_equal(ps.codes, rs.codes)
        assert np.array_equal(pb.stream(b).codes, ps.codes)
        assert (ps.n_codes, ps.n_pulses, ps.fits()) == \
            (rs.n_codes, rs.n_pulses, rs.fits())
        assert tcore.code_count(d[b]) == rcore.code_count(d[b])
        assert np.array_equal(tcore.decode_codes(ps), d[b])
        assert np.array_equal(tcore.decode_codes(ps),
                              rcore.decode_codes(rs))


@pytest.mark.parametrize("zrun_bits", [3, 6])
def test_zero_run_overflow_raises_where_reference_raises(zrun_bits):
    d = np.zeros((3, 80, 4), np.int8)
    d[0, 5, 0] = 1  # run 5
    d[1, 9, 1] = -1  # run 9
    d[2, 70, 3] = 1  # run 70
    limit = (1 << zrun_bits) - 1
    assert np.array_equal(tcore.max_zrun_batch(d), [5, 9, 70])
    assert np.array_equal(tcore.max_zrun_batch(d),
                          rcore.rle.max_zrun_batch(d))
    for b in range(3):
        ok = tcore.max_zrun_batch(d)[b] <= limit
        for enc in (tcore.encode_digits, rcore.encode_digits):
            if ok:
                enc(d[b], zrun_bits=zrun_bits)
            else:
                with pytest.raises(ValueError, match="ZRUN"):
                    enc(d[b], zrun_bits=zrun_bits)
    for enc in (tcore.encode_digits_batch, rcore.encode_digits_batch):
        with pytest.raises(ValueError, match="ZRUN"):
            enc(d, zrun_bits=zrun_bits)
    # trailing zeros are never encoded: a pulse-free tail does not count
    tail = np.zeros((1, 100, 2), np.int8)
    tail[0, 0, 0] = 1
    assert tcore.max_zrun_batch(tail)[0] == 0
    tcore.encode_digits_batch(tail, zrun_bits=zrun_bits)


def test_rle_refuses_what_the_reference_refuses():
    bad = [np.zeros(5), np.zeros((2, 3, 4, 5))]
    for enc in (tcore.encode_digits, tcore.encode_digits_batch):
        for d in bad:
            with pytest.raises(ValueError):
                enc(d)
    s = tcore.encode_digits(np.ones((4, 2), np.int8))
    truncated = tcore.RleStream(s.codes[:-1], 4, 2)
    with pytest.raises(ValueError, match="EORs"):
        tcore.decode_codes(truncated)
    with pytest.raises(ValueError):
        tcore.code_count_batch(np.zeros(3))


SPECS = {
    "paper": {},
    "fused": {"fused_last_add": True},
    "overhead": {"start_overhead": 2},
    "fused_overhead": {"fused_last_add": True, "start_overhead": 1},
    "small_memory": {"weight_mem_codes": 150},
    "narrow_zrun": {"zrun_bits": 4},
}


def _spec_pair(taps, **kw):
    return tcore.MachineSpec(taps=taps, **kw), rcore.MachineSpec(taps=taps,
                                                                 **kw)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("bank", ["sweep127", "random31", "adversarial31"])
def test_machines_match_reference(spec_name, bank):
    q = {"sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=6,
                                                seed=3),
         "random31": lambda: random_type1_bank(5, 31, seed=4, density=0.5),
         "adversarial31": lambda: adversarial_bank(31, seed=2)}[bank]()
    taps = q.shape[1]
    pspec, rspec = _spec_pair(taps, **SPECS[spec_name])
    assert asdict(pspec) == asdict(rspec)
    assert (pspec.n_half, pspec.n_layers) == (rspec.n_half, rspec.n_layers)
    x = np.random.default_rng(5).integers(-128, 128, taps - 1 + 20)

    pvm, rvm = tcore.FirBlmacVMachine(pspec), rcore.FirBlmacVMachine(rspec)
    fits = pvm.program_bank(q)
    assert np.array_equal(fits, rvm.program_bank(q))
    assert np.array_equal(pvm.code_counts, rvm.code_counts)
    pres, rres = pvm.run(x), rvm.run(x)
    assert np.array_equal(pres.outputs, rres.outputs)
    assert np.array_equal(pres.cycles, rres.cycles)
    assert np.array_equal(pres.fits, rres.fits)
    assert pres.mean_cycles == rres.mean_cycles
    if fits.any():
        assert pres.mean_cycles_fitting == rres.mean_cycles_fitting
    assert np.array_equal(
        pres.cycles[:, 0],
        tcore.machine_cycles_batch(q, pspec.n_layers, pspec.start_overhead,
                                   pspec.fused_last_add))
    if fits.all():
        pb, rb = pvm.programs(), rvm.programs()
        assert np.array_equal(pb.codes, rb.codes)
    one = tcore.simulate_bank(q, x, pspec)
    assert np.array_equal(one.outputs, pres.outputs)

    for b in range(q.shape[0]):
        pm, rm = tcore.FirBlmacMachine(pspec), rcore.FirBlmacMachine(rspec)
        try:
            rs = rm.program(q[b])
        except ValueError as e:
            assert not fits[b]
            with pytest.raises(ValueError, match=str(e).split()[0]):
                pm.program(q[b])
            continue
        ps = pm.program(q[b])
        assert fits[b]
        assert np.array_equal(ps.codes, rs.codes)
        pr, rr = pm.run(x), rm.run(x)
        assert np.array_equal(pr.outputs, rr.outputs)
        assert np.array_equal(pr.cycles, rr.cycles)
        assert np.array_equal(pr.outputs, pres.outputs[b])
        assert np.array_equal(pr.cycles, pres.cycles[b])
        assert pr.mean_cycles == rr.mean_cycles


def test_machines_refuse_what_the_reference_refuses():
    spec = tcore.MachineSpec(taps=15)
    good = random_type1_bank(2, 15, seed=1, density=0.5)
    bad = {
        "taps": np.zeros((2, 13), np.int64),
        "asymmetric": np.arange(15)[None],
        "range": np.full((1, 15), 1 << 15),
    }
    for q in bad.values():
        for vm in (tcore.FirBlmacVMachine(spec),
                   rcore.FirBlmacVMachine(rcore.MachineSpec(taps=15))):
            with pytest.raises(ValueError):
                vm.program_bank(q)
        with pytest.raises(ValueError):
            tcore.FirBlmacMachine(spec).program(q[0])
    with pytest.raises(RuntimeError):
        tcore.FirBlmacMachine(spec).run(np.zeros(20))
    with pytest.raises(RuntimeError):
        tcore.FirBlmacVMachine(spec).run(np.zeros(20))
    m = tcore.FirBlmacMachine(spec)
    m.program(good[0])
    for x in (np.full(20, 128), np.zeros(10)):
        with pytest.raises(ValueError):
            m.run(x)
    vm = tcore.FirBlmacVMachine(spec)
    vm.program_bank(good)
    for x in (np.full(20, -129), np.zeros(10), np.zeros((2, 20))):
        with pytest.raises(ValueError):
            vm.run(x)


def test_vmachine_runs_the_bank_in_chunks(monkeypatch):
    """`run` takes the bank `BANK_CHUNK` rows a pass; a pass boundary
    inside the bank changes no output."""
    from repro_torch.core import vmachine

    q = random_type1_bank(7, 31, seed=8, density=0.4)
    x = np.random.default_rng(9).integers(-128, 128, 60)
    want = rcore.simulate_bank(q, x, rcore.MachineSpec(taps=31))
    monkeypatch.setattr(vmachine, "BANK_CHUNK", 3)
    got = tcore.simulate_bank(q, x, tcore.MachineSpec(taps=31))
    assert np.array_equal(got.outputs, want.outputs)
    assert np.array_equal(got.cycles, want.cycles)


def test_layer_sums_keep_their_exactness_raise():
    from repro.core.vmachine import _layer_sums as ref_sums
    from repro_torch.core.vmachine import _layer_sums

    d = np.ones((1, 64, 2), np.int8)
    u = np.ones((64, 3), np.int64)
    assert np.array_equal(_layer_sums(d, u, 8), ref_sums(d, u, 8))
    for sums in (_layer_sums, ref_sums):
        with pytest.raises(ValueError, match="not exact"):
            sums(d, u, 50)


COUNT_BANKS = {
    "sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=10),
    "sweep55": lambda: sampled_sweep_bank(55, n_div=10, n_filters=10),
    "random255": lambda: random_type1_bank(4, 255, seed=2),
    "adversarial": lambda: adversarial_bank(31),
}


@pytest.mark.parametrize("bank", sorted(COUNT_BANKS))
def test_paper_counts_match_reference(bank):
    q = COUNT_BANKS[bank]()
    taps = q.shape[1]
    pa, ra = (tcore.fir_blmac_additions_batch(q),
              rcore.fir_blmac_additions_batch(q))
    assert np.array_equal(pa, ra)
    assert [tcore.fir_blmac_additions(w) for w in q] == \
        [rcore.fir_blmac_additions(w) for w in q] == list(pa)
    assert np.array_equal(tcore.adds_per_coeff(pa, taps),
                          rcore.adds_per_coeff(ra, taps))
    assert np.array_equal(tcore.adds_per_tap(pa, taps),
                          rcore.adds_per_tap(ra, taps))
    assert tcore.classical_equivalent_adds(taps) == \
        rcore.classical_equivalent_adds(taps)
    assert tcore.classical_equivalent_adds(taps, 7) == \
        rcore.classical_equivalent_adds(taps, 7)
    for kw in ({}, {"overhead": 2}, {"fused_last_add": True},
               {"n_layers": 17, "overhead": 1, "fused_last_add": True}):
        assert np.array_equal(tcore.machine_cycles_batch(q, **kw),
                              rcore.machine_cycles_batch(q, **kw))
    for w in q[:3]:
        assert tcore.machine_cycles(w) == rcore.machine_cycles(w)
        assert tcore.machine_cycles(w, 17, 2) == rcore.machine_cycles(w, 17, 2)
    with pytest.raises(ValueError, match="odd"):
        tcore.fir_blmac_additions(np.zeros(4))


def test_po2_quantize_matches_reference():
    bank = design_bank(127, [("lowpass", 0.23), ("bandpass", (0.2, 0.5)),
                             ("highpass", 0.61)])
    edge = np.array([0.5, -0.25, 1e-9, 0.0])
    for h in (*bank, edge, np.zeros(5), np.array([-1.0, 1.0])):
        for bits in (8, 12, 16):
            pq, pk = tcore.po2_quantize(h, bits)
            rq, rk = rcore.po2_quantize(h, bits)
            assert pq.dtype == rq.dtype and np.array_equal(pq, rq)
            assert pk == rk
            assert np.array_equal(tcore.dequantize(pq, pk),
                                  rcore.dequantize(rq, rk))
    pq, pk = tcore.po2_quantize_batch(bank, 16)
    rq, rk = rcore.po2_quantize_batch(bank, 16)
    assert np.array_equal(pq, rq) and np.array_equal(pk, rk)


@pytest.mark.parametrize("keep", [None, 1, 3])
def test_csd_plane_quantize_matches_reference(keep):
    w = np.random.default_rng(4).standard_normal((3, 5, 40)) * 0.1
    p = tcore.csd_plane_quantize(w, 12, keep)
    r = rcore.csd_plane_quantize(w, 12, keep)
    assert np.array_equal(p.planes_packed, r.planes_packed)
    assert (p.n_digits, p.n, p.exponent, p.keep_planes,
            p.bits_per_weight) == (r.n_digits, r.n, r.exponent,
                                   r.keep_planes, r.bits_per_weight)
    assert np.array_equal(tcore.plane_dequantize(p),
                          rcore.plane_dequantize(r))
    if keep is None:  # untruncated: the po2 grid exactly
        q, k = tcore.po2_quantize(w, 12)
        assert np.array_equal(tcore.plane_dequantize(p),
                              tcore.dequantize(q, k))


def test_core_exports_what_the_reference_exports():
    later = {"predict_recovery_us"}  # the session server's (queue 1, item 6)
    missing = set(rcore.__all__) - set(tcore.__all__) - later
    assert not missing
    for name in ("csd_truncate", "layer_pulse_counts", "max_pulses",
                 "ntrits_table", "num_pulses", "max_zrun_batch"):
        assert name in tcore.__all__


PROGRAM_BANKS = {
    "sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=12,
                                           seed=4),
    "random63": lambda: random_type1_bank(6, 63, seed=6, density=0.5),
    "adversarial": lambda: adversarial_bank(31, seed=3),
    "narrow": lambda: random_type1_bank(4, 15, coeff_bits=6, seed=7),
}


@pytest.mark.parametrize("bank", sorted(PROGRAM_BANKS))
def test_program_machine_cycles_match_reference(bank):
    q = PROGRAM_BANKS[bank]()
    taps = q.shape[1]
    port, ref = tc.compile_bank(q), rc.compile_bank(q)
    assert port.key == ref.key
    for kw in ({}, {"fused_last_add": True}, {"start_overhead": 3},
               {"coeff_bits": 18}, {"coeff_bits": 20, "fused_last_add": True}):
        pspec, rspec = _spec_pair(taps, **kw)
        got = port.machine_cycles(pspec)
        assert np.array_equal(got, ref.machine_cycles(rspec))
        assert np.array_equal(got, tcore.machine_cycles_batch(
            q, pspec.n_layers, pspec.start_overhead, pspec.fused_last_add))
        assert not got.flags.writeable
    assert np.array_equal(port.machine_cycles(), ref.machine_cycles())


def test_program_machine_cycles_memo_counter_and_raise(tmp_path):
    tc.clear_caches()
    q = sampled_sweep_bank(127, n_div=10, n_filters=5, seed=8)
    prog = tc.compile_bank(q)
    key = prog.key
    a = prog.machine_cycles()
    assert prog.machine_cycles() is a  # memoized per spec parameters
    assert prog.machine_cycles(tcore.MachineSpec(taps=127)) is a
    assert tc.cache_stats()["counters"]["machine_cycle_computes"] == 1
    prog.machine_cycles(tcore.MachineSpec(taps=127, fused_last_add=True))
    assert tc.cache_stats()["counters"]["machine_cycle_computes"] == 2
    # the memo is no part of the key or the file
    assert prog.key == key
    path = tmp_path / "prog.npz"
    prog.save(path)
    for loaded in (tc.BlmacProgram.load(path), rc.BlmacProgram.load(path)):
        assert loaded.key == key
        assert np.array_equal(loaded.machine_cycles(), a)
    with pytest.raises(ValueError, match="taps"):
        prog.machine_cycles(tcore.MachineSpec(taps=63))
    # a bank populating a layer the spec lacks raises, as the reference's
    wide = q.copy()
    wide[0, 63] = (1 << 15) - 1
    wprog, wref = tc.compile_bank(wide), rc.compile_bank(wide)
    for p, spec in ((wprog, tcore.MachineSpec(taps=127, coeff_bits=8)),
                    (wref, rcore.MachineSpec(taps=127, coeff_bits=8))):
        with pytest.raises(ValueError, match="populates CSD layer"):
            p.machine_cycles(spec)


def test_engine_predicted_cycles_read_the_program():
    from repro_torch.filters import FilterBankEngine

    q = sampled_sweep_bank(127, n_div=10, n_filters=6, seed=9)
    prog = tc.compile_bank(q)
    eng = FilterBankEngine(prog, mode="packed", device="cpu")
    spec = tcore.MachineSpec(taps=127, fused_last_add=True)
    assert eng.predicted_machine_cycles(spec) is prog.machine_cycles(spec)
    assert eng.predicted_mean_cycles() == \
        float(rc.compile_bank(q).machine_cycles().mean())


def _table4(n_div, core):
    bank = sweep_bank(127, n_div, "hamming", sweep_specs(n_div))
    q, _ = core.po2_quantize_batch(bank, bits=16)
    spec = core.MachineSpec(taps=127)
    vm = core.FirBlmacVMachine(spec)
    fits = vm.program_bank(q)
    x = np.random.default_rng(0).integers(-128, 128, 127 - 1 + 4)
    res = vm.run(x)
    fused = core.machine_cycles_batch(q, fused_last_add=True)
    return {"mean_cycles_all": float(res.cycles.mean()),
            "fused_mean_cycles_all": float(fused.mean()),
            "pct_not_fitting": float(100 * (~fits).mean()),
            "mean_cycles_fitting": float(res.cycles[fits].mean()),
            "n_filters": int(q.shape[0])}, q


def test_table4_at_n_div_20_matches_reference_and_baseline():
    port, q = _table4(20, tcore)
    ref, rq = _table4(20, rcore)
    assert np.array_equal(q, rq)
    assert port == ref
    committed = json.loads((ROOT / "BENCH_machine.json").read_text())
    grid = committed["grids"]["20"]
    for k, v in port.items():
        assert v == grid[k], k
    assert port["mean_cycles_all"] == pytest.approx(213.12894736842105,
                                                    abs=0)
    assert port["pct_not_fitting"] == pytest.approx(9.736842105263158, abs=0)
    prog = tc.compile_bank(q)
    assert prog.machine_cycles().mean() == port["mean_cycles_all"]
