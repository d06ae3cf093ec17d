"""The port's compiler against the reference's, field for field.

Same bank in, same program out: content key, packed trits, quantized
coefficients, exponents and every field of the superlayer schedule must
be equal (tolerance 0 — these are integers and digests).  Programs
(CSE-optimized ones too) and tail snapshots saved by one package load in
the other.
"""
import numpy as np
import pytest

import repro.compiler as rc
import repro_torch.compiler as tc
from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro.filters import sweep_bank as ref_sweep_bank
from repro_torch.filters import sweep_bank

BANKS = {
    "random": lambda: random_type1_bank(37, 31, seed=3),
    "sparse": lambda: random_type1_bank(20, 63, seed=4, density=0.25),
    "adversarial": lambda: adversarial_bank(31, seed=5),
    "sweep": lambda: sampled_sweep_bank(127, n_div=10, n_filters=24, seed=6),
}


def _assert_same_program(port, ref):
    assert port.key == ref.key
    for name in ("qbank", "exponents", "packed", "occupancy", "signatures",
                 "pulse_counts"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.pulse_schedules() == ref.pulse_schedules()
    assert np.array_equal(port.half_digits(), ref.half_digits())


@pytest.mark.parametrize("merge", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_same_program_and_schedule(bank, merge):
    q = BANKS[bank]()
    port, ref = tc.compile_bank(q), rc.compile_bank(q)
    _assert_same_program(port, ref)
    for bank_tile in (None, 8):
        ps = port.schedule(bank_tile, merge)
        rs = ref.schedule(bank_tile, merge)
        assert (ps.tile_size, ps.merge, ps.n_filters) == \
            (rs.tile_size, rs.merge, rs.n_filters)
        assert np.array_equal(ps.perm, rs.perm)
        assert np.array_equal(ps.inv, rs.inv)
        assert len(ps.groups) == len(rs.groups)
        for pg, rg in zip(ps.groups, rs.groups):
            assert pg.schedule == rg.schedule
            assert pg.tail_shift == rg.tail_shift
            assert pg.sel_layers == rg.sel_layers
            assert pg.n_filters == rg.n_filters
            assert np.array_equal(pg.packed, rg.packed)


def test_float_bank_quantizes_identically():
    h = sweep_bank(55, n_div=8)
    assert np.array_equal(h, ref_sweep_bank(55, n_div=8))
    _assert_same_program(tc.compile_bank(h), rc.compile_bank(h))


def test_compile_packed_same_key():
    ref = rc.compile_bank(random_type1_bank(6, 15, seed=7))
    port = tc.compile_packed(ref.packed, 15)
    assert port.key == rc.compile_packed(ref.packed, 15).key
    assert np.array_equal(port.qbank, ref.qbank)


def test_program_saved_by_reference_loads_in_port(tmp_path):
    ref = rc.compile_bank(random_type1_bank(9, 63, seed=8))
    path = tmp_path / "ref.npz"
    ref.save(path)
    tc.clear_caches()  # force a real load, not a cache hit
    port = tc.BlmacProgram.load(path)
    _assert_same_program(port, ref)


def test_program_saved_by_port_loads_in_reference(tmp_path):
    port = tc.compile_bank(random_type1_bank(9, 63, seed=9))
    path = tmp_path / "port.npz"
    port.save(path)
    rc.clear_caches()
    ref = rc.BlmacProgram.load(path)
    _assert_same_program(port, ref)


def _assert_same_optimized(port, ref):
    _assert_same_program(port, ref)
    assert type(port).__name__ == type(ref).__name__ == "OptimizedProgram"
    assert port.parent_key == ref.parent_key and port.level == ref.level
    for name in ("combine", "use_counts"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert np.array_equal(port.effective_qbank(), ref.effective_qbank())


def test_port_refuses_a_cse_program_file(tmp_path):
    """A CSE program file written by either package loads in the other
    under the same key with the same arrays; one whose combine matrix was
    tampered with is refused."""
    q = sampled_sweep_bank(63, n_div=10, n_filters=12)
    ref = rc.cse_pass(rc.compile_bank(q))
    path = tmp_path / "cse.npz"
    ref.save(path)
    tc.clear_caches()  # a real load, not a memo hit
    port = tc.BlmacProgram.load(path)
    _assert_same_optimized(port, ref)
    back = tmp_path / "cse_port.npz"
    tc.cse_pass(tc.compile_bank(q)).save(back)
    rc.clear_caches()
    _assert_same_optimized(port, rc.BlmacProgram.load(back))
    with np.load(path) as z:
        arrays = dict(z)
    arrays["combine"] = arrays["combine"].copy()
    arrays["combine"][0, 0] += 1
    np.savez(path, **arrays)
    tc.clear_caches()
    with pytest.raises(tc.ProgramFormatError, match="key"):
        tc.BlmacProgram.load(path)


def test_load_rejects_a_corrupted_file(tmp_path):
    prog = tc.compile_bank(random_type1_bank(3, 15, seed=10))
    path = tmp_path / "p.npz"
    prog.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["qbank"] = arrays["qbank"] + 1
    np.savez(path, **arrays)
    with pytest.raises(tc.ProgramFormatError):
        tc.BlmacProgram.load(path)


def test_program_from_arrays_same_key():
    ref = rc.compile_bank(sampled_sweep_bank(127, n_div=10, n_filters=16))
    port = tc.program_from_arrays(
        np.asarray(ref.qbank), np.asarray(ref.exponents), np.asarray(ref.packed)
    )
    _assert_same_program(port, ref)
    bad = np.array(ref.qbank)
    bad[0, 0] += 1
    with pytest.raises(ValueError):
        tc.program_from_arrays(bad, ref.exponents, ref.packed)


def test_tail_snapshot_round_trips_across_packages(tmp_path):
    from repro.filters import FilterBankEngine as RefEngine
    from repro_torch.filters import FilterBankEngine as PortEngine

    q = random_type1_bank(4, 15, seed=11) >> 4
    x = np.random.default_rng(12).integers(-128, 128, (2, 300))
    port = PortEngine(q, channels=2, tile=128, mode="packed", device="cpu")
    ref = RefEngine(q, channels=2, tile=128, mode="packed", lane="xla")
    port.push(x[:, :100])
    path = tmp_path / "tail.npz"
    port.snapshot_tail(session="s1").save(path)
    snap = rc.TailSnapshot.load(path)
    assert snap.session == "s1" and snap.samples_in == 100
    ref.restore_tail(snap)
    assert np.array_equal(ref.push(x[:, 100:]), port.push(x[:, 100:]))
    ref.snapshot_tail().save(path)
    fresh = PortEngine(q, channels=2, tile=128, mode="packed", device="cpu")
    fresh.restore_tail(tc.TailSnapshot.load(path))
    assert fresh.samples_in == 300
    assert np.array_equal(fresh.push(x[:, :50]), ref.push(x[:, :50]))


def test_cache_stats_count_one_compile_per_bank():
    tc.clear_caches()
    q = random_type1_bank(5, 31, seed=13)
    a = tc.compile_bank(q)
    assert tc.compile_bank(q) is a
    assert tc.compile_packed(a.packed, 31) is a
    a.schedule()
    a.schedule()
    stats = tc.cache_stats()
    assert stats["counters"]["csd_packings"] == 1
    assert stats["counters"]["schedule_plans"] == 1
    assert stats["program"]["hits"] >= 2
