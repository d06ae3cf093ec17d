"""The port's CSE pass, optimized programs, engine and fold against `repro`.

Same parent in, same optimized program out: content key, packed trits,
combine matrix, use counts and effective coefficients (tolerance 0 —
integers and digests), the same decline, cap and memo behaviour, files
that move between the packages.  An engine serving an optimized program
(every mode, ragged pushes, 8-bit and full-range int32 samples) equals
the reference's engine and the numpy oracle modulo 2**32; the plain fold
`combine_plain` equals the reference's int32 GEMM `_combine_shared` and
its host fold `_host_combine_i32`, wrap past 2**31 included.
"""
import importlib
from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.compiler as rc
import repro_torch.compiler as tc
from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro.compiler.lowering import _host_combine_i32
from repro.filters import FilterBankEngine as RefEngine
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro.kernels.blmac_fir import _combine_shared
from repro.kernels.runtime import autotune_bank_dispatch as ref_autotune
from repro_torch.compiler.optimize import CSE_MEMO_MAX, OptimizedProgram
from repro_torch.filters import FilterBankEngine

tk = importlib.import_module("repro_torch.kernels.blmac_fir")

BANKS = {
    "random": lambda: random_type1_bank(12, 31, seed=3),
    "random_wide": lambda: random_type1_bank(40, 63, seed=4),
    "sweep": lambda: sampled_sweep_bank(31, n_div=10, n_filters=12),
    "sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=24,
                                           seed=6),
    "adversarial": lambda: adversarial_bank(31, seed=5),
    "spread": lambda: spread_lowpass_qbank(32, 31),
}


def _pair(name, **kw):
    q = BANKS[name]()
    return (tc.cse_pass(tc.compile_bank(q), **kw),
            rc.cse_pass(rc.compile_bank(q), **kw), q)


def _assert_same(port, ref):
    assert port.key == ref.key
    assert type(port).__name__ == type(ref).__name__
    for name in ("qbank", "exponents", "packed", "occupancy", "signatures",
                 "pulse_counts"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.total_adds() == ref.total_adds()
    assert port.out_filters == ref.out_filters
    assert port.mean_pulses == ref.mean_pulses
    if isinstance(port, OptimizedProgram):
        for name in ("combine", "use_counts"):
            a, b = getattr(port, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (port.n_real, port.n_shared) == (ref.n_real, ref.n_shared)
        assert port.parent_key == ref.parent_key
        assert np.array_equal(port.effective_qbank(), ref.effective_qbank())
        assert np.array_equal(port.effective_qbank(), port.parent.qbank)
        assert np.array_equal(port.half_digits(), ref.half_digits())


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_cse_pass_matches_reference(bank):
    port, ref, _ = _pair(bank)
    assert isinstance(port, OptimizedProgram)
    _assert_same(port, ref)
    assert port.total_adds() < port.parent.total_adds()


@pytest.mark.parametrize("case", ["single_pulses", "one_filter", "empty"])
def test_cse_pass_declines_where_reference_declines(case):
    bank = np.zeros((3, 15), np.int64)
    if case == "single_pulses":
        bank[:, 7] = [64, 96, 160]  # at most one pair a row: nothing pays
    elif case == "one_filter":
        bank = sampled_sweep_bank(15, n_div=10, n_filters=1, seed=2)
    port, ref = tc.compile_bank(bank), rc.compile_bank(bank)
    assert (tc.cse_pass(port) is port) == (rc.cse_pass(ref) is ref)
    assert tc.cse_pass(port) is port


@pytest.mark.parametrize("cap", [1, 3, 10])
def test_max_shared_caps_the_virtual_rows(cap):
    port, ref, _ = _pair("sweep127", max_shared=cap)
    _assert_same(port, ref)
    assert port.n_shared == min(cap, tc.cse_pass(port.parent).n_shared)
    assert port is not tc.cse_pass(port.parent)  # the cap is in the memo key


def test_cse_pass_refuses_what_the_reference_refuses():
    prog = tc.compile_bank(BANKS["random"]())
    with pytest.raises(NotImplementedError, match="ilp|integer"):
        tc.cse_pass(prog, level="ilp")
    with pytest.raises(ValueError):
        tc.cse_pass(prog, level=3)
    with pytest.raises(TypeError):
        tc.cse_pass(BANKS["random"]())
    opt = tc.cse_pass(prog)
    assert tc.cse_pass(opt) is opt  # idempotent


def test_the_memo_mines_once_per_parent():
    tc.clear_caches()
    prog = tc.compile_bank(BANKS["sweep"]())
    first = tc.cse_pass(prog)
    assert tc.cse_pass(prog) is first
    stats = tc.cache_stats()
    assert stats["counters"]["cse_passes"] == 1
    assert (stats["cse"]["hits"], stats["cse"]["misses"]) == (1, 1)
    assert stats["cse"]["size"] == 1
    tc.clear_caches()
    assert tc.cache_stats()["cse"] == {"hits": 0, "misses": 0, "size": 0}
    assert CSE_MEMO_MAX >= 1


@pytest.mark.parametrize("tamper", ["combine", "use_counts", "parent_key"])
def test_a_tampered_combine_is_rejected_on_load(tmp_path, tamper):
    import json

    port, _, _ = _pair("random")
    path = tmp_path / "cse.npz"
    port.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    if tamper == "combine":
        arrays["combine"] = arrays["combine"] * 2
    elif tamper == "use_counts":
        arrays["use_counts"] = arrays["use_counts"][:-1]
    else:
        header = json.loads(str(arrays["header"][()]))
        header["cse"]["parent_key"] = "0" * 64
        arrays["header"] = np.array(json.dumps(header))
    np.savez(path, **arrays)
    tc.clear_caches()
    with pytest.raises(tc.ProgramFormatError):
        tc.BlmacProgram.load(path)


def test_program_from_arrays_rebuilds_an_optimized_program():
    _, ref, _ = _pair("sweep127")
    tc.clear_caches()
    port = tc.program_from_arrays(ref.qbank, ref.exponents, ref.packed,
                                  combine=ref.combine,
                                  use_counts=ref.use_counts, level=ref.level)
    _assert_same(port, ref)
    bad = np.array(ref.combine)
    bad[0, np.argmax(bad[0] != 0)] += 1
    with pytest.raises(ValueError):
        tc.program_from_arrays(ref.qbank, ref.exponents, ref.packed,
                               combine=bad, use_counts=ref.use_counts[:-1])


def test_optimized_program_views_and_what_waits():
    port, ref, _ = _pair("sweep")
    bank = port.bank
    assert type(bank) is tc.BlmacProgram and bank is port.bank
    assert bank.key == ref.bank.key
    assert np.array_equal(bank.packed, port.packed)
    for call in (lambda: port.select([0]), lambda: port.partition(2)):
        with pytest.raises(NotImplementedError):
            call()
    for name in ("machine_cycles", "shared_cycles"):
        got = getattr(port, name)()
        assert got.dtype == np.int64
        assert np.array_equal(got, getattr(ref, name)()), name


# -- the engine serving an optimized program ---------------------------------

SAMPLES = {"8bit": (-128, 128), "int32": (-(1 << 31), 1 << 31)}
CUTS = [0, 13, 30, 31, 300, 301, 700]


def _wrapped_oracle(x, q):
    return fir_bit_layers_batch(x, q).astype(np.int32)  # modulo 2**32


@pytest.mark.parametrize("samples", sorted(SAMPLES))
@pytest.mark.parametrize("mode", ["auto", "packed", "specialized"])
@pytest.mark.parametrize("bank", ["adversarial", "spread", "sweep"])
def test_engine_with_optimized_program_matches_reference(bank, mode, samples):
    port_opt, ref_opt, q = _pair(bank)
    x = np.random.default_rng(7).integers(*SAMPLES[samples], (2, CUTS[-1]))
    port = FilterBankEngine(port_opt, channels=2, tile=128, mode=mode,
                            device="cpu")
    # the reference's interpreted specialized path compiles a program per
    # filter: its packed engine computes the same function, and its engine
    # runs in the port's mode on the smallest bank
    ref_mode = mode if bank == "adversarial" else "packed"
    ref = RefEngine(ref_opt, channels=2, tile=128, mode=ref_mode,
                    interpret=True)
    assert port.n_filters == ref.n_filters == len(q)
    assert np.array_equal(port.qbank, ref.qbank)
    if mode == "auto":
        plan, _ = ref_autotune(ref_opt, channels=2, tile=128)
        assert asdict(port.dispatch_plan) == asdict(plan)
        want = ref_opt.parent if plan.cse == "declined" else ref_opt
        assert port.program.key == want.key
    outs = []
    for a, b in zip(CUTS, CUTS[1:]):
        got, want = port.push(x[:, a:b]), ref.push(x[:, a:b])
        assert got.dtype == np.int32 and np.array_equal(got, want), (a, b)
        outs.append(got)
    assert np.array_equal(np.concatenate(outs, axis=2), _wrapped_oracle(x, q))


@pytest.mark.parametrize("mode", ["packed", "specialized"])
def test_optimized_engine_snapshot_and_lanes(mode):
    port_opt, _, q = _pair("sweep")
    x = np.random.default_rng(8).integers(-128, 128, (2, 600))
    eng = FilterBankEngine(port_opt, channels=2, tile=128, mode=mode,
                           device="cpu")
    eng.push(x[:, :250])
    snap = eng.snapshot_tail()
    assert snap.program_key == port_opt.key
    again = FilterBankEngine(port_opt, channels=2, tile=128, mode=mode,
                             device="cpu")
    again.restore_tail(snap)
    assert np.array_equal(again.push(x[:, 250:]), eng.push(x[:, 250:]))
    assert np.array_equal(again.push(x[:, :0]).shape, (len(q), 2, 0))
    pending = eng.pending
    assert np.array_equal(eng.apply_lanes(x), _wrapped_oracle(x, q))
    assert eng.pending == pending


# -- the fold -----------------------------------------------------------------

def _fold_case(n_real, n_shared, seed, wide):
    rng = np.random.default_rng(seed)
    combine = np.zeros((n_real, n_shared), np.int64)
    mask = rng.random(combine.shape) < 0.3
    top = 24 if wide else 14
    combine[mask] = rng.choice([-1, 1], mask.sum()) << rng.integers(
        0, top, mask.sum())
    combine[0] = 0  # a real row with no shared row
    y = rng.integers(-(1 << 31), 1 << 31, (n_real + n_shared, 2, 37)) \
        .astype(np.int32)
    return y, combine


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", [(4, 1), (9, 5), (64, 40)])
def test_combine_plain_matches_the_reference_folds(shape, wide):
    import jax.numpy as jnp

    y, combine = _fold_case(*shape, seed=sum(shape), wide=wide)
    n_real = shape[0]
    got = tk.combine_plain(torch.from_numpy(y), combine, n_real)
    assert got.dtype == torch.int32
    host = _host_combine_i32(y, combine, n_real)
    xla = np.asarray(_combine_shared(jnp.asarray(y),
                                     jnp.asarray(combine.astype(np.int32)),
                                     n_real))
    assert np.array_equal(got.numpy(), host)
    assert np.array_equal(got.numpy(), xla)
    # the sums do wrap: the exact values leave int32
    exact = y[:n_real].astype(np.int64) + np.tensordot(
        combine, y[n_real:].astype(np.int64), axes=1)
    assert np.abs(exact).max() >= 1 << 31


def test_combine_table_and_fold_in_place_on_the_cpu():
    y, combine = _fold_case(9, 5, seed=3, wide=True)
    table = tk.combine_table(combine, "cpu")
    assert tk.combine_table(combine, "cpu") is table
    dense = np.zeros(combine.shape, np.uint32)
    for r in range(table.n_real):
        lo, hi = table.row_ptr[r], table.row_ptr[r + 1]
        assert np.all(np.diff(table.cols[lo:hi]) > 0)
        dense[r, table.cols[lo:hi]] = table.coeffs[lo:hi].view(np.uint32)
    assert np.array_equal(dense, combine.astype(np.uint32))
    assert table.nnz == np.count_nonzero(combine)
    yt = torch.from_numpy(y.copy())
    tk.reset_launch_counts()
    out = tk.combine_fold(yt, table)
    assert out.data_ptr() == yt.data_ptr() and out.shape[0] == 9
    assert np.array_equal(out.numpy(), _host_combine_i32(y, combine, 9))
    assert np.array_equal(yt[9:].numpy(), y[9:])  # shared rows untouched
    assert tk.combine_fold.launches == 0  # the plain version, not a launch
    with pytest.raises(ValueError):
        tk.combine_fold(yt[:-1], table)
    with pytest.raises(ValueError):
        tk.combine_fold(yt.to(torch.int64), table)


def test_blmac_fir_bank_folds_an_optimized_bank():
    port_opt, _, q = _pair("spread")
    x = torch.from_numpy(np.random.default_rng(9).integers(-128, 128,
                                                           (2, 500)))
    sched = port_opt.schedule()
    y = tk.blmac_fir_bank(x, port_opt.packed, port_opt.taps, 128,
                          schedule=sched, combine=port_opt.combine,
                          n_real=port_opt.n_real)
    assert y.shape == (len(q), 2, 500 - q.shape[1] + 1)
    assert np.array_equal(y.numpy(), _wrapped_oracle(x.numpy(), q))
    with pytest.raises(ValueError):
        tk.blmac_fir_bank(x, port_opt.packed, port_opt.taps, 128,
                          schedule=sched, combine=port_opt.combine, n_real=3)
