"""The port's streaming engine against the reference's, chunk for chunk.

The ragged-chunk cases of `tests/test_bank.py`, each pushed through
`repro_torch.filters.FilterBankEngine` (on the CPU, i.e. the kernels'
plain versions) and `repro.filters.FilterBankEngine` (its compiled XLA
lane for the packed mode, the interpreted specialized kernel for the
specialized mode); every chunk must be equal (tolerance 0).  Also the
bank call on the raw packed operand (`pack_bank_trits`) against the
reference's call on the same words.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential import adversarial_bank, sampled_sweep_bank
from repro.filters import FilterBankEngine as RefEngine
from repro.filters import fir_bit_layers_batch
from repro.kernels.blmac_fir import blmac_fir_bank as ref_bank
from repro_torch.compiler import compile_bank
from repro_torch.filters import FilterBankEngine
from repro_torch.kernels import pack_bank_trits
from repro_torch.kernels.blmac_fir import blmac_fir_bank

MODES = ["packed", "specialized"]


def _pair(q, channels, tile, mode):
    ref_kw = {"lane": "xla"} if mode == "packed" else {"interpret": True}
    return (FilterBankEngine(q, channels=channels, tile=tile, mode=mode,
                             device="cpu"),
            RefEngine(q, channels=channels, tile=tile, mode=mode, **ref_kw))


def _stream(port, ref, x, cuts):
    outs = []
    for a, b in zip(cuts, cuts[1:]):
        got, want = port.push(x[:, a:b]), ref.push(x[:, a:b])
        assert got.dtype == np.int32 and want.dtype == np.int32
        assert np.array_equal(got, want), (a, b)
        assert port.pending == ref.pending
        outs.append(got)
    assert (port.samples_in, port.samples_out) == \
        (ref.samples_in, ref.samples_out)
    return np.concatenate(outs, axis=2)


@pytest.mark.parametrize("mode", MODES)
def test_stream_matches_reference_chunk_for_chunk(mode):
    q = sampled_sweep_bank(31, n_div=10, n_filters=5 if mode == "packed" else 3)
    x = np.random.default_rng(8).integers(-128, 128, (2, 2100))
    port, ref = _pair(q, 2, 256, mode)
    y = _stream(port, ref, x, [0, 13, 30, 31, 600, 601, 1500, 2100])
    assert np.array_equal(y, fir_bit_layers_batch(x, q))
    assert port.pending == 30


@pytest.mark.parametrize("mode", MODES)
def test_sub_tap_chunks_after_priming(mode):
    q = sampled_sweep_bank(15, n_div=10, n_filters=3, seed=1)
    x = np.random.default_rng(20).integers(-128, 128, (1, 40))
    port, ref = _pair(q, 1, 128, mode)
    _stream(port, ref, x, [0, 14] + list(range(15, 41)))


@pytest.mark.parametrize("mode", MODES)
def test_final_chunk_not_tile_multiple(mode):
    q = sampled_sweep_bank(31, n_div=10, n_filters=4, seed=2)
    x = np.random.default_rng(22).integers(-128, 128, (1, 777))
    port, ref = _pair(q, 1, 128, mode)
    y = _stream(port, ref, x, [0, 512, 777])
    assert y.shape == (4, 1, 777 - 31 + 1)


def test_priming_and_empty_chunks():
    q = sampled_sweep_bank(15, n_div=10, n_filters=3, seed=3)
    port, ref = _pair(q, 1, 128, "packed")
    for chunk in (np.arange(7), np.zeros(0, np.int64), np.arange(7),
                  np.arange(3), np.zeros(0, np.int64), np.arange(40)):
        got, want = port.push(chunk), ref.push(chunk)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert port.pending == ref.pending


def test_adversarial_bank_with_zero_groups():
    q = adversarial_bank(31, seed=4)
    x = np.random.default_rng(5).integers(-128, 128, (3, 900))
    port = FilterBankEngine(q, channels=3, tile=128, mode="packed",
                            bank_tile=1, device="cpu")
    ref = RefEngine(q, channels=3, tile=128, mode="packed", bank_tile=1,
                    lane="xla")
    assert any(not g.sel_layers for g in port.bank_schedule.groups)
    _stream(port, ref, x, [0, 100, 450, 900])


def test_dtypes_taps1_and_reset():
    q = np.array([[3], [-5]], np.int64)  # taps=1: no tail at all
    port, ref = _pair(q, 1, 128, "packed")
    for dtype in (np.int8, np.int16, np.int32, np.int64):
        chunk = np.arange(10, dtype=dtype)
        assert np.array_equal(port.push(chunk), ref.push(chunk))
        assert port.pending == 0
    assert np.array_equal(port.push(torch.arange(5)), ref.push(np.arange(5)))
    port.reset()
    assert port.samples_in == 0 and port.samples_out == 0 and port.pending == 0


def test_auto_mode_is_the_fast_path_rule():
    """Auto mode takes the dispatch planner's plan: K2 for one filter, and
    for wider banks the mode, tile and schedule the reference engine's
    planner picks."""
    one = sampled_sweep_bank(15, n_div=10, n_filters=1, seed=6)
    two = sampled_sweep_bank(15, n_div=10, n_filters=2, seed=6)
    wide = sampled_sweep_bank(15, n_div=10, n_filters=48, seed=6)
    assert FilterBankEngine(one, device="cpu").mode == "specialized"
    for q in (two, wide):
        eng, ref = FilterBankEngine(q, device="cpu"), RefEngine(q)
        want = "packed" if ref.dispatch_plan.mode == "scheduled" \
            else "specialized"
        assert eng.mode == want and eng.tile == ref.tile
        assert eng.dispatch_plan.predicted_us == ref.dispatch_plan.predicted_us
    assert eng.mode == "packed"
    assert eng.bank_tile == eng.bank_schedule.tile_size == ref.bank_tile
    assert eng.merge == ref.merge
    assert FilterBankEngine(two, mode="scheduled", device="cpu").mode == "packed"
    prog = compile_bank(two)
    assert FilterBankEngine(prog, device="cpu").program is prog


def test_rejects_bad_input():
    q = sampled_sweep_bank(15, n_div=10, n_filters=2, seed=7)
    with pytest.raises(ValueError):
        FilterBankEngine(q, channels=0, device="cpu")
    with pytest.raises(ValueError):
        FilterBankEngine(q, mode="warp", device="cpu")
    eng = FilterBankEngine(q, channels=2, device="cpu")
    with pytest.raises(ValueError):
        eng.push(np.zeros((3, 10)))
    with pytest.raises(ValueError):
        eng.apply_lanes(np.zeros((2, 5)))


@pytest.mark.parametrize("mode", MODES)
def test_apply_lanes_matches_reference_and_is_stateless(mode):
    q = sampled_sweep_bank(31, n_div=10, n_filters=3, seed=8)
    buf = np.random.default_rng(9).integers(-128, 128, (2, 400))
    port, ref = _pair(q, 2, 128, mode)
    port.push(buf[:, :50])
    pending = port.pending
    assert np.array_equal(port.apply_lanes(buf), ref.apply_lanes(buf))
    assert port.pending == pending and port.samples_in == 50


def test_snapshot_restore_resumes_the_stream():
    q = sampled_sweep_bank(31, n_div=10, n_filters=4, seed=10)
    x = np.random.default_rng(11).integers(-128, 128, (2, 1200))
    port, ref = _pair(q, 2, 256, "packed")
    _stream(port, ref, x, [0, 333])
    snap = port.snapshot_tail(session="a")
    ref_snap = ref.snapshot_tail(session="a")
    assert snap.program_key == ref_snap.program_key
    assert np.array_equal(snap.tail, ref_snap.tail)
    resumed = FilterBankEngine(q, channels=2, tile=256, mode="packed",
                               device="cpu")
    resumed.restore_tail(ref_snap)
    assert np.array_equal(resumed.push(x[:, 333:]), ref.push(x[:, 333:]))
    other = FilterBankEngine(q[:2], channels=2, device="cpu")
    with pytest.raises(ValueError):
        other.restore_tail(snap)
    three = FilterBankEngine(q, channels=3, device="cpu")
    with pytest.raises(ValueError):
        three.restore_tail(snap)


@pytest.mark.parametrize("taps,n_filters,channels", [(7, 1, 2), (55, 24, 1),
                                                     (127, 9, 2), (255, 6, 1)])
def test_bank_call_on_the_raw_packed_operand(taps, n_filters, channels):
    """`blmac_fir_bank(x, pack_bank_trits(q), taps)` on a CPU tensor (the
    plain versions; one filter takes the specialized fast path) against
    the reference's call on the same operand (its compiled XLA lane) and
    the oracle, tolerance 0."""
    q = sampled_sweep_bank(taps, n_div=10, n_filters=n_filters, seed=taps)
    x = np.random.default_rng(taps).integers(-128, 128, (channels, 900))
    packed = pack_bank_trits(q)
    got = blmac_fir_bank(torch.as_tensor(x), packed, taps, tile=256)
    assert got.device.type == "cpu" and got.dtype == torch.int32
    want = np.asarray(ref_bank(jnp.asarray(x), packed, taps, tile=256,
                               lane="xla"))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), fir_bit_layers_batch(x, q))
    one = blmac_fir_bank(torch.as_tensor(x[0]), packed, taps, tile=256)
    assert np.array_equal(one.numpy(), want[:, 0])
