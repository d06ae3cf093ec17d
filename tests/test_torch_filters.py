"""The port's filter design and oracles against the reference's, exactly.

Eq. 3 (`fir_symmetric`) and the pulse-serial Eq. 2 (`fir_bit_layers`
with ``symmetric=False``) on type-I, even-length and asymmetric filters;
the §3.1 sweep through `iter_sweep`; `firwin_batch` and `sweep_bank`
designed in a process pool (``workers=2``) and without one; the §3.3
addition counts of the sweep banks at both ends of `TAPS_RANGE`.  Inputs
come from a seeded numpy rng; every comparison is exact (tolerance 0:
integers, or float64 designs compared bit for bit).
"""
import contextlib
import faulthandler

import numpy as np
import pytest

import repro.filters as rf
import repro_torch.filters as tf
import repro_torch.filters.fir as tfir
from repro.core.costmodel import fir_blmac_additions_batch as ref_additions
from repro.core.quantize import po2_quantize_batch as ref_quantize
from repro_torch.core import po2_quantize_batch
from repro_torch.core.costmodel import fir_blmac_additions_batch

POOL_LIMIT_S = 120  # a pool that hangs fails its test instead of the run


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Dump every thread's stack and end the process if the body runs
    past ``seconds`` (a hung process pool cannot be interrupted)."""
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _filter(kind: str, taps: int, rng) -> np.ndarray:
    w = rng.integers(-(1 << 15), 1 << 15, taps)
    if kind == "type1":
        half = w[: taps // 2 + 1]
        w = np.concatenate([half, half[:-1][::-1]])
    elif kind == "even_symmetric":
        half = w[: taps // 2]
        w = np.concatenate([half, half[::-1]])
    return w


FILTERS = [("type1", 7), ("type1", 55), ("type1", 127), ("even_symmetric", 8),
           ("even_symmetric", 56), ("asymmetric", 7), ("asymmetric", 40),
           ("type1", 1)]


@pytest.mark.parametrize("kind,taps", FILTERS)
def test_fir_symmetric_and_pulse_serial_match_reference(kind, taps):
    rng = np.random.default_rng(taps)
    w = _filter(kind, taps, rng)
    x = rng.integers(-128, 128, taps + 300)
    want = rf.fir_direct(x, w)
    got = tf.fir_bit_layers(x, w, symmetric=False)
    assert got.dtype == np.int64
    assert np.array_equal(got, rf.fir_bit_layers(x, w, symmetric=False))
    assert np.array_equal(got, want)
    if kind == "type1":
        for fn in ("fir_symmetric", "fir_bit_layers"):
            got = getattr(tf, fn)(x, w)
            assert np.array_equal(got, getattr(rf, fn)(x, w)), fn
            assert np.array_equal(got, want), fn
        return
    for fn in ("fir_symmetric", "fir_bit_layers"):
        with pytest.raises(ValueError) as ref_err:
            getattr(rf, fn)(x, w)
        with pytest.raises(ValueError) as port_err:
            getattr(tf, fn)(x, w)
        assert str(port_err.value) == str(ref_err.value), fn


def test_pulse_serial_takes_wide_samples_exactly():
    """±2**20 samples under 16-bit coefficients: int64 throughout, no
    wrap, the reference's result."""
    rng = np.random.default_rng(3)
    w = _filter("asymmetric", 33, rng)
    x = rng.integers(-(1 << 20), 1 << 20, 500)
    got = tf.fir_bit_layers(x, w, symmetric=False)
    assert np.array_equal(got, rf.fir_bit_layers(x, w, symmetric=False))
    assert np.array_equal(got, rf.fir_direct(x, w))


def test_iter_sweep_yields_the_reference_banks():
    taps = tf.TAPS_RANGE[::25]  # 55, 105, 155, 205, 255
    port = list(tf.iter_sweep(n_div=8, taps=taps, window=("kaiser", 5.0)))
    ref = list(rf.iter_sweep(n_div=8, taps=taps, window=("kaiser", 5.0)))
    assert [t for t, _ in port] == [t for t, _ in ref] == list(taps)
    for (t, a), (_, b) in zip(port, ref):
        assert a.shape == (8 * 7, t) and a.dtype == np.float64
        assert a.tobytes() == b.tobytes(), t


def test_iter_sweep_is_lazy_and_defaults_to_the_paper_range():
    it = tf.iter_sweep(n_div=4)
    t, bank = next(it)
    assert (t, bank.shape) == (tf.TAPS_RANGE[0], (12, tf.TAPS_RANGE[0]))
    assert tf.TAPS_RANGE == rf.TAPS_RANGE
    assert len(tf.TAPS_RANGE) == 101 and tf.TAPS_RANGE[-1] == 255


class _CountingPool(tfir.ProcessPoolExecutor):
    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1
        super().__init__(*args, **kwargs)


@pytest.fixture
def counting_pool(monkeypatch):
    _CountingPool.made = 0
    monkeypatch.setattr(tfir, "ProcessPoolExecutor", _CountingPool)
    return _CountingPool


@pytest.mark.parametrize("taps,n_div", [(55, 12), (255, 10)])
def test_sweep_bank_in_a_pool_equals_serial_and_reference(counting_pool, taps,
                                                          n_div):
    with _time_limit(POOL_LIMIT_S):
        pooled = tf.sweep_bank(taps, n_div, workers=2)
    assert counting_pool.made == 1  # n_div*(n_div-1) >= 4 * workers
    serial = tf.sweep_bank(taps, n_div)
    assert counting_pool.made == 1
    ref = rf.sweep_bank(taps, n_div)
    assert pooled.shape == (n_div * (n_div - 1), taps)
    assert pooled.tobytes() == serial.tobytes() == ref.tobytes()


def test_firwin_batch_pool_branch_and_its_threshold(counting_pool):
    """Mixed band counts (bandstop has two) split across 3 workers; a
    bank under ``4 * workers`` filters is designed in this process."""
    rng = np.random.default_rng(11)
    specs = [("lowpass", 0.3), ("bandstop", (0.2, 0.6)), ("highpass", 0.7),
             ("bandpass", (0.1, 0.45))] * 4
    specs += [("lowpass", float(c)) for c in rng.uniform(0.05, 0.95, 7)]
    bands = [tf.bands_for(k, c) for k, c in specs]
    with _time_limit(POOL_LIMIT_S):
        pooled = tf.firwin_batch(101, bands, ("kaiser", 8.0), workers=3)
    assert counting_pool.made == 1
    want = rf.firwin_batch(101, bands, ("kaiser", 8.0))
    assert pooled.tobytes() == want.tobytes()
    assert pooled.tobytes() == tf.firwin_batch(101, bands, ("kaiser", 8.0)) \
        .tobytes()
    few = tf.firwin_batch(31, bands[:11], workers=3, scale=False)
    assert counting_pool.made == 1  # 11 < 12: no pool
    assert few.tobytes() == rf.firwin_batch(31, bands[:11], scale=False) \
        .tobytes()
    with pytest.raises(ValueError, match="odd tap count"):
        tf.firwin_batch(30, bands, workers=2)


def test_specialize_threshold_is_the_reference_constant():
    assert tf.SPECIALIZE_THRESHOLD == rf.SPECIALIZE_THRESHOLD == 8


@pytest.mark.parametrize("taps", [tf.TAPS_RANGE[0], tf.TAPS_RANGE[-1]])
def test_sweep_bank_additions_match_reference(taps):
    """§3.3 BLMAC additions of the whole 9,900-filter sweep bank at both
    ends of the tap range, filter for filter."""
    h = tf.sweep_bank(taps)
    assert h.tobytes() == rf.sweep_bank(taps).tobytes()
    q, exps = po2_quantize_batch(h, 16)
    ref_q, ref_exps = ref_quantize(h, 16)
    assert np.array_equal(q, ref_q) and np.array_equal(exps, ref_exps)
    adds = fir_blmac_additions_batch(q)
    assert adds.shape == (9900,)
    assert np.array_equal(adds, ref_additions(q))
