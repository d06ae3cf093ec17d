"""K1's term tables and their numpy walk, on the CPU.

The bank kernel reads each tile group as digit runs of span ≤ 7 (s8
digits, stored in wgmma's A-fragment order) and walks, per 64-row tile,
its Horner chain of terms (run × byte plane of the folded samples, sorted
by shift, shifts of 32 or more dropped) — `BankTerms`, built by
`bank_terms`.  `bank_term_walk` is that arithmetic in numpy; here it is
held against `bank_call_plain` (the reference's `_bank_call_xla` in
torch), the port's and `repro`'s numpy oracle `fir_bit_layers_batch` and
`repro`'s bank kernel in Pallas interpret mode, on the same numpy inputs,
tolerance 0 (int32 arithmetic modulo 2**32).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential import random_type1_bank
from repro.compiler import compile_bank as ref_compile
from repro.filters import fir_bit_layers_batch as ref_oracle
from repro_torch.compiler import compile_bank, compile_packed
from repro_torch.core.csd import pack_trits
from repro_torch.filters import fir_bit_layers_batch

rk = importlib.import_module("repro.kernels.blmac_fir")
tk = importlib.import_module("repro_torch.kernels.blmac_fir")

LIMITS = {"8bit": 1 << 7, "20bit": 1 << 20, "int32": 1 << 31}


def _x(shape, kind, seed):
    lim = LIMITS[kind]
    return np.random.default_rng(seed).integers(-lim, lim, shape).astype(
        np.int32)


def _bank(n_filters, taps, seed):
    """A random bank with all-zero rows: one in a bank of 2 or 9, eight
    (one whole bank tile of 8) in a bank of 300."""
    q = random_type1_bank(n_filters, taps, seed=seed, density=0.7)
    q[n_filters // 2:n_filters // 2 + (8 if n_filters >= 300 else 1)] = 0
    return q


def _wrapped(y):
    """int64 oracle output modulo 2**32, as int32."""
    return np.asarray(y, np.int64).astype(np.int32)


# -- the term table ----------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_digit_runs_span_at_most_seven(seed):
    rng = np.random.default_rng(seed)
    layers = sorted(rng.choice(31, rng.integers(1, 20), replace=False).tolist(),
                    reverse=True)
    runs = tk.digit_runs(layers)
    assert sorted(i for run in runs for i in run) == list(range(len(layers)))
    for run in runs:
        span = [layers[i] for i in run]
        assert span == sorted(span, reverse=True)
        assert span[0] - span[-1] <= tk.MAX_RUN_SPAN - 1
    # MSB first, and greedy: a run ends only where the next layer would
    # stretch it past seven
    heads = [layers[run[0]] for run in runs]
    assert heads == sorted(heads, reverse=True)
    for run, nxt in zip(runs, runs[1:]):
        assert layers[run[0]] - layers[nxt[0]] >= tk.MAX_RUN_SPAN


def test_term_table_sorted_and_drops_shifts_past_31():
    lows = [14, 7, 0]
    tab = tk.term_table(lows)
    want = {(r, p, lo + 8 * p) for r, lo in enumerate(lows) for p in range(4)
            if lo + 8 * p < 32}
    assert {tuple(v[:3]) for v in tab.tolist()} == want
    assert len(tab) == len(want) == 11
    assert list(tab[:, 2]) == sorted(tab[:, 2], reverse=True)
    assert tab[:, 2].max() < 32 and not tab[:, 3].any()
    assert tk.term_table([31]).tolist() == [[0, 0, 31, 0]]
    assert tk.term_table([32]).shape == (0, 4)


@pytest.mark.parametrize("merge", [1, 4, 8, 32])
def test_schedule_layers_are_the_selected_layers(merge):
    prog = compile_bank(random_type1_bank(20, 31, seed=merge, density=0.5))
    for g in prog.schedule(bank_tile=4, merge=merge).groups:
        assert tk.schedule_layers(g.schedule, g.tail_shift) == list(g.sel_layers)


def test_raw_trits_with_eight_layers_in_a_span_fit_s8():
    """Raw trits (not CSD) with all 8 layers of a span set to +1 at every
    tap: one merge-8 superlayer of digit 255.  The kernel's runs of span
    ≤ 7 keep every digit within s8 (127 at most, reached here), and the
    walk of those terms equals the plain version and a direct sum."""
    taps, n_layers = 31, 8
    half = taps // 2
    trits = np.ones((n_layers, half + 1), np.int8)
    trits[:, ::5] = -1
    packed = pack_trits(trits[None])
    prog = compile_packed(packed, taps)
    sched = prog.schedule(bank_tile=1, merge=8)
    (g,) = sched.groups
    assert len(g.schedule) == 1 and len(g.sel_layers) == 8
    terms = tk.bank_terms(sched, taps, "cpu")
    digits = terms.digits.astype(np.int64)
    assert np.abs(digits).max() == 127
    x = _x((2, 600), "int32", 5)
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), taps, 128)
    walk = tk.bank_term_walk(frames.numpy(), terms, 128, n_out)
    plain = tk.bank_schedule_apply(frames, sched, taps, 128, n_out).numpy()
    coeff = (trits.astype(np.int64) << np.arange(n_layers)[:, None]).sum(0)
    direct = fir_bit_layers_batch(x, np.concatenate([coeff, coeff[:-1][::-1]]))
    assert np.array_equal(walk, plain)
    assert np.array_equal(walk, _wrapped(direct))


@pytest.mark.parametrize("k", [32, 64, 96, 128])
def test_a_fragments_round_trip(k):
    d = np.random.default_rng(k).integers(-127, 128, (3 * 64, k)).astype(np.int8)
    f = tk.a_fragments(d)
    assert f.shape == (3, k // 32, 128, 16)
    for i in range(3):
        assert np.array_equal(tk.fragment_rows(f[i]), d[64 * i:64 * (i + 1)])
    # thread 32 w + 4 g + q: registers (row g, row g + 8, row g, row g + 8)
    # of warp w's 16 rows, columns 4q.. then 16 + 4q.. of each k-step
    w, g, q = 2, 5, 3
    frag = f[1, 1 if k > 32 else 0, 32 * w + 4 * g + q]
    r, c = 64 + 16 * w + g, (32 if k > 32 else 0) + 4 * q
    assert np.array_equal(frag, np.concatenate(
        [d[r, c:c + 4], d[r + 8, c:c + 4], d[r, c + 16:c + 20],
         d[r + 8, c + 16:c + 20]]))


# -- the sample planes ---------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(LIMITS))
def test_sample_planes_reassemble_modulo_2_32(kind):
    x = _x(5000, kind, 7)
    u = (x[:-3].astype(np.int64) + x[3:]).astype(np.int32)  # folded pairs
    u = np.concatenate([u, x, [-(1 << 31), (1 << 31) - 1, -256, 254, 0]]
                       ).astype(np.int32)
    s = tk.sample_planes(u)
    assert s.shape == (4,) + u.shape and s.dtype == np.int8
    back = sum(s[p].astype(np.int64) << (8 * p) for p in range(4))
    assert np.array_equal(back.astype(np.int32), u)


@pytest.mark.parametrize("kind,planes", [("8bit", 2), ("20bit", 3),
                                         ("int32", 4)])
def test_sample_planes_needed(kind, planes):
    """8-bit samples, folded (|u| ≤ 256), need exactly two byte planes; ±2**20
    samples three; the whole int32 range four."""
    x = _x(20_000, kind, 8)
    u = (x[:-5].astype(np.int64) + x[5:]).astype(np.int32)
    live = [bool(p.any()) for p in tk.sample_planes(u)]
    assert live == [True] * planes + [False] * (4 - planes)
    assert not tk.sample_planes(np.arange(-256, 255))[2:].any()


# -- the walk against the plain version and the references --------------------

@pytest.mark.parametrize("samples", sorted(LIMITS))
@pytest.mark.parametrize("n_filters", [2, 9, 300])
@pytest.mark.parametrize("taps", [1, 3, 63, 127, 255])
def test_term_walk_matches_plain_and_oracle(taps, n_filters, samples):
    """Several groups (bank tiles of 1 or 8 rows), an all-zero group among
    them, 1–3 channels: walk == plain == the port's and `repro`'s oracle
    modulo 2**32, every row in the caller's order, no pad row."""
    q = _bank(n_filters, taps, seed=taps + n_filters)
    channels = 1 + (taps + n_filters) % 3
    prog = compile_bank(q)
    sched = prog.schedule(bank_tile=1 if n_filters < 300 else 8)
    assert len(sched.groups) > 1
    assert any(not g.sel_layers for g in sched.groups)
    x = _x((channels, taps + 300), samples, taps)
    tile = 128
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), taps, tile)
    terms = tk.bank_terms(sched, taps, "cpu")
    walk = tk.bank_term_walk(frames.numpy(), terms, tile, n_out)
    plain = tk.bank_schedule_apply(frames, sched, taps, tile, n_out)
    assert walk.shape == tuple(plain.shape) == (n_filters, channels, n_out)
    assert np.array_equal(walk, plain.numpy())
    oracle = _wrapped(ref_oracle(x, q))
    assert np.array_equal(walk, oracle)
    assert np.array_equal(oracle, _wrapped(fir_bit_layers_batch(x, q)))


@pytest.mark.parametrize("samples", ["8bit", "int32"])
@pytest.mark.parametrize("n_filters", [2, 9])
@pytest.mark.parametrize("taps", [1, 3, 31])
def test_term_walk_matches_reference_interpret_kernel(taps, n_filters,
                                                      samples):
    """`repro`'s bank kernel, `_fir_kernel_bank`, in Pallas interpret mode
    (int32 modulo 2**32) on the same samples and the same schedule."""
    q = _bank(n_filters, taps, seed=3 * taps + n_filters)
    x = _x((2, 260), samples, n_filters)
    sched = compile_bank(q).schedule(bank_tile=1)
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), taps, 128)
    walk = tk.bank_term_walk(frames.numpy(), tk.bank_terms(sched, taps, "cpu"),
                             128, n_out)
    want = rk.blmac_fir_bank(jnp.asarray(x), ref_compile(q).packed, taps,
                             tile=128, bank_tile=1, interpret=True,
                             fast_path=False)
    assert np.array_equal(walk, np.asarray(want))


@pytest.mark.parametrize("merge", [1, 8, 32])
def test_term_walk_any_merge(merge):
    """The runs are regrouped from the selected layers whatever the
    schedule's merge: every merge gives the plain version's bits."""
    q = random_type1_bank(24, 63, seed=merge)
    sched = compile_bank(q).schedule(bank_tile=8, merge=merge)
    x = _x((2, 700), "20bit", merge)
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), 63, 256)
    terms = tk.bank_terms(sched, 63, "cpu")
    assert all(len(run) <= 7 for run in tk.digit_runs(
        tk.schedule_layers(sched.groups[0].schedule,
                           sched.groups[0].tail_shift)))
    assert np.array_equal(tk.bank_term_walk(frames.numpy(), terms, 256, n_out),
                          tk.bank_schedule_apply(frames, sched, 63, 256,
                                                 n_out).numpy())


# -- the caller-order output -------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3])
def test_bank_schedule_apply_writes_caller_order(channels):
    """(B, C, n_out): no pad rows (B = 13 with bank tiles of 8 pads to 16),
    no outputs past n_out, filters in the caller's order — on the plain
    path and through `bank_apply`'s CPU route (the walk), into a given
    ``out`` too."""
    q = random_type1_bank(13, 31, seed=channels, density=0.5)
    q[4] = 0
    prog = compile_bank(q)
    sched = prog.schedule(bank_tile=8)
    assert sum(g.packed.shape[0] for g in sched.groups) == 16
    assert not np.array_equal(sched.perm, np.arange(13))
    x = _x((channels, 1000), "8bit", channels)
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), 31, 256)
    assert n_out < frames.shape[1] * 256
    y = tk.bank_schedule_apply(frames, sched, 31, 256, n_out)
    assert tuple(y.shape) == (13, channels, n_out)
    assert np.array_equal(y.numpy(), fir_bit_layers_batch(x, q))
    terms = tk.bank_terms(sched, 31, "cpu")
    out = torch.full((13, channels, n_out), 7, dtype=torch.int32)
    got = tk.bank_apply(frames, terms, 256, n_out, out=out)
    assert got is out and torch.equal(out, y)
    padded = tk.bank_output(13, channels, n_out, "cpu")
    assert padded.stride(1) % 8 == 0 and padded.stride(1) >= n_out
    assert tk.bank_apply(frames, terms, 256, n_out, out=padded) is padded
    assert torch.equal(padded, y)
    full = tk.bank_schedule_apply(frames, sched, 31, 256)
    assert tuple(full.shape) == (13, channels, frames.shape[1] * 256)
    assert torch.equal(full[:, :, :n_out], y)


def test_bank_terms_cached_per_schedule():
    prog = compile_bank(random_type1_bank(10, 15, seed=2))
    a = tk.bank_terms(prog.schedule(), 15, "cpu")
    assert tk.bank_terms(prog.schedule(), 15, "cpu") is a
    b = tk.bank_terms(prog.schedule(bank_tile=8), 15, "cpu")
    assert b is not a and a.tensors is None
    assert a.k == tk.bank_k(15) == 32 and tk.bank_k(255) == 128
    assert tk.bank_k(127) == 64 and tk.bank_k(191) == 96


def test_bank_apply_rejects_bad_calls():
    prog = compile_bank(random_type1_bank(4, 15, seed=3))
    sched = prog.schedule()
    terms = tk.bank_terms(sched, 15, "cpu")
    frames, n_out = tk.frame_signal_batch(torch.zeros((1, 300),
                                                      dtype=torch.int32),
                                          15, 128)
    with pytest.raises(ValueError):  # more outputs than the frames hold
        tk.bank_apply(frames, terms, 128, 10_000)
    with pytest.raises(ValueError):  # wrong output buffer
        tk.bank_apply(frames, terms, 128, n_out,
                      out=torch.empty(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # int64 frames
        tk.bank_apply(frames.to(torch.int64), terms, 128, n_out)
