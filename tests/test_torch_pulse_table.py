"""K2's tap-major pulse table and its plain walk, on the CPU.

The specialized kernel reads each filter's CSD pulse list as a tap-major
table (`pulse_table`: per tap, the fold once and one multiply-add by
±2**layer per pulse), several filters concatenated behind an offset array
(`pulse_tables`).  `pulse_table_walk` walks that layout in numpy uint32,
as the kernel does; here it is held against `specialized_plain` (the
reference's Horner walk in torch) and against `repro`'s
`_fir_kernel_specialized` in Pallas interpret mode, on the same numpy
inputs, tolerance 0 (int32 arithmetic modulo 2**32).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential import random_type1_bank
from repro.filters import fir_bit_layers_batch as ref_oracle
from repro_torch.compiler import compile_bank
from repro_torch.filters import FilterBankEngine, fir_bit_layers_batch

rk = importlib.import_module("repro.kernels.blmac_fir")
tk = importlib.import_module("repro_torch.kernels.blmac_fir")


def _sym(half_coeffs):
    """Odd symmetric (type-I) taps from their folded half (centre last)."""
    h = np.asarray(half_coeffs, np.int64)
    return np.concatenate([h, h[:-1][::-1]])


def _x(n, seed, lim=128):
    rng = np.random.default_rng(seed)
    if lim is None:  # the whole int32 range
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    return rng.integers(-lim, lim, n).astype(np.int32)


def _walk_vs_plain_and_reference(q, x, tile):
    """The table walk, the plain version and the reference's interpreted
    kernel on one filter and one signal; all three must agree bit for bit
    (and with the oracle modulo 2**32).  Returns the walk's output."""
    taps = len(q)
    pulses = tk.pulses_msb_first(q)
    assert pulses == rk.pulses_msb_first(q)
    frames, n_out = tk.frame_signal(torch.as_tensor(x), taps, tile)
    table, offsets = tk.pulse_tables([pulses], taps)
    walk = tk.pulse_table_walk(frames.numpy(), table, offsets, taps, tile)
    plain = tk.specialized_plain(frames, pulses, taps, tile).numpy()
    assert walk.shape == (1,) + plain.shape and walk.dtype == np.int32
    assert np.array_equal(walk[0], plain)
    want = rk.blmac_fir_specialized(jnp.asarray(x), pulses, taps, tile,
                                    interpret=True)
    got = walk[0].reshape(-1)[:n_out]
    assert np.array_equal(got, np.asarray(want))
    oracle = fir_bit_layers_batch(x.astype(np.int64), q)[0, 0]
    assert np.array_equal(got, oracle.astype(np.int64).astype(np.int32))
    return got


@pytest.mark.parametrize("taps,tile", [(7, 128), (63, 128), (127, 256),
                                       (255, 256)])
def test_table_walk_matches_plain_and_reference(taps, tile):
    q = random_type1_bank(1, taps, seed=taps)[0]
    assert len(tk.pulses_msb_first(q)) > taps // 2  # a dense filter
    _walk_vs_plain_and_reference(q, _x(2 * tile + taps, taps), tile)


def test_empty_pulse_list():
    q = np.zeros(31, np.int64)
    assert tk.pulses_msb_first(q) == ()
    assert tk.pulse_table((), 31).tolist() == [0, 0]
    got = _walk_vs_plain_and_reference(q, _x(300, 1), 128)
    assert not got.any()


def test_centre_tap_only():
    q = _sym([0] * 15 + [-1_000_003])
    pulses = tk.pulses_msb_first(q)
    assert {j for _, j, _ in pulses} == {15} and len(pulses) > 1
    table = tk.pulse_table(pulses, 31)
    assert table[:2].tolist() == [0, len(pulses)]  # no walk, the centre
    _walk_vs_plain_and_reference(q, _x(400, 2), 128)


def test_pulses_all_in_one_layer():
    rng = np.random.default_rng(3)
    half = rng.choice([-32, 0, 32], 32)
    half[-1] = 32
    q = _sym(half)
    pulses = tk.pulses_msb_first(q)
    assert {layer for layer, _, _ in pulses} == {5}
    table = tk.pulse_table(pulses, 63)
    assert table[0] <= 31 and set(np.abs(table[1:]).tolist()) <= {0, 1, 32}
    assert (table[1:] == 1).sum() == len(pulses)  # one pulse a used tap
    _walk_vs_plain_and_reference(q, _x(500, 4), 128)


def test_lsb_layers_empty():
    """Every coefficient a multiple of 8: the reference's walk ends in a
    final shift of 3; the table carries it in each multiplier."""
    q = random_type1_bank(1, 31, seed=5)[0] // 8 * 8
    pulses = tk.pulses_msb_first(q)
    assert min(layer for layer, _, _ in pulses) >= 3
    _walk_vs_plain_and_reference(q, _x(400, 6), 128)


def test_full_int32_samples_wrap():
    q = random_type1_bank(1, 63, seed=7)[0]
    x = _x(600, 8, lim=None)
    got = _walk_vs_plain_and_reference(q, x, 256)
    exact = fir_bit_layers_batch(x.astype(np.int64), q)[0, 0]
    assert np.abs(exact).max() >= 1 << 31  # the case really wraps
    assert np.array_equal(got, ref_oracle(x.astype(np.int64), q)[0, 0]
                          .astype(np.int32))


@pytest.mark.parametrize("taps", [7, 63, 127, 255])
def test_table_holds_every_pulse_as_a_signed_power_of_two(taps):
    """Every tap below the centre up to the last that carries pulses, in
    order, then the centre; one ±2**layer word per pulse, MSB first; and
    the pulses of each tap sum back to its coefficient."""
    q = random_type1_bank(1, taps, seed=taps + 1, density=0.7)[0]
    pulses = tk.pulses_msb_first(q)
    table = tk.pulse_table(pulses, taps).astype(np.int64)
    half = taps // 2
    walked = sorted({j for _, j, _ in pulses if j < half})
    assert table[0] == walked[-1] + 1
    p, words = 1, 0
    for j in [*range(int(table[0])), half]:
        n = int(table[p])
        ms = table[p + 1:p + 1 + n]
        assert all(m != 0 and (abs(m) & (abs(m) - 1)) == 0 for m in ms)
        want = [sign << layer for layer, jj, sign in pulses if jj == j]
        assert ms.tolist() == want  # MSB first, as the pulse tuple
        assert int(ms.sum()) == int(q[j])
        words += n
        p += 1 + n
    assert p == table.size and words == len(pulses)
    with pytest.raises(ValueError):
        tk.pulse_table(((0, taps // 2 + 1, 1),), taps)


def test_multi_filter_table_with_offsets():
    """Filters of different pulse counts (one empty) in one table; the
    walk of each slice equals that filter's plain version, over two
    channels of strided frames."""
    bank = np.concatenate([random_type1_bank(1, 63, seed=9, density=d)
                           for d in (1.0, 0.6, 0.2)]
                          + [np.zeros((1, 63), np.int64),
                           _sym([0] * 31 + [5])[None]])
    scheds = [tk.pulses_msb_first(q) for q in bank]
    counts = [len(p) for p in scheds]
    assert len(set(counts)) == len(counts)
    table, offsets = tk.pulse_tables(scheds, 63)
    assert offsets.tolist() == np.cumsum(
        [0] + [tk.pulse_table(p, 63).size for p in scheds]).tolist()
    x = np.stack([_x(900, 10), _x(900, 11)])
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), 63, 128)
    assert frames.stride(1) == 128  # overlapping views of the signal
    walk = tk.pulse_table_walk(frames.numpy(), table, offsets, 63, 128)
    assert walk.shape == (len(bank), 2) + tuple(frames.shape[1:2]) + (128,)
    for f, p in enumerate(scheds):
        assert np.array_equal(walk[f], tk.specialized_plain(frames, p, 63, 128)
                              .numpy())
    got = walk.reshape(len(bank), 2, -1)[:, :, :n_out]
    assert np.array_equal(got, fir_bit_layers_batch(x, bank))
    assert np.array_equal(got, ref_oracle(x, bank))


def test_program_call_covers_every_filter_and_channel():
    """`SpecializedProgram` over several filters and channels (the
    engine's one launch a push, here through the plain version) equals
    the oracle; 2-D frames drop the channel axis; the frames may be any
    strided view with unit stride along the frame."""
    bank = random_type1_bank(4, 31, seed=12)
    scheds = compile_bank(bank).pulse_schedules()
    prog = tk.SpecializedProgram(scheds, 31, 128, torch.device("cpu"))
    x = np.stack([_x(700, 13), _x(700, 14), _x(700, 15)])
    y = prog(torch.as_tensor(x))
    assert y.shape == (4, 3, 700 - 30) and y.dtype == torch.int32
    assert np.array_equal(y.numpy(), fir_bit_layers_batch(x, bank))
    assert np.array_equal(prog(torch.as_tensor(x[1])).numpy(), y[:, 1].numpy())
    frames, _ = tk.frame_signal_batch(torch.as_tensor(x), 31, 128)
    for view in (frames[1], frames[:, ::2], frames.contiguous()[::2]):
        got = tk.specialized_call(view, prog)
        assert got.shape == (4,) + tuple(view.shape[:-1]) + (128,)
        table, offsets = tk.pulse_tables(scheds, 31)
        assert np.array_equal(got.numpy(), tk.pulse_table_walk(
            view.numpy(), table, offsets, 31, 128))
    with pytest.raises(ValueError):
        tk.specialized_call(frames[None], prog)


def test_one_filter_paths_frame_all_channels_at_once():
    """`blmac_fir_bank`'s B = 1 route and a one-filter auto engine take
    every channel in one `specialized_call` (counted here by wrapping
    it); the outputs equal the oracle."""
    q = random_type1_bank(1, 31, seed=16)
    x = np.stack([_x(800, 17), _x(800, 18)])
    calls = []
    real = tk.specialized_call

    def counting(frames, prog):
        calls.append(tuple(frames.shape))
        return real(frames, prog)

    bank_mod = importlib.import_module("repro_torch.filters.bank")
    try:
        tk.specialized_call = counting
        bank_mod.specialized_call = counting
        y = tk.blmac_fir_bank(torch.as_tensor(x), compile_bank(q).packed, 31,
                              tile=256)
        assert len(calls) == 1 and calls[0][0] == 2
        eng = FilterBankEngine(q, channels=2, tile=256, device="cpu")
        assert eng.mode == "specialized"
        outs = [eng.push(x[:, a:b]) for a, b in ((0, 300), (300, 800))]
        assert len(calls) == 3
    finally:
        tk.specialized_call = real
        bank_mod.specialized_call = real
    assert np.array_equal(y.numpy(), fir_bit_layers_batch(x, q))
    assert np.array_equal(np.concatenate(outs, 2), fir_bit_layers_batch(x, q))


def test_geometry_covers_the_tile_and_refuses_oversized_tables():
    for tile in (128, 512, 1024, 4096, 8192):
        threads, cols, tab_pad, smem = tk.specialized_geometry(tile, 255, 777)
        assert threads % 32 == 0 and threads <= tk.SPECIALIZED_MAX_THREADS
        assert cols == threads * tk.OUTS_PER_THREAD
        assert cols >= min(tile, tk.SPECIALIZED_MAX_THREADS
                           * tk.OUTS_PER_THREAD)
        n_x = cols + 254  # samples, with one pad word every 32
        assert tab_pad == 780 and smem == 4 * (780 + n_x + n_x // 32 + 1)
    with pytest.raises(ValueError):
        tk.specialized_geometry(1024, 255, 60_000)
    with pytest.raises(ValueError):
        tk.SpecializedProgram([((0, 3, 1),) * 60_000], 7, 128,
                              torch.device("cpu"))


def _special_filters(taps):
    """Filters whose walks are hard to cut: empty, centre only, every
    pulse on one tap, dense low taps, then sweep-like rows."""
    half = taps // 2
    rows = [np.zeros(half + 1, np.int64), np.eye(half + 1, dtype=np.int64)[-1]
            * 77]
    one_tap = np.zeros(half + 1, np.int64)
    one_tap[min(2, half)] = 0x5555
    dense = np.zeros(half + 1, np.int64)
    dense[:max(1, half // 3)] = -0x2AAB
    rows += [one_tap, dense]
    q = [_sym(r) for r in rows]
    return np.concatenate([np.stack(q), random_type1_bank(3, taps, seed=taps)])


@pytest.mark.parametrize("taps", [7, 63, 127, 255])
@pytest.mark.parametrize("n_segs", [1, 2, 3, 4, 7])
def test_segmented_walk_matches_the_walk(taps, n_segs):
    """K2's small grids split each filter's walk into segments of taps
    (`pulse_segments`) and add the partial sums: the segmented walk equals
    the whole walk and the plain version on full-range int32 samples, each
    segment starts at a multiple of the outputs a thread and at that tap's
    entry of the table, and the longest segment is at most one step of
    taps above an even share of the walk's table reads."""
    q = _special_filters(taps)
    pulses = [tk.pulses_msb_first(r) for r in q]
    table, offsets = tk.pulse_tables(pulses, taps)
    tile = 256
    x = np.stack([_x(3 * tile + 40, 20 + c, lim=None) for c in range(2)])
    frames, _ = tk.frame_signal_batch(torch.as_tensor(x), taps, tile)
    whole = tk.pulse_table_walk(frames.numpy(), table, offsets, taps, tile)
    plain = torch.stack([tk.specialized_plain(frames, p, taps, tile)
                         for p in pulses]).numpy()
    assert np.array_equal(whole, plain)
    for step in (4, 16):
        segs = tk.pulse_segments(table, offsets, n_segs, step)
        assert segs.shape == (len(q), n_segs, 2) and segs.dtype == np.int32
        got = tk.pulse_table_walk(frames.numpy(), table, offsets, taps, tile,
                                  segs)
        assert np.array_equal(got, whole)
        for f in range(len(q)):
            t = table[offsets[f]:offsets[f + 1]]
            n_steps, idx, cost = int(t[0]), [], []
            p = 1
            for _ in range(n_steps):
                idx.append(p)
                cost.append(1 + int(t[p]))
                p += 1 + int(t[p])
            idx.append(p)
            j0 = segs[f, :, 0]
            assert j0[0] == 0 and segs[f, 0, 1] == 1
            assert (np.diff(j0) >= 0).all() and (j0 <= n_steps).all()
            assert all(j % step == 0 or j == n_steps for j in j0)
            assert [idx[j] for j in j0] == segs[f, :, 1].tolist()
            ends = [*j0[1:], n_steps]
            longest = max(sum(cost[a:b]) for a, b in zip(j0, ends))
            chunk = max([sum(cost[a:a + step])
                         for a in range(0, n_steps, step)], default=0)
            assert longest <= sum(cost) / n_segs + chunk


def test_small_grids_split_the_walk_within_a_block():
    """At 16 outputs a thread the walk is whole; at 4 it is split into
    `SMALL_GRID_SEGMENTS` segments while the block (a tile's threads times
    the segments) stays within `SMALL_GRID_MAX_THREADS`; the cost model's
    walk is one segment's share, and each program carries its segments
    for both widths."""
    assert tk.specialized_segments(16, 256) == 1
    assert tk.specialized_segments(4, 32) == tk.SMALL_GRID_SEGMENTS == 4
    assert tk.specialized_segments(4, 128) == 4
    assert tk.specialized_segments(4, 256) == 2
    # one filter, 2 channels × 4 tiles of 512: 4 outputs, 4 segments
    assert tk.specialized_walk(1, 2, 4, 512, 132, 127, 263) == 4 * 326 / 4
    # 2,048 tiles fill the card: 16 outputs, one segment
    assert tk.specialized_walk(1, 1, 2048, 512, 132, 127, 263) == 16 * 326
    q = _special_filters(63)
    prog = tk.SpecializedProgram(
        [tk.pulses_msb_first(r) for r in q], 63, 512, torch.device("cpu"))
    assert tuple(prog.segments[16].shape) == (len(q), 1, 2)
    assert tuple(prog.segments[4].shape) == (len(q), 4, 2)
    table, offsets = tk.pulse_tables(prog.schedules, 63)
    assert np.array_equal(prog.segments[4].numpy(),
                          tk.pulse_segments(table, offsets, 4, 4))
