"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built at first use);
elsewhere every test skips with a reason.  Run on the machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 for the FIR kernels and the combine fold: integer arithmetic
modulo 2**32.  The
pulse-code matmul sums in another order than its plain version, so it is
held to the reference's bound, max|y − y_plain| / max|y_plain| < 1e-5;
its decode is exact, and the device quantizer's codes equal the CPU's bit
for bit.  The language-model stack (plain PyTorch, no kernel of
ours): every reduced arch on the card within 1e-4 of the logits' scale
of the CPU's in float32 with TF32 off, tokens equal; bf16 decode steps
within 5% of a teacher-forced forward.  On a (2, 4) mesh of ``cuda:0``
slots, every reduced arch's train steps and decode within 1e-4 of the
same on a mesh of CPU slots (float32, TF32 off; the params under
`train_tree_gap`'s limits for Adam's amplified rounding).  This file
imports only the port (the card's machine has no
JAX); the banks and weights come from the port's own generators and
seeded numpy draws.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.compiler import compile_bank
from repro_torch.core import po2_quantize_batch
from repro_torch.filters import (FilterBankEngine, fir_bit_layers_batch,
                                 spread_lowpass_qbank, sweep_bank)
from repro_torch.core.serve_quant import quantize_param_tree
from repro_torch.kernels import (blmac_fir, blmac_fir_bank, pulse_dequantize,
                                 pulse_matmul_op, pulse_quantize)
from repro_torch.kernels import blmac_matmul as bmm
from repro_torch.kernels.blmac_matmul import pulse_matmul
from repro_torch.kernels.ref import pulse_decode_ref, pulse_matmul_ref
from repro_torch.kernels.blmac_fir import (SpecializedProgram, bank_apply,
                                           bank_call_plain, bank_output,
                                           bank_schedule_apply, bank_terms,
                                           combine_fold, combine_plain,
                                           combine_table,
                                           frame_signal, frame_signal_batch,
                                           group_terms,
                                           pulses_from_packed,
                                           reset_launch_counts,
                                           specialized_call,
                                           specialized_geometry,
                                           specialized_plain,
                                           specialized_program)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda", torch.cuda.current_device())


def _random_bank(n_filters, taps, seed, density=1.0):
    rng = np.random.default_rng(seed)
    half = rng.integers(-(1 << 15), 1 << 15, (n_filters, taps // 2 + 1))
    if density < 1.0:
        half *= rng.random(half.shape) < density
    return np.concatenate([half, half[:, :-1][:, ::-1]], axis=1)


def _mixed_bank(taps=31, seed=0):
    """Zero rows, single pulses at the extreme layers, low-layer rows and
    dense rows, interleaved so the occupancy sort must permute."""
    rng = np.random.default_rng(seed)
    half = taps // 2
    rows = [np.zeros(half + 1, np.int64) for _ in range(6)]
    rows[1][half] = 1 << 14
    rows[2] = rng.integers(-(1 << 15), 1 << 15, half + 1)
    rows[3][0] = 1
    rows[4] = rng.integers(-7, 8, half + 1)
    rows.append(rng.integers(-(1 << 15), 1 << 15, half + 1))
    return np.stack([np.concatenate([h, h[:-1][::-1]]) for h in rows])


def _sweep_rows(taps, n, seed=0):
    bank = sweep_bank(taps, n_div=20)
    rows = np.random.default_rng(seed).choice(len(bank), n, replace=False)
    return po2_quantize_batch(bank[rows], 16)[0]


def _group_on_card(frames, g, taps: int, tile: int) -> torch.Tensor:
    """One tile group through K1 (`bank_apply` over the group's own
    tables, its rows in order): (rows, C, n_tiles, tile) int32, as
    `bank_call_plain` returns it."""
    n_chan, n_tiles, _ = frames.shape
    terms = group_terms(g.packed, g.schedule, g.tail_shift, taps,
                        frames.device)
    return bank_apply(frames, terms, tile, n_tiles * tile).reshape(
        -1, n_chan, n_tiles, tile)


BANKS = {
    "random": lambda: _random_bank(40, 31, 1),
    "sparse": lambda: _random_bank(70, 63, 2, density=0.3),
    "mixed": lambda: _mixed_bank(31),
    "sweep127": lambda: _sweep_rows(127, 48),
    "lowpass255": lambda: spread_lowpass_qbank(33, 255),
}


@pytest.mark.parametrize("merge", [1, 8, 32])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_bank_kernel_matches_plain_per_group(cuda, bank, merge):
    q = BANKS[bank]()
    prog = compile_bank(q)
    rng = np.random.default_rng(merge)
    x = torch.as_tensor(rng.integers(-128, 128, (2, 1500)), dtype=torch.int32)
    for tile in (128, 512, 1024):
        sched = prog.schedule(bank_tile=16 if bank == "random" else None,
                              merge=merge)
        frames_cpu, _ = frame_signal_batch(x, prog.taps, tile)
        frames = frames_cpu.to(cuda)
        for g in sched.groups:
            if not g.sel_layers:
                continue
            op_cpu = torch.tensor(g.packed.view(np.int32))
            args = (prog.taps, g.schedule, g.tail_shift, tile)
            want = bank_call_plain(frames_cpu, op_cpu, *args)
            plain = bank_call_plain(frames, op_cpu.to(cuda), *args)
            got = _group_on_card(frames, g, prog.taps, tile)
            torch.cuda.synchronize()
            assert torch.equal(plain.cpu(), want)
            assert torch.equal(got.cpu(), want), (bank, merge, tile)


def test_bank_schedule_apply_skips_all_zero_groups(cuda):
    """All-zero groups have no terms: the one launch writes their rows as
    zeros among the others'."""
    q = _mixed_bank(31)
    prog = compile_bank(q)
    sched = prog.schedule(bank_tile=1)
    assert any(not g.sel_layers for g in sched.groups)
    x = torch.as_tensor(np.random.default_rng(3).integers(-128, 128, (3, 900)),
                        dtype=torch.int32)
    frames, n_out = frame_signal_batch(x, prog.taps, 256)
    reset_launch_counts()
    got = bank_schedule_apply(frames.to(cuda), sched, prog.taps, 256)
    torch.cuda.synchronize()
    assert bank_apply.launches == 1
    want = bank_schedule_apply(frames, sched, prog.taps, 256)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.cpu().numpy()[:, :, :n_out],
                          fir_bit_layers_batch(x.numpy(), q))


def test_bank_kernel_wraps_modulo_2_32(cuda):
    """Samples of ±2**20 overflow int32: the kernel must wrap exactly as
    the CPU plain version's int32 matmul does."""
    q = _random_bank(24, 31, 5)
    prog = compile_bank(q)
    sched = prog.schedule(merge=32)
    x = torch.as_tensor(
        np.random.default_rng(4).integers(-(1 << 20), 1 << 20, (1, 700)),
        dtype=torch.int32)
    frames, n_out = frame_signal_batch(x, prog.taps, 256)
    got = bank_schedule_apply(frames.to(cuda), sched, prog.taps, 256)
    want = bank_schedule_apply(frames, sched, prog.taps, 256)
    assert torch.equal(got.cpu(), want)
    oracle = fir_bit_layers_batch(x.numpy(), q).astype(np.int32)
    assert np.array_equal(got.cpu().numpy()[:, :, :n_out], oracle)


@pytest.mark.parametrize("samples", ["8bit", "20bit", "int32"])
@pytest.mark.parametrize("merge", [1, 8, 32])
@pytest.mark.parametrize("taps,n_filters", [(1, 3), (3, 9), (63, 300),
                                            (127, 48), (255, 20)])
def test_bank_kernel_whole_schedule(cuda, taps, n_filters, merge, samples):
    """One launch for every group of a schedule (one all-zero filter, so
    an all-zero group where the groups are single rows), written in the
    caller's order and cut at n_out: against the CPU plain version (int32
    matmul, exact for every sample width), and against the plain version
    on the card for 8-bit samples."""
    q = _random_bank(n_filters, taps, taps + merge, density=0.6)
    q[n_filters // 2] = 0
    prog = compile_bank(q)
    sched = prog.schedule(bank_tile=1 if n_filters <= 9 else None, merge=merge)
    x = _samples(2 * 1024 + 333, samples, taps, channels=2)
    for tile in (256, 1000):
        frames, n_out = frame_signal_batch(x, taps, tile)
        reset_launch_counts()
        got = bank_schedule_apply(frames.to(cuda), sched, taps, tile, n_out)
        torch.cuda.synchronize()
        assert bank_apply.launches == 1
        want = bank_schedule_apply(frames, sched, taps, tile, n_out)
        # rows 32-byte aligned (a padded buffer's view), unit stride
        assert got.shape == (n_filters, 2, n_out) and got.stride(2) == 1
        assert got.stride(1) % 8 == 0 and got.stride(0) == 2 * got.stride(1)
        assert torch.equal(got.cpu(), want), (tile, samples)
        # a contiguous result (odd n_out: rows only 4-byte aligned)
        dense = torch.full((n_filters, 2, n_out), 7, dtype=torch.int32,
                           device=cuda)
        bank_apply(frames.to(cuda), bank_terms(sched, taps, cuda), tile,
                   n_out, out=dense)
        assert n_out % 2 == 1 and torch.equal(dense.cpu(), want)
        if samples == "8bit":
            assert np.array_equal(want.numpy(),
                                  fir_bit_layers_batch(x.numpy(), q))
            for g in sched.groups:
                if g.sel_layers:
                    op = torch.tensor(g.packed.view(np.int32), device=cuda)
                    assert torch.equal(
                        _group_on_card(frames.to(cuda), g, taps, tile),
                        bank_call_plain(frames.to(cuda), op, taps, g.schedule,
                                        g.tail_shift, tile))


@pytest.mark.parametrize("value", [(1 << 31) - 1, -(1 << 31), (1 << 31) - 129,
                                   -(1 << 31) + 127])
def test_bank_kernel_accumulator_crosses_2_31(cuda, value):
    """x = 2**31 − 1 under the one-tap filter 1: the byte planes are (−1,
    0, 0, −128), and the Horner chain reaches −2**31 before its last
    product adds −1.  A saturating s32 accumulator would stop at −2**31;
    the kernel must wrap to 2**31 − 1.  Likewise near the other end, and
    under a three-tap bank whose coefficients span 16 layers."""
    x = torch.full((1, 1500), value, dtype=torch.int32)
    x[0, ::7] = -value - 1
    for q in (np.ones((2, 1), np.int64),
              np.array([[1, (1 << 15) - 1, 1], [-3, 1 << 14, -3]])):
        prog = compile_bank(q)
        sched = prog.schedule()
        frames, n_out = frame_signal_batch(x, prog.taps, 512)
        got = bank_schedule_apply(frames.to(cuda), sched, prog.taps, 512,
                                  n_out)
        want = bank_schedule_apply(frames, sched, prog.taps, 512, n_out)
        assert torch.equal(got.cpu(), want)


def test_bank_kernel_sweep_and_serve_shapes(cuda):
    """The main path's shapes: the 9,900-filter 127-tap sweep bank over
    16,384 samples through `blmac_fir_bank`, and one 256-filter 63-tap
    engine push of 4,096 samples; one launch each, bit-exact against the
    plain version on the card and the numpy oracle on sampled rows."""
    sweep_q = po2_quantize_batch(sweep_bank(127), 16)[0]
    rng = np.random.default_rng(21)
    x = rng.integers(-128, 128, (1, 16384))
    reset_launch_counts()
    y = blmac_fir_bank(x, sweep_q)
    torch.cuda.synchronize()
    assert bank_apply.launches == 1 and y.shape == (len(sweep_q), 1, 16258)
    sched = compile_bank(sweep_q).schedule()
    frames, n_out = frame_signal_batch(
        torch.as_tensor(x, dtype=torch.int32, device=cuda), 127, 1024)
    parts = []
    for g in sched.groups:
        op = torch.tensor(g.packed.view(np.int32), device=cuda)
        parts.append(bank_call_plain(frames, op, 127, g.schedule,
                                     g.tail_shift, 1024) if g.sel_layers
                     else torch.zeros((op.shape[0], 1, frames.shape[1], 1024),
                                      dtype=torch.int32, device=cuda))
    plain = torch.cat(parts).reshape(-1, 1, frames.shape[1] * 1024)
    plain = plain[torch.as_tensor(sched.inv, device=cuda)][:, :, :n_out]
    assert torch.equal(y, plain)
    rows = rng.choice(len(sweep_q), 32, replace=False)
    assert np.array_equal(y[torch.as_tensor(rows, device=cuda)].cpu().numpy(),
                          fir_bit_layers_batch(x, sweep_q[rows]))
    serve_q = spread_lowpass_qbank(256, 63)
    eng = FilterBankEngine(serve_q, channels=1, mode="packed")
    cpu = FilterBankEngine(serve_q, channels=1, mode="packed", device="cpu")
    s = rng.integers(-128, 128, (1, 3 * 4096))
    for k in range(3):
        reset_launch_counts()
        got = eng.push(s[:, k * 4096:(k + 1) * 4096])
        assert bank_apply.launches == 1
        assert np.array_equal(got, cpu.push(s[:, k * 4096:(k + 1) * 4096]))


def test_bank_launches_once_a_call(cuda):
    """`blmac_fir_bank` through the ops entry point, repeated (the tables
    are cached on the card: the second call builds nothing), and every
    packed engine push make exactly one K1 launch."""
    q = _sweep_rows(63, 40, seed=13)
    x = np.random.default_rng(14).integers(-128, 128, (2, 5000))
    prog = compile_bank(q)
    for _ in range(2):
        reset_launch_counts()
        y = blmac_fir_bank(x, q)
        assert bank_apply.launches == 1 and specialized_call.launches == 0
        assert np.array_equal(y.cpu().numpy(), fir_bit_layers_batch(x, q))
    assert bank_terms(prog.schedule(), 63, cuda) is bank_terms(
        prog.schedule(), 63, cuda)
    eng = FilterBankEngine(prog, channels=2, mode="packed")
    assert eng._terms is bank_terms(prog.schedule(), 63, cuda)
    outs = []
    for a, b in ((0, 40), (40, 1000), (1000, 1001), (1001, 5000)):
        reset_launch_counts()
        outs.append(eng.push(x[:, a:b]))
        assert bank_apply.launches == (1 if b > 62 else 0), (a, b)
    assert np.array_equal(np.concatenate(outs, 2), fir_bit_layers_batch(x, q))


def test_bank_kernel_rejects_what_it_cannot_take(cuda):
    q = _random_bank(4, 15, 11)
    sched = compile_bank(q).schedule()
    frames, n_out = frame_signal_batch(
        torch.zeros((1, 300), dtype=torch.int32, device=cuda), 15, 128)
    on_cpu = bank_terms(sched, 15, "cpu")
    with pytest.raises(ValueError):  # tables on another device
        bank_apply(frames, on_cpu, 128, n_out)
    with pytest.raises(ValueError):  # more outputs than the frames hold
        bank_apply(frames, bank_terms(sched, 15, cuda), 128, 10_000)


def _samples(n, kind, seed, channels=None):
    """Seeded int32 samples: 8-bit, ±2**20 or the whole int32 range
    (the last two wrap modulo 2**32 in every filter output)."""
    rng = np.random.default_rng(seed)
    shape = n if channels is None else (channels, n)
    lim = {"8bit": 1 << 7, "20bit": 1 << 20, "int32": 1 << 31}[kind]
    return torch.as_tensor(rng.integers(-lim, lim, shape), dtype=torch.int32)


def _special_bank(taps, seed):
    """Filters of different pulse counts: dense, sparse, empty, centre tap
    only, all pulses in one layer, and the low layers empty."""
    half = taps // 2
    q = _random_bank(6, taps, seed, density=0.5)
    q[1] = _random_bank(1, taps, seed + 1)[0]
    q[2] = 0
    q[3] = 0
    q[3, half] = -1_000_003
    q[4] = np.where(q[1] > 0, 64, -64)
    q[5] = q[5] // 8 * 8
    return q


@pytest.mark.parametrize("samples", ["8bit", "20bit", "int32"])
@pytest.mark.parametrize("taps", [7, 63, 127, 255])
def test_specialized_kernel_matches_plain(cuda, taps, samples):
    q = _special_bank(taps, taps)
    prog = compile_bank(q)
    x = _samples(3000, samples, taps)
    for tile in (128, 512, 1024):
        frames, _ = frame_signal(x, taps, tile)
        for b in range(prog.n_filters):
            pulses = pulses_from_packed(prog.packed[b], taps)
            want = specialized_plain(frames, pulses, taps, tile)
            plain = specialized_plain(frames.to(cuda), pulses, taps, tile)
            got = specialized_call(frames.to(cuda),
                                   specialized_program(pulses, taps, tile,
                                                       str(cuda)))
            torch.cuda.synchronize()
            assert torch.equal(plain.cpu(), want)
            assert got.shape == (1,) + want.shape
            assert torch.equal(got[0].cpu(), want), (b, tile)


@pytest.mark.parametrize("samples", ["8bit", "int32"])
@pytest.mark.parametrize("taps,tile", [(63, 512), (255, 1024)])
def test_specialized_kernel_many_filters_and_channels(cuda, taps, tile,
                                                      samples):
    """Every filter of a bank over every channel in one launch, the
    frames an overlapping view of the signal on the card, the last tile
    ragged; against the plain version and the numpy oracle."""
    q = _special_bank(taps, taps + 3)
    scheds = compile_bank(q).pulse_schedules()
    x = _samples(5 * tile + 77, samples, taps, channels=3)
    frames, n_out = frame_signal_batch(x.to(cuda), taps, tile)
    prog = SpecializedProgram(scheds, taps, tile, cuda)
    reset_launch_counts()
    got = specialized_call(frames, prog)
    torch.cuda.synchronize()
    assert specialized_call.launches == 1
    cpu_frames, _ = frame_signal_batch(x, taps, tile)
    want = torch.stack([specialized_plain(cpu_frames, p, taps, tile)
                        for p in scheds])
    assert torch.equal(got.cpu(), want)
    oracle = fir_bit_layers_batch(x.numpy().astype(np.int64), q)
    assert np.array_equal(got.cpu().reshape(len(q), 3, -1)[:, :, :n_out]
                          .numpy(), oracle.astype(np.int32))


@pytest.mark.parametrize("outs", [16, 4])
def test_specialized_kernel_both_thread_widths(cuda, monkeypatch, outs):
    """K2 keeps 16 outputs a thread, or 4 on a grid too small to fill the
    card: each width forced on the same banks, tiles and samples (the
    tap loop unrolled by the width, the register rings modulo it)."""
    import importlib

    bfm = importlib.import_module("repro_torch.kernels.blmac_fir")
    monkeypatch.setattr(bfm, "SMALL_GRID_WARPS_PER_SM",
                        10 ** 9 if outs == 4 else 0)
    for taps, samples in ((7, "int32"), (63, "8bit"), (127, "20bit"),
                          (255, "int32")):
        q = _special_bank(taps, taps + 1)
        scheds = compile_bank(q).pulse_schedules()
        x = _samples(2 * 1024 + 333, samples, taps, channels=2)
        for tile in (128, 512, 1024):
            frames, _ = frame_signal_batch(x, taps, tile)
            prog = SpecializedProgram(scheds, taps, tile, cuda)
            assert bfm.specialized_outs(len(scheds), 2, frames.shape[1], tile,
                                        bfm.sm_count(cuda)) == outs
            got = specialized_call(frames.to(cuda), prog)
            want = torch.stack([specialized_plain(frames, p, taps, tile)
                                for p in scheds])
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (taps, tile)


@pytest.mark.parametrize("n_segs", [1, 2, 3, 4])
def test_specialized_kernel_tap_segments(cuda, monkeypatch, n_segs):
    """On a small grid K2 splits each filter's walk into segments of taps
    and adds the partial sums in shared memory: every count of segments
    forced at 4 outputs a thread, over filters with empty, centre-only,
    one-tap and dense walks, on full-range samples, equals the plain
    version and the segmented table walk."""
    import importlib

    bfm = importlib.import_module("repro_torch.kernels.blmac_fir")
    monkeypatch.setattr(bfm, "SMALL_GRID_WARPS_PER_SM", 10 ** 9)
    monkeypatch.setattr(bfm, "SMALL_GRID_SEGMENTS", n_segs)
    for taps in (7, 63, 127, 255):
        q = _special_bank(taps, taps + 1)
        scheds = compile_bank(q).pulse_schedules()
        x = _samples(3 * 512 + 101, "int32", taps, channels=2)
        for tile in (128, 512):
            frames, _ = frame_signal_batch(x, taps, tile)
            prog = SpecializedProgram(scheds, taps, tile, cuda)
            threads = prog.geometries[4][0]
            assert prog.segments[4].shape[1] == min(n_segs, 512 // threads)
            got = specialized_call(frames.to(cuda), prog)
            want = torch.stack([specialized_plain(frames, p, taps, tile)
                                for p in scheds])
            walk = bfm.pulse_table_walk(
                frames.numpy(), prog.table.cpu().numpy(),
                prog.offsets.cpu().numpy(), taps, tile,
                prog.segments[4].cpu().numpy())
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (taps, tile)
            assert np.array_equal(walk, want.numpy())


def test_specialized_kernel_reads_strided_frames(cuda):
    """Views with other strides: every other tile, every other channel, a
    contiguous copy (stride frame_len), one channel's 2-D frames, and
    frames longer than tile + taps − 1."""
    taps, tile = 127, 512
    q = _special_bank(taps, 5)
    scheds = compile_bank(q).pulse_schedules()
    prog = SpecializedProgram(scheds, taps, tile, cuda)
    x = _samples(7 * tile + 300, "20bit", 6, channels=4).to(cuda)
    frames, _ = frame_signal_batch(x, taps, tile)
    # frames 1.5 tiles apart, 6 samples longer than tile + taps − 1
    apart = torch.nn.functional.pad(x, (0, 2 * tile)).unfold(
        -1, tile + taps + 5, 3 * tile // 2)
    views = [frames[:, ::2], frames[::2], frames.contiguous(), frames[2],
             apart]
    for v in views:
        got = specialized_call(v, prog)
        want = torch.stack([specialized_plain(v.cpu(), p, taps, tile)
                            for p in scheds])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), tuple(v.stride())


def test_specialized_launches_once_a_call(cuda):
    """`blmac_fir`, `blmac_fir_bank` with one filter over 3 channels, and
    every push of a specialized engine (8 filters × 2 channels) and of a
    one-filter auto engine make exactly one K2 launch."""
    q = _sweep_rows(63, 8, seed=11)
    x = np.random.default_rng(12).integers(-128, 128, (3, 5000))
    reset_launch_counts()
    y = blmac_fir(x[0], q[0])
    assert specialized_call.launches == 1
    assert np.array_equal(y.cpu().numpy(), fir_bit_layers_batch(x[0], q[0])[0, 0])
    reset_launch_counts()
    y = blmac_fir_bank(x, q[:1])
    assert specialized_call.launches == 1 and bank_apply.launches == 0
    assert np.array_equal(y.cpu().numpy(), fir_bit_layers_batch(x, q[:1]))
    for bank, mode in ((q, "specialized"), (q[:1], "auto")):
        eng = FilterBankEngine(bank, channels=2, mode=mode)
        assert eng.mode == "specialized"
        outs = []
        for a, b in ((0, 40), (40, 1000), (1000, 1001), (1001, 5000)):
            reset_launch_counts()
            outs.append(eng.push(x[:2, a:b]))
            assert specialized_call.launches == (1 if b > 62 else 0), (a, b)
        assert np.array_equal(np.concatenate(outs, 2),
                              fir_bit_layers_batch(x[:2], bank))


def test_specialized_kernel_rejects_mixed_devices(cuda):
    pulses = pulses_from_packed(compile_bank(_random_bank(1, 15, 13)).packed[0],
                                15)
    frames, _ = frame_signal(torch.zeros(300, dtype=torch.int32), 15, 128)
    on_cpu = specialized_program(pulses, 15, 128, "cpu")
    with pytest.raises(ValueError):
        specialized_call(frames.to(cuda), on_cpu)


def test_specialized_smem_matches_the_host_geometry(cuda):
    from repro_torch.kernels.build import library

    lib = library("blmac_specialized")
    for tile, taps, table_len in ((128, 7, 3), (1024, 127, 400),
                                  (4096, 255, 1500)):
        for outs in (16, 4):
            threads, _, tab_pad, smem = specialized_geometry(
                tile, taps, table_len, outs)
            assert lib.blmac_specialized_smem_bytes(tab_pad, threads, taps,
                                                    outs) == smem


def test_entry_points_on_the_card(cuda):
    q = _sweep_rows(63, 12, seed=7)
    x = np.random.default_rng(8).integers(-128, 128, (2, 5000))
    reset_launch_counts()
    y = blmac_fir_bank(x, q)
    assert y.device.type == "cuda" and bank_apply.launches == 1
    assert np.array_equal(y.cpu().numpy(), fir_bit_layers_batch(x, q))
    y1 = blmac_fir(x[0], q[0])
    assert specialized_call.launches > 0
    assert np.array_equal(y1.cpu().numpy(), fir_bit_layers_batch(x[0], q[0])[0, 0])
    y2 = blmac_fir(x[0], q[0], specialize=False)
    assert np.array_equal(y2.cpu().numpy(), y1.cpu().numpy())


@pytest.mark.parametrize("mode", ["packed", "specialized"])
def test_engine_on_the_card_matches_cpu_engine(cuda, mode):
    q = _sweep_rows(63, 6, seed=9)
    rng = np.random.default_rng(10)
    x = rng.integers(-128, 128, (2, 3000))
    gpu = FilterBankEngine(q, channels=2, mode=mode)
    cpu = FilterBankEngine(q, channels=2, mode=mode, device="cpu")
    cuts = [0, 40, 62, 63, 1000, 1001, 2999, 3000]
    for a, b in zip(cuts, cuts[1:]):
        assert np.array_equal(gpu.push(x[:, a:b]), cpu.push(x[:, a:b]))
    assert np.array_equal(gpu.snapshot_tail().tail, cpu.snapshot_tail().tail)


def test_kernel_rejects_mixed_devices(cuda):
    prog = compile_bank(_random_bank(4, 15, 11))
    g = prog.schedule().groups[0]
    frames, _ = frame_signal_batch(torch.zeros((1, 300), dtype=torch.int32),
                                   15, 128)
    with pytest.raises(ValueError):  # the group's tables left on the CPU
        bank_apply(frames.to(cuda),
                   group_terms(g.packed, g.schedule, g.tail_shift, 15), 128,
                   frames.shape[1] * 128)


def test_build_reports_kernel_resources(cuda):
    from repro_torch.kernels.build import build_all

    infos = build_all()
    res = {k: v for info in infos.values() for k, v in info.resources().items()}
    assert set(res) == {"blmac_specialized_kernel<16>",
                        "blmac_specialized_kernel<4>"} | {
        f"blmac_combine_kernel<{vec}, {wide}>" for vec in ("true", "false")
        for wide in ("true", "false")} | {
        f"blmac_bank_kernel<{ks}>" for ks in (1, 2, 3, 4)} | {
        f"blmac_pulse_matmul_kernel<{bm}, {std}>"
        for bm in (8, 16, 64, 128) for std in ("true", "false")}
    assert all(r["registers"] > 0 for r in res.values())


# -- the combine fold of CSE-optimized banks ----------------------------------

def _sparse_combine(n_real, n_shared, per_row, seed, top=14):
    """A random (n_real, n_shared) combine matrix with about ``per_row``
    nonzeros a row, signed powers of two below 2**top, row 0 empty."""
    rng = np.random.default_rng(seed)
    combine = np.zeros((n_real, n_shared), np.int64)
    rows = np.repeat(np.arange(1, n_real), per_row)
    cols = rng.integers(0, n_shared, rows.size)
    combine[rows, cols] = rng.choice([-1, 1], rows.size) << rng.integers(
        0, top, rows.size)
    return combine


def _serve_combine():
    from repro_torch.compiler import cse_pass

    return cse_pass(compile_bank(spread_lowpass_qbank(256, 63))).combine


def _fold_on_card(y_host, combine, cuda, padded, offset=0):
    """The fold kernel over ``y_host`` (int32 (rows, C, n)) on the card,
    into a contiguous buffer or a `bank_output` view (rows padded); with
    ``offset``, the buffer's first ``offset`` words are skipped, so no
    row starts on 16 bytes."""
    rows, n_chan, n = y_host.shape
    if padded and not offset:
        y = bank_output(rows, n_chan, n, cuda)
    elif padded:
        ld = -(-(n + offset) // 8) * 8
        y = torch.empty((rows, n_chan, ld), dtype=torch.int32,
                        device=cuda)[:, :, offset:offset + n]
    else:
        y = torch.empty(rows * n_chan * n + offset, dtype=torch.int32,
                        device=cuda)[offset:].view(rows, n_chan, n)
    y.copy_(torch.as_tensor(y_host))
    table = combine_table(combine, cuda)
    reset_launch_counts()
    out = combine_fold(y, table)
    torch.cuda.synchronize()
    assert combine_fold.launches == 1
    assert out.data_ptr() == y.data_ptr() and out.shape[0] == table.n_real
    assert torch.equal(y[table.n_real:].cpu(),
                       torch.as_tensor(y_host[table.n_real:]))
    return out


def _wide_row_combine():
    """A row with more nonzeros than a block can stage (cut into pieces
    added with atomics) beside ordinary rows."""
    combine = _sparse_combine(6, 2500, 30, 24)
    combine[2, :2400] = np.random.default_rng(25).choice([-3, 5], 2400)
    return combine


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", ["serve", "one_shared", "wrap", "channels",
                                  "short", "mid_vector", "unaligned",
                                  "many_shared", "wide_row"])
def test_combine_kernel_matches_plain(cuda, case, padded):
    rng = np.random.default_rng(11)
    offset = 0
    if case == "serve":  # the serve bank's own combine, one push
        combine, n_chan, n = _serve_combine(), 1, 4158
    elif case == "one_shared":
        combine, n_chan, n = _sparse_combine(40, 1, 1, 12), 1, 1000
    elif case == "wrap":  # coefficients to 2**30: the sums wrap
        combine, n_chan, n = _sparse_combine(64, 30, 12, 13, top=31), 1, 777
    elif case == "channels":
        combine, n_chan, n = _sparse_combine(100, 50, 9, 14), 3, 2049
    elif case == "short":  # fewer samples than one span: many row groups
        combine, n_chan, n = _sparse_combine(2000, 300, 20, 21), 1, 20
    elif case == "mid_vector":  # the last span ends inside a lane's 4
        combine, n_chan, n = _sparse_combine(300, 200, 30, 22), 1, 166
    elif case == "unaligned":  # no row starts on 16 bytes
        combine, n_chan, n, offset = _serve_combine(), 1, 4096, 1
    elif case == "many_shared":  # a group's union split to fit
        combine, n_chan, n = _sparse_combine(200, 4000, 40, 23), 1, 500
    else:
        combine, n_chan, n = _wide_row_combine(), 2, 300
    rows = sum(combine.shape)
    y_host = rng.integers(-(1 << 31), 1 << 31, (rows, n_chan, n)) \
        .astype(np.int32)
    got = _fold_on_card(y_host, combine, cuda, padded, offset)
    want = combine_plain(torch.as_tensor(y_host), combine, combine.shape[0])
    assert torch.equal(got.cpu(), want)
    if case != "wrap":  # the plain fold's float64 route on the card
        plain = combine_plain(torch.as_tensor(y_host).to(cuda), combine,
                              combine.shape[0])
        assert torch.equal(plain.cpu(), want)


@functools.lru_cache(maxsize=1)
def _sweep_combine():
    from repro_torch.compiler import cse_pass

    q, _ = po2_quantize_batch(sweep_bank(127), 16)
    return cse_pass(compile_bank(q)).combine


@pytest.mark.parametrize("padded", [False, True])
def test_combine_kernel_on_the_sweep_bank_combine(cuda, padded):
    """The sweep bank's own combine (9,900 x 1,424, 828,212 nonzeros;
    clustered columns, one shared row used by 7,385 real rows) over
    16,258 full-range samples: the kernel against the plain fold on the
    card, and 16 rows against int64 numpy."""
    combine = _sweep_combine()
    rng = np.random.default_rng(26)
    y_host = rng.integers(-(1 << 31), 1 << 31,
                          (sum(combine.shape), 1, 16258)).astype(np.int32)
    got = _fold_on_card(y_host, combine, cuda, padded)
    plain = combine_plain(torch.as_tensor(y_host).to(cuda), combine, 9900)
    assert torch.equal(got, plain)
    rows = rng.choice(9900, 16, replace=False)
    want = (y_host[rows].astype(np.int64) + np.tensordot(
        combine[rows], y_host[9900:].astype(np.int64), axes=1)) \
        .astype(np.int32)
    assert np.array_equal(got[torch.as_tensor(rows, device=cuda)].cpu()
                          .numpy(), want)


def test_combine_kernel_at_the_sweep_shape(cuda):
    """1,424 shared rows into 9,900 real ones over 16,258 samples (the
    sweep bank's sizes, about 84 nonzeros a row): the kernel against the
    plain fold on the card, and 32 rows against int64 numpy."""
    combine = _sparse_combine(9900, 1424, 84, 15)
    rng = np.random.default_rng(16)
    y_host = rng.integers(-128 * 2 ** 16, 128 * 2 ** 16,
                          (sum(combine.shape), 1, 16258)).astype(np.int32)
    got = _fold_on_card(y_host, combine, cuda, padded=True)
    plain = combine_plain(torch.as_tensor(y_host).to(cuda), combine, 9900)
    assert torch.equal(got, plain)
    rows = rng.choice(9900, 32, replace=False)
    want = (y_host[rows].astype(np.int64) + np.tensordot(
        combine[rows], y_host[9900:].astype(np.int64), axes=1)) \
        .astype(np.int32)
    assert np.array_equal(got[torch.as_tensor(rows, device=cuda)].cpu()
                          .numpy(), want)


def test_combine_kernel_rejects_what_it_cannot_take(cuda):
    combine = _sparse_combine(8, 4, 2, 17)
    y = torch.zeros((12, 1, 100), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the table left on the CPU
        combine_fold(y, combine_table(combine, "cpu"))
    table = combine_table(combine, cuda)
    for bad in (y.to(torch.int64), y[:11], y.transpose(1, 2)):
        with pytest.raises(ValueError):
            combine_fold(bad, table)


@pytest.mark.parametrize("mode", ["auto", "packed", "specialized"])
def test_engine_with_an_optimized_program_matches_cpu(cuda, mode):
    from repro_torch.compiler import cse_pass

    q = spread_lowpass_qbank(64, 63)
    opt = cse_pass(compile_bank(q))
    rng = np.random.default_rng(18)
    x = rng.integers(-(1 << 31), 1 << 31, (2, 6000))
    gpu = FilterBankEngine(opt, channels=2, mode=mode)
    cpu = FilterBankEngine(opt, channels=2, mode=gpu.mode, device="cpu",
                           tile=gpu.tile)
    uses_fold = gpu.program.combine is not None
    assert gpu.n_filters == len(q) and np.array_equal(gpu.qbank, q)
    cuts = [0, 40, 62, 63, 1000, 1001, 4999, 6000]
    for a, b in zip(cuts, cuts[1:]):
        reset_launch_counts()
        got = gpu.push(x[:, a:b])
        assert np.array_equal(got, cpu.push(x[:, a:b]))
        if got.shape[2]:
            assert bank_apply.launches + specialized_call.launches == 1
            assert combine_fold.launches == int(uses_fold)
    want = fir_bit_layers_batch(x[:, -(got.shape[2] + 62):], q)
    assert np.array_equal(got, want.astype(np.int32))


LOWER_BANKS = {
    "sweep127": lambda: _sweep_rows(127, 40, seed=21),
    "mixed": lambda: _mixed_bank(31, seed=22),
    "one_filter": lambda: _sweep_rows(127, 1, seed=23),
    "lowpass63": lambda: spread_lowpass_qbank(96, 63),
}


@pytest.mark.parametrize("samples", ["8bit", "int32"])
@pytest.mark.parametrize("optimized", [False, True], ids=["plain", "cse"])
@pytest.mark.parametrize("backend", ["scheduled", "specialized"])
@pytest.mark.parametrize("bank", sorted(LOWER_BANKS))
def test_lower_on_the_card_matches_the_oracle(cuda, bank, backend, optimized,
                                              samples):
    """`lower()`'s kernel backends on the card: one K1 or one K2 launch a
    call for every filter and channel, one fold more on an optimized
    program, the oracle's numbers modulo 2**32 (tolerance 0), and the
    same as the plain versions on the CPU."""
    from repro_torch.compiler import cse_pass, lower

    q = LOWER_BANKS[bank]()
    prog = compile_bank(q)
    if optimized:
        prog = cse_pass(prog)
    lim = 128 if samples == "8bit" else 1 << 31
    x = np.random.default_rng(24).integers(-lim, lim, (2, 3000))
    want = lower(prog, "oracle")(x).astype(np.int32)
    exe = lower(prog, backend)  # no device: the card
    assert exe.device.type == "cuda"
    reset_launch_counts()
    got = exe(x)
    kernel = bank_apply if backend == "scheduled" else specialized_call
    other = specialized_call if backend == "scheduled" else bank_apply
    assert (kernel.launches, other.launches) == (1, 0)
    assert combine_fold.launches == int(prog.combine is not None)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, lower(prog, backend, device="cpu")(x))
    assert np.array_equal(exe(x[0]), want[:, :1])  # a 1-D signal


def test_lower_on_the_card_against_the_vmachine(cuda):
    """The CSE-optimized sweep rows through K1 and K2 equal the widened
    vmachine's exact int64 fold, fit mask and all."""
    from repro_torch.compiler import cse_pass, lower

    opt = cse_pass(compile_bank(_sweep_rows(127, 200, seed=25)))
    x = np.random.default_rng(26).integers(-128, 128, 126 + 700)
    vm = lower(opt, "vmachine")
    want = vm(x)
    assert vm.fits.shape == (opt.n_filters,)
    for backend in ("scheduled", "specialized"):
        assert np.array_equal(lower(opt, backend, device=cuda)(x), want)


def test_one_filter_auto_engine_plans_the_specialized_kernel(cuda):
    eng = FilterBankEngine(_sweep_rows(127, 1, seed=19), channels=2)
    assert eng.dispatch_plan.lane == "cuda"
    assert eng.mode == "specialized"


def test_cuda_calibration_is_written_and_keyed_on_the_card(cuda, tmp_path,
                                                           monkeypatch):
    import json

    from repro_torch.core import costmodel as cm

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    cal = cm.calibrate_backend("cuda", cuda)
    name = torch.cuda.get_device_name(cuda)
    assert cal.device_name == name and cal.source == "fitted"
    table = json.loads((tmp_path / "calibration.json").read_text())
    assert list(table["cuda"]) == [name]
    assert cm.get_calibration("cuda", cuda) == cal
    assert cal.call_us > 0 and cal.spec_call_us > 0 and cal.fold_call_us > 0
    assert min(cal.byte_us, cal.mac_us, cal.spec_op_us, cal.fold_byte_us,
               cal.fold_op_us) >= 0
    monkeypatch.setattr(cm, "_probe_bank", _failing_probe)
    assert cm.ensure_calibration("cuda", cuda) == cal  # no second fit


def _failing_probe(*args, **kwargs):
    raise RuntimeError("probe failed")


@pytest.mark.parametrize("probe", ["_probe_bank", "_probe_specialized",
                                   "_probe_fold"])
def test_a_failing_calibration_probe_raises(cuda, tmp_path, monkeypatch,
                                            probe):
    from repro_torch.compiler import clear_caches
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import autotune_bank_dispatch

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cm, probe, _failing_probe)
    clear_caches()
    prog = compile_bank(_sweep_rows(63, 4, seed=20))
    with pytest.raises(RuntimeError, match="probe failed"):
        cm.calibrate_backend("cuda", cuda)
    with pytest.raises(RuntimeError, match="probe failed"):
        autotune_bank_dispatch(prog, device=cuda)
    with pytest.raises(RuntimeError, match="probe failed"):
        FilterBankEngine(prog, mode="auto")
    assert not (tmp_path / "calibration.json").exists()


# -- the pulse-code matmul ----------------------------------------------------

def _pulse_weights(k, n, seed, planes):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)) * np.exp2(rng.integers(-8, 8, (k, n)))
    codes, ge = pulse_quantize(w, planes, device="cpu")
    return rng, codes, ge


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (K, N, M): the reference's CPU grid and odd edges, then every tile the
# launch plan can choose (M of 1 to 200) at N off the 128-column tile, with
# a K of one split (32) and a K of many (8,192); the 128-row wgmma tile
# takes a wide N (one split at K = 64, many at K = 4,096).
# `tests/test_torch_pulse.py` checks on the CPU that these reach every
# tile with one split and with many.
PLAN_CASES = [(128, 128, 8), (512, 256, 16), (256, 384, 4), (256, 200, 37),
              (2048, 136, 130)] + [
    (k, 200, m) for m in (1, 4, 8, 16, 17, 64, 128, 200) for k in (32, 8192)
] + [(64, 11000, 128), (64, 11000, 200), (4096, 1000, 128), (4096, 1000, 200)]


@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("k,n,m", PLAN_CASES)
def test_pulse_matmul_kernel_matches_plain(cuda, planes, k, n, m):
    """Every launch plan against the plain version and float64: the
    swapped 8- and 16-row tiles, the wgmma tiles of 64 and 128 rows and
    ragged M, N off the tile, one split of K and many."""
    rng, codes, ge = _pulse_weights(k, n, planes * k + n, planes)
    x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    plan = bmm.cuda_launch_plan(m, n, k, planes, bmm.GROUP, cuda)
    if k <= 64:
        assert plan.splits == 1
    if k >= 4096:
        assert plan.splits > 1
    want = pulse_matmul_ref(x, codes, ge)
    plain = pulse_matmul_ref(x.to(cuda), codes.to(cuda), ge.to(cuda))
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), planes)
    torch.cuda.synchronize()
    assert _rel_err(plain.cpu(), want) < 1e-5
    assert _rel_err(got.cpu(), want) < 1e-5, (planes, k, n, m, plan)
    x64 = x.double() @ pulse_dequantize(codes, ge)
    assert _rel_err(got.cpu().double(), x64) < 1e-5


def test_pulse_matmul_counts_one_launch_a_call(cuda):
    """Each call adds exactly one to ``pulse_matmul.launches``, with one
    split of K and with many (the split sum runs in the same launch)."""
    for k in (32, 8192):
        rng, codes, ge = _pulse_weights(k, 256, k, 4)
        x = torch.as_tensor(rng.standard_normal((4, k)), dtype=torch.float32,
                            device=cuda)
        codes, ge = codes.to(cuda), ge.to(cuda)
        before = pulse_matmul.launches
        pulse_matmul(x, codes, ge, 4)
        assert pulse_matmul.launches == before + 1
        pulse_matmul_op(x, codes, ge, 4)
        assert pulse_matmul.launches == before + 2


@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m,tile", [(4, 8), (16, 16), (64, 64), (128, 128)])
def test_pulse_matmul_decode_is_exact(cuda, group, m, tile):
    """x = rows of I: every output is one weight plus exact zeros, so the
    kernel's decode must equal the plain decode bit for bit, denormal
    weights included: groups of 2**-130 (below the exponent clip) and of
    2**-140 (group exponent below -112, whose pulses TF32 cannot hold)
    take the CUDA-core route, on every tile (N wide enough that M = 128
    takes the 128-row one)."""
    w = np.random.default_rng(group).standard_normal((128, 11000))
    w[:, :16] *= 2.0 ** -130  # groups below the exponent clip
    w[:, 32:48] *= 2.0 ** -140
    w[:group, 16:32] = 0.0
    codes, ge = pulse_quantize(w, 4, group=group, device="cpu")
    assert (ge < bmm.MIN_TENSOR_EXP).any()
    assert bmm.cuda_launch_plan(m, 11000, 128, 4, group, cuda).bm == tile
    eye = torch.eye(128, dtype=torch.float32, device=cuda)
    want = pulse_decode_ref(codes, ge)
    assert (want[:, 32:48] != 0).any()
    codes, ge = codes.to(cuda), ge.to(cuda)
    for r0 in range(0, 128, m):
        got = pulse_matmul(eye[r0:r0 + m], codes, ge, 4, group=group)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want[r0:r0 + m]), r0


@pytest.mark.parametrize("group", [4, 12, 20])
@pytest.mark.parametrize("m", [4, 16, 128])
def test_pulse_matmul_groups_not_a_multiple_of_8(cuda, group, m):
    """Groups that split an 8-row chunk of K: each row takes its own
    group's exponent (x = rows of I gives the plain decode bit for bit) and
    random x meets the reference's bound."""
    k, n = 240, 160
    rng = np.random.default_rng(group * m)
    w = rng.standard_normal((k, n)) * np.exp2(rng.integers(-12, 12, (k, 1)))
    codes, ge = pulse_quantize(w, 4, group=group, device="cpu")
    dec = pulse_decode_ref(codes, ge)
    eye = torch.eye(k, dtype=torch.float32)
    for r0 in range(0, k, m):
        rows = eye[r0:r0 + m].to(cuda)
        got = pulse_matmul(rows, codes.to(cuda), ge.to(cuda), 4, group=group)
        assert torch.equal(got.cpu(), dec[r0:r0 + m]), r0
    x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 4,
                       group=group)
    assert _rel_err(got.cpu(), pulse_matmul_ref(x, codes, ge)) < 1e-5
    x64 = x.double() @ pulse_dequantize(codes, ge, group=group)
    assert _rel_err(got.cpu().double(), x64) < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pulse_matmul_half_inputs(cuda, dtype):
    rng, codes, ge = _pulse_weights(256, 128, 3, 2)
    x = torch.as_tensor(rng.standard_normal((8, 256))).to(dtype)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 2)
    want = pulse_matmul_ref(x.float(), codes, ge)
    assert got.dtype == torch.float32
    assert _rel_err(got.cpu(), want) < 1e-5


def test_pulse_quantize_on_the_card_matches_cpu(cuda):
    vals = []
    for k in (2, 5, -7, 20, 0, -126, -130, -149):
        b = 2.0 ** k
        vals += [b, np.nextafter(b, np.inf), -b, 1.5 * b]
    w = np.random.default_rng(5).standard_normal((96, len(vals) + 40)) * 0.02
    w[0, :len(vals)] = vals
    w[:, -1] = 2.0 ** -130
    w[:32, -2] = 0.0
    for planes in (1, 2, 4):
        c_cpu, g_cpu = pulse_quantize(w, planes, device="cpu")
        c_gpu, g_gpu = pulse_quantize(w, planes, device=cuda)
        assert c_gpu.device.type == "cuda"
        assert torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(g_gpu.cpu(), g_cpu)
        assert torch.equal(pulse_dequantize(c_gpu, g_gpu).cpu(),
                           pulse_dequantize(c_cpu, g_cpu))


def test_pulse_entry_points_on_the_card(cuda):
    rng, codes, ge = _pulse_weights(256, 256, 9, 4)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    pulse_matmul.launches = 0
    y = pulse_matmul_op(x, codes.numpy(), ge.numpy(), 4)
    torch.cuda.synchronize()
    assert y.device.type == "cuda" and pulse_matmul.launches == 1
    want = pulse_matmul_op(x, codes, ge, 4, device="cpu")
    assert _rel_err(y.cpu(), want) < 1e-5
    state = {"ffn/down": torch.as_tensor(rng.standard_normal((1, 256, 64)),
                                         dtype=torch.float32),
             "norm/scale": torch.ones((64, 64))}
    got, stats = quantize_param_tree(state, 4)
    want, want_stats = quantize_param_tree(state, 4, device="cpu")
    assert stats["n_quantized"] == want_stats["n_quantized"] == 1
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


def test_pulse_matmul_rejects_mixed_devices(cuda):
    _, codes, ge = _pulse_weights(64, 32, 1, 1)
    x = torch.ones((2, 64))
    with pytest.raises(ValueError):
        pulse_matmul(x.to(cuda), codes, ge.to(cuda), 1)
    with pytest.raises(ValueError):
        pulse_matmul(x, codes.to(cuda), ge.to(cuda), 1)


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 128, 130])
def test_pulse_matmul_rows_across_tiles(cuda, m):
    """Every M on both sides of each tile's edge (the swapped 8- and 16-row
    tiles, 64 and 128), against the plain version and float64."""
    rng, codes, ge = _pulse_weights(1024, 320, 100 + m, 4)
    x = torch.as_tensor(rng.standard_normal((m, 1024)), dtype=torch.float32)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 4)
    want = pulse_matmul_ref(x, codes, ge)
    assert tuple(got.shape) == (m, 320)
    assert _rel_err(got.cpu(), want) < 1e-5
    x64 = x.double() @ pulse_dequantize(codes, ge)
    assert _rel_err(got.cpu().double(), x64) < 1e-5


@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("n", [100, 37])
def test_pulse_matmul_unaligned_columns(cuda, m, n):
    """N not a multiple of 16: codes and exponents load without cp.async."""
    rng, codes, ge = _pulse_weights(512, n, n + m, 2)
    x = torch.as_tensor(rng.standard_normal((m, 512)), dtype=torch.float32)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 2)
    assert _rel_err(got.cpu(), pulse_matmul_ref(x, codes, ge)) < 1e-5


@pytest.mark.parametrize("m", [4, 128])
def test_pulse_matmul_many_splits_of_k(cuda, m):
    """A long K over few columns: the plan splits K many times and the last
    block of each tile adds the partials; K not a multiple of 32."""
    k, group = 8192 + 16, 16
    rng = np.random.default_rng(m)
    w = rng.standard_normal((k, 64)) * np.exp2(rng.integers(-8, 8, (k, 64)))
    codes, ge = pulse_quantize(w, 4, group=group, device="cpu")
    x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    plan = bmm.cuda_launch_plan(m, 64, k, 4, group, cuda)
    assert plan.splits >= 8
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 4,
                       group=group)
    x64 = x.double() @ pulse_dequantize(codes, ge, group=group)
    assert _rel_err(got.cpu().double(), x64) < 1e-5


@pytest.mark.parametrize("m", [4, 128])
def test_pulse_matmul_is_deterministic(cuda, m):
    """Two launches on the same operands agree bit for bit: the split-K
    partials are added in split order whichever block finishes last."""
    rng, codes, ge = _pulse_weights(4096, 512, 7 * m, 4)
    x = torch.as_tensor(rng.standard_normal((m, 4096)), dtype=torch.float32,
                        device=cuda)
    codes, ge = codes.to(cuda), ge.to(cuda)
    assert bmm.cuda_launch_plan(m, 512, 4096, 4, bmm.GROUP, cuda).splits > 1
    first = pulse_matmul(x, codes, ge, 4)
    for _ in range(3):
        assert torch.equal(pulse_matmul(x, codes, ge, 4), first)


def test_pulse_matmul_streams_keep_their_own_split_buffers(cuda):
    """A split launch on a side stream draws its tickets from buffers of
    its own (keyed by CUDA's ID of the stream), and gives the default
    stream's result bit for bit; released buffers are made anew."""
    rng, codes, ge = _pulse_weights(4096, 512, 11, 4)
    x = torch.as_tensor(rng.standard_normal((4, 4096)), dtype=torch.float32,
                        device=cuda)
    codes, ge = codes.to(cuda), ge.to(cuda)
    assert bmm.cuda_launch_plan(4, 512, 4096, 4, bmm.GROUP, cuda).splits > 1
    bmm.release_split_buffers()
    first = pulse_matmul(x, codes, ge, 4)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        again = [pulse_matmul(x, codes, ge, 4) for _ in range(3)]
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert len(bmm._SPLIT_BUFFERS) == 2
    assert all(torch.equal(y, first) for y in again)
    bmm.release_split_buffers()
    assert not bmm._SPLIT_BUFFERS
    assert torch.equal(pulse_matmul(x, codes, ge, 4), first)


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_pulse_matmul_subnormal_groups_are_exact(cuda, planes):
    """Group exponent -127 and weights of 2**-130: such steps take the
    CUDA-core route, which keeps the decode exact (x = I)."""
    w = np.random.default_rng(planes).standard_normal((96, 80))
    w[:, :16] *= 2.0 ** -130
    w[:32, 16:32] = 2.0 ** -140
    codes, ge = pulse_quantize(w, planes, device="cpu")
    assert (ge == -127).any()
    eye = torch.eye(96, dtype=torch.float32, device=cuda)
    got = pulse_matmul(eye, codes.to(cuda), ge.to(cuda), planes)
    assert torch.equal(got.cpu(), pulse_decode_ref(codes, ge))
    for m in (4, 40):  # both tile shapes, x random
        x = torch.as_tensor(np.random.default_rng(m).standard_normal((m, 96)),
                            dtype=torch.float32)
        got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), planes)
        want = x.double() @ pulse_dequantize(codes, ge)
        assert _rel_err(got.cpu().double(), want) < 1e-5


def test_pulse_matmul_smem_matches_the_host_plan(cuda):
    from repro_torch.kernels.build import library

    lib = library("blmac_pulse_matmul")
    for tile in (8, 16, 64, 128):
        for planes in (1, 2, 4, 8, 16):
            for group in (1, 16, 32, 64):
                for stages in (3, 8):
                    assert lib.blmac_pulse_matmul_smem_bytes(
                        tile, planes, group, stages) == bmm.smem_bytes(
                            tile, planes, group, stages)


@pytest.mark.parametrize("m", [4, 40, 130])
def test_pulse_matmul_sixteen_planes(cuda, m):
    """16 planes: the ring holds 64 KB of codes a stage; M > 16 falls back
    to the 16-row tile."""
    rng = np.random.default_rng(16 + m)
    codes = torch.as_tensor(rng.integers(0, 256, (16, 256, 128)),
                            dtype=torch.uint8)
    ge = torch.as_tensor(rng.integers(-20, 0, (8, 128)), dtype=torch.int8)
    x = torch.as_tensor(rng.standard_normal((m, 256)), dtype=torch.float32)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 16)
    want = x.double() @ pulse_dequantize(codes, ge)
    assert _rel_err(got.cpu().double(), want) < 1e-5


@pytest.mark.parametrize("m", [4, 16, 128])
def test_pulse_matmul_model_scale_weights(cuda, m):
    """Weights of a model's scale (normal, std 0.02): every group exponent
    is negative, so every 2^e comes from the table's negative half."""
    rng = np.random.default_rng(20 + m)
    w = rng.standard_normal((1024, 384)) * 0.02
    codes, ge = pulse_quantize(w, 4, device="cpu")
    assert (ge < 0).all()
    x = torch.as_tensor(rng.standard_normal((m, 1024)), dtype=torch.float32)
    got = pulse_matmul(x.to(cuda), codes.to(cuda), ge.to(cuda), 4)
    want = x.double() @ pulse_dequantize(codes, ge)
    assert _rel_err(got.cpu().double(), want) < 1e-5


# ---------------------------------------------------------------------------
# the sharded engine on meshes of the card's slots
# ---------------------------------------------------------------------------


def _card_mesh(cuda, n_bank, n_data):
    from repro_torch.distributed import bank_mesh

    return bank_mesh(n_bank, n_data, devices=[cuda] * (n_bank * n_data))


@pytest.mark.parametrize("data_mode,channels", [("time", 1), ("channels", 4)])
def test_sharded_engine_on_a_card_mesh(cuda, data_mode, channels):
    """A (4, 2) mesh of the card's slots, time slices with the halo
    exchange or channel groups: every push equals the same engine on CPU
    slots and the numpy oracle; each of the 4 scheduled shards launches
    K1 once a data slot a push."""
    from repro_torch.distributed import bank_mesh
    from repro_torch.filters import ShardedFilterBankEngine

    q = _sweep_rows(63, 40, seed=12)
    rng = np.random.default_rng(13)
    x = rng.integers(-128, 128, (channels, 4 * 1500))
    kw = dict(channels=channels, n_bank_shards=4, data_mode=data_mode)
    gpu = ShardedFilterBankEngine(q, mesh=_card_mesh(cuda, 4, 2), **kw)
    cpu = ShardedFilterBankEngine(q, mesh=bank_mesh(
        4, 2, devices=["cpu"] * 8), **kw)
    assert gpu.data_mode == data_mode
    assert all(p.mode == "scheduled" for p in gpu.plan.shard_plans)
    outs = []
    for k in range(4):
        reset_launch_counts()
        p = gpu.push_async(x[:, k * 1500:(k + 1) * 1500])
        assert all(t.device == cuda for ts in p._shard_outs for t in ts)
        assert bank_apply.launches == 4 * 2
        outs.append(p.result())
        assert np.array_equal(outs[-1], cpu.push(x[:, k * 1500:
                                                     (k + 1) * 1500]))
    assert np.array_equal(np.concatenate(outs, axis=2),
                          fir_bit_layers_batch(x, q))
    times = gpu.time_shards(x[:, :1500], repeats=2)
    assert times.shape == (4,) and (times > 0).all()


def test_sharded_specialized_shards_and_lowering_on_the_card(cuda):
    """A narrow bank on a (2, 1) card mesh plans specialized shards (one
    K2 launch each a push); `lower(..., "sharded")` of a CSE program folds
    on the card after reassembly (one fold launch a call)."""
    from repro_torch.compiler import cse_pass, lower
    from repro_torch.filters import ShardedFilterBankEngine

    q = _sweep_rows(127, 4, seed=14)
    x = np.random.default_rng(15).integers(-128, 128, (2, 3000))
    eng = ShardedFilterBankEngine(q, channels=2, mesh=_card_mesh(cuda, 2, 1),
                                  n_bank_shards=2, chunk_hint=1500)
    modes = [p.mode for p in eng.plan.shard_plans]
    assert "specialized" in modes
    reset_launch_counts()
    y = eng.push(x)
    assert bank_apply.launches == modes.count("scheduled")
    assert specialized_call.launches == modes.count("specialized")
    assert np.array_equal(y, fir_bit_layers_batch(x, q))
    qq = _sweep_rows(63, 64, seed=16)
    opt = cse_pass(compile_bank(qq))
    exe = lower(opt, "sharded", channels=2, mesh=_card_mesh(cuda, 2, 2))
    reset_launch_counts()
    assert np.array_equal(exe(x), fir_bit_layers_batch(x, qq))
    assert combine_fold.launches == 1


def test_sharded_chaos_on_the_card(cuda):
    """The chaos leg on a (4, 1) card mesh through `AsyncBankServer`:
    two kills, the recovered stream equal to the oracle, every counter
    equal to the kills, the integrity probe on."""
    from torch_differential import port_chaos_check

    q = _sweep_rows(63, 32, seed=17)
    stats = port_chaos_check(q, [(1, 2), (0, 4)], n_chunks=7, chunk=1024,
                             n_bank_shards=4, mesh=_card_mesh(cuda, 4, 1))
    assert stats["lost_shards"] == stats["recoveries"] == 2
    assert stats["n_bank_shards"] == 2 and not stats["degraded"]


@pytest.mark.parametrize("n_filters", [8, 64])
def test_session_server_on_the_card(cuda, n_filters):
    """Tenants batched into the lanes of one engine on the card (K2 for 8
    filters, K1 for 64, as planned): every tenant equals the same server
    on the CPU and the oracle, one kernel launch a round; a pause and
    resume, a filter swap and a program swap carry the stream."""
    from repro_torch.serving import BankSessionServer

    q = spread_lowpass_qbank(n_filters, 31)
    q12 = spread_lowpass_qbank(n_filters, 31, coeff_bits=12)
    rng = np.random.default_rng(17)
    sels = [np.arange(i, i + 2) % n_filters for i in range(0, 10, 2)]
    xs = rng.integers(-2 ** 31, 2 ** 31, (len(sels), 6 * 300))
    outs = []
    for dev in (cuda, "cpu"):
        srv = BankSessionServer(q, n_slots=2, auto_step=False, device=dev)
        ts = [srv.open_session(sel) for sel in sels]
        got = [[] for _ in sels]
        reset_launch_counts()
        for k in range(6):
            if k == 2:
                got[1].append(ts[1].swap_filters(sels[1]))
                snap = ts[2].pause()
                ts[2] = srv.resume_session(snap, sels[2])
            if k == 4:
                srv.swap_program(q12)
            for t, x in zip(ts, xs):
                t.push(x[k * 300:(k + 1) * 300])
            srv.step()
            for g, t in zip(got, ts):
                g.append(t.pull())
        if dev is cuda:
            assert bank_apply.launches + specialized_call.launches \
                == srv.rounds == 6 * 3
        outs.append([np.concatenate(g, axis=1) for g in got])
    cut = 4 * 300 - 30
    for i, sel in enumerate(sels):
        assert np.array_equal(outs[0][i], outs[1][i])
        want = np.concatenate(
            [fir_bit_layers_batch(xs[i, :4 * 300], q[sel])[:, 0],
             fir_bit_layers_batch(xs[i, cut:], q12[sel])[:, 0]], axis=1)
        assert np.array_equal(outs[0][i], want.astype(np.int32))


def test_session_server_recovers_on_the_card(cuda, tmp_path):
    """A journal written by a server on the card recovers there, and
    sessions over a (4, 1) card mesh survive two kills with each fault
    attributed to its round's tenants."""
    import sys

    from repro_torch.distributed import bank_mesh
    from repro_torch.serving import BankSessionServer

    q = spread_lowpass_qbank(64, 31)
    srv = BankSessionServer(q, n_slots=4, auto_step=False, device=cuda,
                            journal=tmp_path / "wal", snapshot_every=2)
    x = np.random.default_rng(18).integers(-128, 128, (6, 5 * 200))
    ts = [srv.open_session([i, 63 - i], session_id=f"t{i}") for i in range(6)]
    for k in range(4):
        for t, xi in zip(ts, x):
            t.push(xi[k * 200:(k + 1) * 200])
        srv.step()
        for t in ts:
            t.pull()
    for t, xi in zip(ts, x):
        t.push(xi[800:])  # journaled, never stepped
    del srv
    rec = BankSessionServer.recover(tmp_path / "wal", compile_bank(q),
                                    n_slots=4, device=cuda)
    assert rec.engine.device == cuda
    for i in range(6):
        want = fir_bit_layers_batch(x[i], q[[i, 63 - i]])[:, 0, 800 - 30:]
        assert np.array_equal(rec.sessions[f"t{i}"].pull(), want)
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_differential import port_session_chaos_check

    st = port_session_chaos_check(q, [(1, 3), (0, 7)], n_bank_shards=4,
                                  mesh=bank_mesh(4, 1, devices=[cuda] * 4),
                                  journal_path=tmp_path / "chaos",
                                  integrity_check=True, sample_bits=32)
    assert st["lost_shards"] == 2 and sum(st["per_session"].values()) == 8


# -- the language-model serving stack (plain PyTorch on the card) -----------

LM_ARCHS = ("deepseek-coder-33b", "deepseek-v3-671b", "gemma2-27b",
            "internvl2-76b", "mamba2-370m", "mixtral-8x22b", "musicgen-large",
            "qwen2.5-3b", "recurrentgemma-2b", "starcoder2-3b")


def _lm_engine_pair(arch, cuda, compute_dtype="float32"):
    from repro_torch.configs import get_config
    from repro_torch.nn import init_params, model_decls
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch).reduced(compute_dtype=compute_dtype)
    if cfg.input_kind == "embeds":
        cfg = dataclasses.replace(cfg, input_kind="tokens")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    return (cfg, params, ServeEngine(cfg, params, 64, device="cpu"),
            ServeEngine(cfg, params, 64, device=cuda))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_arch_on_the_card_matches_the_cpu(cuda, arch,
                                                     monkeypatch):
    """Prefill and 4 decode steps in float32 with TF32 off: logits within
    1e-4 of their scale of the CPU's, tokens equal."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg, _, cpu, card = _lm_engine_pair(arch, cuda)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    tc, lc = cpu.generate(prompts, 5, with_logits=True)
    tg, lg = card.generate(prompts, 5, with_logits=True)
    assert tg.device == cuda and tg.dtype == torch.int32
    want = torch.stack(lc, 1)
    got = torch.stack(lg, 1).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(tg.cpu(), tc)


def test_lm_decode_matches_a_teacher_forced_forward_on_the_card(cuda):
    """bf16: each decode step's logits within 5% of the scale of one
    forward over prompt + generated prefix."""
    cfg, _, _, card = _lm_engine_pair("qwen2.5-3b", cuda, "bfloat16")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 12))
    toks, steps = card.generate(prompts, 6, with_logits=True)
    full = np.concatenate([prompts, toks[:, :-1].cpu().numpy()], 1)
    logits, _ = card.prefill(full)
    want = logits[:, prompts.shape[1] - 1:].float()
    got = torch.stack(steps, 1)
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())


def test_lm_engine_defaults_to_the_card_and_quantizes_there(cuda):
    from repro_torch.core.serve_quant import quantize_param_tree
    from repro_torch.nn import flatten_tree
    from repro_torch.serving import ServeEngine

    cfg, params, _, _ = _lm_engine_pair("qwen2.5-3b", cuda)
    eng = ServeEngine(cfg, params, 32)
    assert eng.device.type == "cuda"
    flat = flatten_tree(params)
    q_card, s_card = quantize_param_tree(flat, 4)
    q_cpu, s_cpu = quantize_param_tree(flat, 4, device="cpu")
    assert s_card == s_cpu
    assert all(torch.equal(q_card[k].cpu(), q_cpu[k]) for k in q_cpu)
    out = ServeEngine(cfg, q_card, 32).generate(np.zeros((2, 4), np.int32), 3)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 3)


# -- the language model's training half (plain PyTorch on the card) ---------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-370m",
                                  "qwen2.5-3b", "recurrentgemma-2b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two steps (the schedule's lr 0, then its peak) of a reduced arch
    in float32 with TF32 off, on the card and on the CPU from one
    parameter tree: the metrics, the params and the optimizer state
    within 1e-4 (`train_card_vs_cpu`, which `chip_smoke.py` runs on every
    arch)."""
    from torch_differential import train_card_vs_cpu

    rep = train_card_vs_cpu([arch], cuda)[arch]
    assert rep["ok"], rep


def test_train_loop_crash_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    """`TrainLoop` on the card (its default device): a run crashed at
    step 13 resumes from step 10 and ends equal, leaf for leaf, to the
    uninterrupted run."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import SimulatedFailure, TrainLoop
    from repro_torch.nn import flatten_tree
    from repro_torch.training import OptHParams, TrainHParams

    def mk(path):
        cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=128,
                                               d_model=64, d_ff=128)
        hp = TrainHParams(opt=OptHParams(learning_rate=3e-3, warmup_steps=5,
                                         total_steps=40))
        return TrainLoop(cfg, hp, TokenPipeline(DataConfig(128, 8, 32,
                                                           seed=1)),
                         str(path), ckpt_every=5)

    a = mk(tmp_path / "a")
    assert a.device.type == "cuda"
    a.run(20)
    b = mk(tmp_path / "b")
    with pytest.raises(SimulatedFailure):
        b.run(20, fail_at=13)
    b2 = mk(tmp_path / "b")
    assert b2.step == 10
    b2.run(20)
    pa, pb = flatten_tree(a.state), flatten_tree(b2.state)
    assert all(t.device.type == "cuda" for t in pb.values())
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


# -- the language model on a mesh of the card's slots ------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_mesh_of_card_slots_matches_a_mesh_of_cpu_slots(cuda, arch):
    """Two train steps and greedy decoding in both decode cases of a
    reduced arch on a (2, 4) mesh of the card's slots against the same on
    a mesh of CPU slots, float32 with TF32 off: metrics, params,
    optimizer state and logits within 1e-4 of their scale, tokens equal
    (the params under `train_tree_gap`'s limits for Adam's amplified
    rounding; `mesh_vs`; `chip_smoke.py` holds the card's mesh against
    the card unsharded)."""
    from torch_differential import mesh_vs

    rep = mesh_vs(arch, [cuda] * 8, ["cpu"] * 8)
    assert rep["ok"], str(rep)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b",
                                  "mamba2-370m"])
def test_dry_run_equals_a_real_step_on_card_slots(cuda, arch):
    """The port's dry run of a reduced arch's (2, 4) train cell on
    ``meta`` slots against one real step on ``cuda:0`` slots: its FLOPs
    equal `FlopCounterMode`'s count of the step, its all-gather and
    reduce-scatter bytes the step's `TRAFFIC`."""
    from torch_differential import dryrun_vs_step

    rep = dryrun_vs_step(arch, [cuda] * 8)
    raw = rep["dry"]["collective_raw_total"]
    assert rep["dry"]["op_flops_total"] == rep["flops"] > 0
    assert raw["all-gather"]["result_bytes"] == \
        rep["traffic"]["gather_bytes"] > 0
    assert raw["reduce-scatter"]["operand_bytes"] == \
        rep["traffic"]["reduce_scatter_bytes"] > 0
    assert raw["all-reduce"] == rep["collectives"]["all-reduce"]
