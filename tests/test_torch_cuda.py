"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built at first use);
elsewhere every test skips with a reason.  Run on the machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 throughout: every path is integer arithmetic modulo 2**32.
This file imports only the port (the card's machine has no JAX); the
banks come from the port's own generators and a seeded numpy draw.
"""
import numpy as np
import pytest
import torch

from repro_torch.compiler import compile_bank
from repro_torch.core import po2_quantize_batch
from repro_torch.filters import (FilterBankEngine, fir_bit_layers_batch,
                                 spread_lowpass_qbank, sweep_bank)
from repro_torch.kernels import blmac_fir, blmac_fir_bank
from repro_torch.kernels.blmac_fir import (bank_call, bank_call_plain,
                                           bank_schedule_apply,
                                           frame_signal, frame_signal_batch,
                                           pulses_from_packed,
                                           reset_launch_counts,
                                           specialized_call,
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
            got = bank_call(frames, op_cpu.to(cuda), *args)
            torch.cuda.synchronize()
            assert torch.equal(plain.cpu(), want)
            assert torch.equal(got.cpu(), want), (bank, merge, tile)


def test_bank_schedule_apply_skips_all_zero_groups(cuda):
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
    assert bank_call.launches == sum(bool(g.sel_layers) for g in sched.groups)
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


@pytest.mark.parametrize("taps,tile", [(7, 128), (63, 512), (127, 1024),
                                       (255, 512)])
def test_specialized_kernel_matches_plain(cuda, taps, tile):
    q = _random_bank(5, taps, taps, density=0.5)
    q[0] = 0  # an empty pulse list still launches and writes zeros
    prog = compile_bank(q)
    x = torch.as_tensor(np.random.default_rng(taps).integers(-128, 128, 3000),
                        dtype=torch.int32)
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
        assert torch.equal(got.cpu(), want), b


def test_entry_points_on_the_card(cuda):
    q = _sweep_rows(63, 12, seed=7)
    x = np.random.default_rng(8).integers(-128, 128, (2, 5000))
    reset_launch_counts()
    y = blmac_fir_bank(x, q)
    assert y.device.type == "cuda" and bank_call.launches > 0
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
    with pytest.raises(ValueError):
        bank_call(frames.to(cuda), torch.tensor(g.packed.view(np.int32)),
                  15, g.schedule, g.tail_shift, 128)


def test_build_reports_kernel_resources(cuda):
    from repro_torch.kernels.build import build_all

    infos = build_all()
    res = {k: v for info in infos.values() for k, v in info.resources().items()}
    assert set(res) == {"blmac_bank_kernel", "blmac_specialized_kernel"}
    assert all(r["registers"] > 0 for r in res.values())
