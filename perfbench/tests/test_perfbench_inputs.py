"""The benchmark's frozen inputs, work counts and reference against the
port's own design, counts and oracle (CPU)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _cells  # noqa: F401  (puts the repository's root on sys.path)
from perfbench.design import design_bank
from perfbench.harness import load_cell
from perfbench.reference import control_block, fir_at, unravel
from perfbench.work import call_work, eq3_additions, naf_weight
from repro_torch.core import po2_quantize_batch
from repro_torch.core.costmodel import fir_blmac_additions_batch
from repro_torch.core.csd import num_pulses
from repro_torch.filters import fir_bit_layers_batch, sweep_bank


@pytest.fixture(scope="module")
def sweep_q():
    q, _ = po2_quantize_batch(sweep_bank(127), 16)
    return q


@pytest.fixture(scope="module")
def frozen():
    return {name: design_bank(load_cell(name).config["design"])
            for name in _cells.CELLS}


def test_sweep_bank_equals_the_port_bit_for_bit(sweep_q, frozen):
    q = frozen["sweep127.block48"]
    assert q.shape == (9900, 127) and q.dtype == np.int64
    assert np.array_equal(q, sweep_q)


def test_fir127_is_row_4950_of_the_sweep(sweep_q, frozen):
    assert np.array_equal(frozen["fir127.array64"], sweep_q[4950:4951])


def test_eq3_additions(sweep_q, frozen):
    adds = eq3_additions(frozen["sweep127.block48"])
    assert round(float(adds.mean()), 2) == 278.97
    assert np.array_equal(adds, fir_blmac_additions_batch(sweep_q))
    assert eq3_additions(frozen["fir127.array64"]).tolist() == [326]


@pytest.mark.parametrize("lo", [-(1 << 16), -40000, 0, 1 << 15])
def test_naf_weight_equals_the_ports_pulse_count(lo):
    v = np.arange(lo, lo + 25000, dtype=np.int64)
    assert np.array_equal(naf_weight(v), num_pulses(np.abs(v)))


def test_call_work_counts():
    q = np.zeros((3, 7), np.int64)
    q[:, 3] = [1, 3, 5]  # NAF weights 1, 2, 2
    w = call_work(q, channels=2, samples=10, coeff_bits=16)
    assert w["n_out"] == 4 and w["outputs"] == 3 * 2 * 4
    assert w["ops"] == (3 * 3 + 1 + 2 + 2) * 2 * 4
    assert w["bytes"] == 4 * 2 * 10 + 4 * 24 + 3 * 7 * 2


@pytest.mark.parametrize("name", _cells.CELLS)
def test_reference_equals_the_ports_oracle(name, frozen):
    q = frozen[name][:40]
    rng = np.random.default_rng(7)
    x = rng.integers(-128, 128, (3, 300)).astype(np.int32)
    want = fir_bit_layers_batch(x, q)  # (B, C, n_out)
    flat = torch.arange(want.size)
    b, c, t = unravel(flat, want.shape)
    got = fir_at(torch.as_tensor(x), torch.as_tensor(q), b, c, t, rows=997)
    assert np.array_equal(got.numpy().reshape(want.shape), want)


def test_control_block_is_float32():
    q = np.zeros((2, 5), np.int64)
    q[:, 2] = [1, 3]
    q[1, [0, 4]] = 2
    x = torch.tensor([[1, 2, 3, 4, 5, 6], [-7, 8, -9, 10, -11, 12]],
                     dtype=torch.int32)
    y = control_block(x, torch.as_tensor(q))
    want = fir_bit_layers_batch(x.numpy(), q)
    assert y.dtype == torch.int32 and np.array_equal(y.numpy(), want)
    big = torch.full((1, 5), (1 << 24) + 1, dtype=torch.int32)
    one = torch.as_tensor(np.ones((1, 1), np.int64))
    assert int(control_block(big, one)[0, 0, 0]) != (1 << 24) + 1
