"""Drives whole runs of each cell on the CPU, past the harness's look for
a card, and sees the judge pass the program and fail the control and each
fault the cell can have, planted under the timed path."""
from __future__ import annotations

import time

import pytest
import torch

import _cells
from perfbench.harness import WARM_CALLS, run_cell
from perfbench.reference import control_block


def stale(entry):
    """A call that returns the previous call's outputs again."""
    last = []

    def call(x):
        y = entry(x)
        out = last[0] if last else y
        last[:] = [y]
        return out
    return call


def half_batch(entry):
    """Half of the channels left out (their outputs zero)."""
    def call(x):
        y = entry(x).clone()
        y[:, y.shape[1] // 2:] = 0
        return y
    return call


def one_answer(entry):
    """One call's outputs altered where they are produced: the window's
    second block."""
    n = [0]

    def call(x):
        y = entry(x)
        n[0] += 1
        return y + 1 if n[0] == WARM_CALLS + 2 else y
    return call


def run(name, wrap=None, trace=False, seconds=0.6, seed=2**31 + 77):
    cell = _cells.small_cell(name)
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    entry_wrap=wrap)


@pytest.mark.parametrize("name", _cells.CELLS)
def test_program_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["mismatches"]["value"] == 0


@pytest.mark.parametrize("fault", [stale, half_batch, one_answer])
@pytest.mark.parametrize("name", _cells.CELLS)
def test_fault_is_caught(name, fault):
    r = run(name, fault)
    assert r["attempted"] >= 2
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("name", _cells.CELLS)
def test_control_is_caught(name):
    # the reference in float32 over 127-tap filters of the configuration
    # (every 99th of the sweep's): 8-bit samples take some partial sums
    # past 2**24
    cell = _cells.small_cell(name, channels=4, samples=1 << 14)
    design = cell.config["design"]
    if design["rows"] is None:
        design.update(taps=127, n_div=100, rows=list(range(0, 9900, 99)))
    cell.workload["check_samples"] = 4096
    from perfbench.design import design_bank

    q = torch.as_tensor(design_bank(cell.config["design"]))
    r = run_cell(cell, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(),
                 entry_wrap=lambda entry: lambda x: control_block(x, q))
    assert not r["correct"]
    assert r["checks"]["max_abs_diff"]["value"] > 0


def test_traced_run_reads_its_spans():
    r = run("fir127.array64", trace=True, seconds=0.05)
    assert r["correct"]
    assert set(r["metrics"]) == {"entry_host_ms", "launches_per_call"}
    assert r["device"]["window_s"] > 0
    assert r["breakdown"]["idle_gaps"]
