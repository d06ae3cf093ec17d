"""Helpers shared by the benchmark's CPU tests: the repository's root on
``sys.path`` and the cells cut to a size a CPU test run can hold."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import load_cell  # noqa: E402

CELLS = ("sweep127.block48", "fir127.array64")


def small_cell(name: str, channels: int = 2, samples: int = 600,
               bench_dir=None):
    """Cell ``name`` at a CPU test's size: a few channels and samples; a
    bank of many filters cut to the 90 filters of the 31-tap sweep at
    N = 10."""
    cell = load_cell(name) if bench_dir is None else load_cell(name,
                                                                bench_dir)
    design = cell.config["design"]
    if design.get("rows") is None:
        design.update(taps=31, n_div=10)
    cell.traffic.update(channels=channels, samples=samples)
    cell.workload.update(check_samples=512, trace_skip=2, trace_calls=3)
    return cell
