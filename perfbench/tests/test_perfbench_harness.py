"""The harness is driven by data: `BENCHMARK.json` against the
benchmark's files, the contract's names and units, and a cell added as
new files alone (CPU)."""
from __future__ import annotations

import json
import re
import shutil
import time

import pytest

import _cells
from perfbench.harness import NAME_RE, load_cell, run_cell

ROOT = _cells.ROOT
BENCH = ROOT / "perfbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_names_and_units():
    names = ([m["name"] for m in METRICS]
             + [w["name"] for w in SPEC["workloads"]]
             + [c["name"] for c in SPEC["configs"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME_RE.fullmatch(n) for n in names), names
    assert all(UNIT_RE.fullmatch(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        group_names = [x["name"] for x in SPEC[group]]
        assert len(group_names) == len(set(group_names))


def test_files_under_paths_use_name_characters():
    for p in BENCH.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("perfbench/out"):
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree_with_the_benchmark(cell):
    loaded = load_cell(cell["name"])
    wl = loaded.workload
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == cell[key], key
    assert (BENCH / "entries" / f"{wl['entry']}.py").is_file()
    config = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert (ROOT / config["file"]).is_file()
    assert loaded.config["reduced"] == config["reduced"]
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded.per_layer
    for m in loaded.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


def test_every_metric_and_config_is_used():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells
    assert {c["name"] for c in SPEC["configs"]} == {
        w["config"] for w in SPEC["workloads"]}


def test_a_cell_added_as_new_files_is_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    new = tmp_path / "perfbench"
    (new / "traffic" / "array2.json").write_text(json.dumps(
        {"channels": 2, "samples": 700, "pool": 3, "depth": 2}))
    (new / "workloads" / "fir127.array2.json").write_text(json.dumps(
        {"config": "fir127", "traffic": "array2", "entry": "blmac_fir_bank",
         "chips": 1, "check_samples": 256, "trace_skip": 2,
         "trace_calls": 3, "why": "a test's cell"}))
    (new / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return rec.calls\n")
    spec["workloads"].append({"name": "fir127.array2", "config": "fir127",
                              "traffic": "array2", "chips": 1,
                              "why": "a test's cell"})
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "setup_s",
                              "workloads": ["fir127.array2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("fir127.array2", new)
    assert cell.traffic["samples"] == 700
    assert [m["name"] for m in cell.per_layer][-1] == "calls_in_window"
    result = run_cell(cell, 11, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"filter_samples_per_s",
                                      "latency_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and "out" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "fir127.array64", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
