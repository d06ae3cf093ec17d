"""The port's examples and its ``--fir-bank`` and ``--sessions``
launchers run end to end on the CPU (``--device cpu``) and end with
their bit-exact line; what they print of the paper's counts, the
launcher's plan and the session server's schedule equal what the
reference prints on the same inputs; the language-model example ends
with its greedy-token agreement.  Without ``--device`` and without a
card they refuse instead of running on the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


# a training subprocess on one thread: beside the other test workers, a
# pool of spinning OpenMP threads a process slows it by tens of times
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _run(script, *args, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def _module(name, *args, drop_xla_flags=False, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    if drop_xla_flags:  # the reference's mesh: this host's one CPU device
        env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", name, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def _lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.strip()]


def test_port_quickstart_on_the_cpu_matches_the_reference():
    port = _run("port_quickstart.py", "--device", "cpu")
    assert port.returncode == 0, port.stderr
    lines = _lines(port.stdout)
    assert lines[-1] == ("classical == machine == the port's kernel, "
                         "bit-exact  OK")
    ref = _run("quickstart.py")
    assert ref.returncode == 0, ref.stderr
    # design, quantization, §3.3 adds and §4 cycles: the same lines
    assert lines[:3] == _lines(ref.stdout)[:3]


@pytest.mark.parametrize("n_div", [6, 10])
def test_port_fir_filtering_on_the_cpu_matches_the_reference(n_div):
    port = _run("port_fir_filtering.py", "--device", "cpu", "--n-div",
                str(n_div))
    assert port.returncode == 0, port.stderr
    lines = _lines(port.stdout)
    assert lines[-1].startswith("vmachine == bank kernel == specialized "
                                "kernel on ")
    assert lines[-1].endswith("bit-exact  OK")
    ref = _lines(_run("fir_filtering.py", "--n-div", str(n_div)).stdout)
    assert lines[:3] == ref[:3]  # the §3.3 add counts at 55, 127, 255 taps
    assert lines[4:7] == ref[4:7]  # the Tab. 4 throughput model
    # the §4 line: the reference's figures, plus the fused-add mean
    mean = ref[3].split("mean ")[1].split(" ")[0]
    share = ref[3].split("; ")[1]
    assert f"mean {mean} cycles/output" in lines[3]
    assert lines[3].endswith(share)


def test_port_session_recovery_on_the_cpu():
    """A SIGKILLed serving child, recovered in the example's process from
    its journal: every tenant bit-exact, no duplicates, no gaps."""
    res = _run("port_session_recovery.py", "--device", "cpu",
               "--sessions", "6")
    assert res.returncode == 0, res.stderr
    lines = _lines(res.stdout)
    assert "victim exited with -9 (SIGKILL)" in lines[1]
    assert lines[2].startswith("recovered 6 sessions on cpu")
    assert lines[-1] == ("all 6 tenants bit-exact across the crash (1024 "
                         "post-crash samples each) — no duplicates, no "
                         "gaps  OK")


@pytest.mark.parametrize("script", ["port_quickstart.py",
                                    "port_fir_filtering.py",
                                    "port_session_recovery.py",
                                    "port_serve_lm.py",
                                    "port_train_lm.py"])
def test_port_examples_default_to_the_gpu(script, tmp_path):
    if "fir" in script:
        res = _run(script, "--n-div", "4")
    elif "train" in script:
        res = _run(script, "--steps", "2", "--ckpt-dir", str(tmp_path),
                   env_extra=ONE_THREAD)
    else:
        res = _run(script)
    if res.returncode == 0:  # a card is present: it ran there
        assert ("greedy-token agreement" if "serve_lm" in script
                else "stragglers flagged" if "train_lm" in script
                else "no duplicates, no gaps  OK" if "session" in script
                else "bit-exact  OK") in res.stdout
        return
    assert "no CUDA device" in res.stderr


SERVE_ARGS = ("--fir-bank", "16", "--taps", "31", "--chunk", "512",
              "--chunks", "4")


def test_fir_bank_launcher_on_the_cpu_matches_the_reference(tmp_path):
    """The port's launcher ends bit-exact against the oracle, plans what
    the reference's launcher plans on its one-device mesh, and warm-starts
    from a program file the reference saved."""
    path = str(tmp_path / "bank.npz")
    ref = _module("repro.launch.serve", *SERVE_ARGS, "--program-path", path,
                  drop_xla_flags=True)
    assert ref.returncode == 0, ref.stderr
    port = _module("repro_torch.launch.serve", *SERVE_ARGS, "--device", "cpu",
                   "--program-path", path)
    assert port.returncode == 0, port.stderr
    lines = _lines(port.stdout)
    assert lines[-1] == "[serve] tail chunk bit-exact vs numpy oracle"
    assert lines[0].startswith("[serve] warm-start: loaded compiled program")
    describe = [ln for ln in lines if "sharded-bank" in ln]
    assert describe == [ln for ln in _lines(ref.stdout) if "sharded-bank" in ln]
    assert "B=16 C=1 mesh=(1x1)" in describe[0]


SESSION_ARGS = ("--fir-bank", "16", "--taps", "31", "--sessions", "8",
                "--slots", "4", "--chunk", "512", "--chunks", "6")


def test_sessions_launcher_on_the_cpu_matches_the_reference():
    """``--sessions`` serves the reference's schedule (a filter swap, a
    pause and resume) to the same rounds and occupancy, and ends with
    tenant 0 bit-exact against the oracle."""
    ref = _module("repro.launch.serve", *SESSION_ARGS, drop_xla_flags=True)
    assert ref.returncode == 0, ref.stderr
    port = _module("repro_torch.launch.serve", *SESSION_ARGS,
                   "--device", "cpu")
    assert port.returncode == 0, port.stderr
    lines, rlines = _lines(port.stdout), _lines(ref.stdout)
    assert lines[-1] == rlines[-1] == ("[serve] session 0 bit-exact vs numpy "
                                       "oracle (3042 samples × 2 filters)")
    assert lines[0] == rlines[0]  # tenants, filters, lanes
    # output samples, occupancy and rounds (not the host's seconds)
    assert lines[1].split(" in ")[0] == rlines[1].split(" in ")[0]
    assert lines[1].split("), ")[1].split(", p50")[0] \
        == rlines[1].split("), ")[1].split(", p50")[0]


def test_sessions_launcher_with_shards_and_journal(tmp_path):
    """``--bank-shards`` on the launcher's one-slot mesh clamps to one
    shard (as the reference does on one device); ``--journal-path``
    writes a journal `recover` can read."""
    wal = tmp_path / "wal"
    res = _module("repro_torch.launch.serve", *SESSION_ARGS,
                  "--bank-shards", "2", "--journal-path", str(wal),
                  "--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = _lines(res.stdout)
    assert lines[0].startswith("[serve] sessions × shards: sharded-bank "
                               "B=16 C=4 mesh=(1x1)")
    assert lines[-2].startswith("[serve] session 0 bit-exact")
    assert lines[-1].startswith("[serve] journal: ")
    from repro_torch.serving import SessionJournal

    header, records = SessionJournal.replay(wal)
    assert header["n_filters"] == 16
    assert sorted({r["sid"] for r in records if r["t"] == "open"}) \
        == [f"s{i}" for i in range(8)]


def test_fir_bank_launcher_refuses_what_is_not_ported():
    """``--fir-bank`` wins over ``--arch`` (the reference's precedence:
    the bank is served, no model); with neither, the launcher exits 2."""
    res = _module("repro_torch.launch.serve", *SERVE_ARGS, "--arch",
                  "qwen2.5-3b", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = _lines(res.stdout)
    assert lines[-1] == "[serve] tail chunk bit-exact vs numpy oracle"
    assert not any("qwen" in ln for ln in lines)
    res = _module("repro_torch.launch.serve", "--device", "cpu")
    assert res.returncode == 2 and "--fir-bank" in res.stderr
    assert "--arch is required" in res.stderr


def test_port_serve_lm_on_the_cpu():
    res = _run("port_serve_lm.py", "--device", "cpu", "--new-tokens", "6")
    assert res.returncode == 0, res.stderr
    lines = _lines(res.stdout)
    assert lines[0].startswith("bf16 baseline: ")
    assert lines[3].startswith("CSD-4: 5 matrices quantized, mean rel err ")
    assert lines[3].endswith(" bits/weight stored (24.2 achievable) vs "
                             "16 bf16")
    assert lines[-1].startswith("greedy-token agreement vs bf16: ")
    assert float(lines[-1].split(": ")[1].rstrip("%")) > 70.0


def test_port_train_lm_on_the_cpu(tmp_path):
    """The 10m model learns the markov map's first steps on the host and
    leaves its checkpoints where it was told."""
    res = _run("port_train_lm.py", "--device", "cpu", "--steps", "30",
               "--seq", "32", "--ckpt-dir", str(tmp_path),
               env_extra=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    lines = _lines(res.stdout)
    from repro.configs import get_config
    from repro.nn import count_params, model_decls

    ref = get_config("qwen2.5-3b").reduced(
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=768, vocab_size=4096)  # the examples' "10m" size
    assert lines[0] == f"model: {count_params(model_decls(ref))/1e6:.1f}M " \
                       f"params"
    # the straggler watchdog may print a line between them
    summary = [ln for ln in lines if ln.startswith("step 0: loss ")]
    assert len(summary) == 1 and "  ->  step 29: loss " in summary[0]
    first, last = (float(x.split("loss ")[1]) for x in
                   summary[0].split("  ->  "))
    assert last < first
    assert lines[-1].startswith(f"checkpoints in {tmp_path}; stragglers "
                                f"flagged: ")
    from repro_torch.checkpoint import all_steps

    assert all_steps(str(tmp_path)) == [25, 30]


def test_train_launcher_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: the
    reference's summary line, the loss falling, keep-k checkpoints; run
    again on its directory, it resumes there and has nothing left."""
    args = ("--arch", "qwen2.5-3b", "--steps", "12", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--ckpt-every", "5",
            "--ckpt-dir", str(tmp_path), "--device", "cpu")
    res = _module("repro_torch.launch.train", *args, env_extra=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    last = _lines(res.stdout)[-1]
    assert last.startswith("[train] qwen2.5-3b: step 0 loss ")
    assert " -> step 11 loss " in last and "; stragglers=" in last
    l0 = float(last.split("step 0 loss ")[1].split(" ")[0])
    l11 = float(last.split("step 11 loss ")[1].split(";")[0])
    assert l11 < l0
    from repro_torch.checkpoint import all_steps

    assert all_steps(str(tmp_path)) == [5, 10, 12]
    again = _module("repro_torch.launch.train", *args, env_extra=ONE_THREAD)
    assert again.returncode == 0, again.stderr
    assert _lines(again.stdout) == [
        "[fault] resumed from checkpoint at step 12",
        f"[train] qwen2.5-3b: already at step 12 in {tmp_path}; nothing to "
        f"run"]
