"""The port's examples and its ``--fir-bank`` launcher run end to end on
the CPU (``--device cpu``) and end with their bit-exact line; what they
print of the paper's counts, and the launcher's plan, equal what the
reference prints on the same inputs.  Without ``--device`` and without
a card they refuse instead of running on the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def _module(name, *args, drop_xla_flags=False):
    env = dict(os.environ)
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


@pytest.mark.parametrize("script", ["port_quickstart.py",
                                    "port_fir_filtering.py"])
def test_port_examples_default_to_the_gpu(script):
    res = _run(script, "--n-div", "4") if "fir" in script else _run(script)
    if res.returncode == 0:  # a card is present: it ran there
        assert "bit-exact  OK" in res.stdout
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


def test_fir_bank_launcher_refuses_what_is_not_ported():
    for extra, item in ((("--sessions", "4"), "item 6"),
                        (("--arch", "qwen2.5-3b"), "item 8")):
        res = _module("repro_torch.launch.serve", *SERVE_ARGS, *extra,
                      "--device", "cpu")
        assert res.returncode == 2 and item in res.stderr
    res = _module("repro_torch.launch.serve", "--device", "cpu")
    assert res.returncode == 2 and "--fir-bank" in res.stderr
