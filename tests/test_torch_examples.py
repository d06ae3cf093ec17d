"""The port's examples run end to end on the CPU (``--device cpu``) and
end with their bit-exact line; what they print of the paper's counts
equals what the reference's examples print on the same inputs.  Without
``--device`` and without a card they refuse instead of running on the
CPU."""
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
