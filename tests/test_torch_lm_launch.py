"""The ``--arch`` launcher of the port against `repro`'s.

``python -m repro_torch.launch.serve --arch qwen2.5-3b --device cpu``
(reduced) runs and prints what ``python -m repro.launch.serve --arch
qwen2.5-3b`` prints — the lines, the token shape, with
``--quant-planes 4`` the count of quantized matrices and the storage
(the weights come from each package's own seeded generator, so the
token ids and the error differ) — and ``--no-reduced`` reaches the
published widths (checked on the declarations, without allocating
them).
"""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _launch(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return [ln for ln in res.stdout.splitlines() if ln.strip()]


@pytest.mark.parametrize("quant", [[], ["--quant-planes", "4"]])
def test_launcher_prints_what_the_reference_prints(quant):
    port = _launch("repro_torch.launch.serve", "--arch", "qwen2.5-3b",
                   "--device", "cpu", *quant)
    ref = _launch("repro.launch.serve", "--arch", "qwen2.5-3b", *quant)
    assert len(port) == len(ref) == 3 + bool(quant)
    if quant:
        # the same leaves of the same shapes: the count and the storage
        # (the weights come from each package's own seeded generator)
        assert port[0].split(", mean")[0] == ref[0].split(", mean")[0] \
            == "[serve] CSD-4 quantized 5 matrices"
        assert port[0].endswith("stored bits/weight 32.2")
        assert ref[0].endswith("stored bits/weight 32.2")
    head = "[serve] qwen2.5-3b: generated (4, 16) in "
    assert port[-3].startswith(head) and ref[-3].startswith(head)
    assert port[-3].endswith(" tok/s)")
    for lines in (port, ref):  # two rows of 16 token ids, as numpy prints
        rows = " ".join(lines[-2:]).replace("[", " ").replace("]", " ")
        assert len(rows.split()) == 32


def test_no_reduced_reaches_the_published_config(monkeypatch):
    import repro_torch.nn as tnn
    from repro_torch.launch.serve import parser, serve_lm
    from repro_torch.nn import count_params

    assert parser().parse_args(["--arch", "x"]).reduced is True
    args = parser().parse_args(["--arch", "qwen2.5-3b", "--no-reduced",
                                "--device", "cpu"])
    assert args.reduced is False

    class Drawn(Exception):
        pass

    def fake_init(decls, generator, device=None):
        raise Drawn(decls)

    monkeypatch.setattr(tnn, "init_params", fake_init)
    with pytest.raises(Drawn) as exc:
        serve_lm(args)
    decls = exc.value.args[0]
    assert count_params(decls) == 3_085_938_688
    assert decls["stage0"]["slot0"]["ffn"]["gate"].shape == (36, 2048, 11008)
    assert decls["embed"]["table"].shape == (151_936, 2048)
    assert "lm_head" not in decls  # tied
    # the reference's declarations, counted the same way
    from repro.configs import get_config as rget
    from repro.nn import count_params as r_count
    from repro.nn import model_decls as r_decls

    assert r_count(r_decls(rget("qwen2.5-3b"))) == 3_085_938_688
