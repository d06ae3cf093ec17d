"""The port stands alone: no JAX, no `repro`, and no quiet CPU runs.

A fresh interpreter imports `repro_torch`, runs an engine, the CSE pass
with auto and packed engines on its program (the dispatch planner, the
cost model, the fold), `lower()` on every backend, both machines
and `machine_cycles`, the pulse-code quantizer, matmul and
`quantize_param_tree`, the sharded engine behind `AsyncBankServer` with
a shard killed, and the ``--fir-bank`` launcher on the CPU and must end
with
neither `jax` nor any `repro` module loaded; no source file
of the port (nor `chip_smoke.py`, nor the port's examples) may import
them; and an entry point
called without ``device`` on a host without CUDA raises instead of
running on the CPU.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from _subproc import run_py

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_and_engine_leave_jax_and_repro_unloaded():
    out = run_py(
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.compiler import compile_bank, cache_stats\n"
        "from repro_torch.filters import (FilterBankEngine,\n"
        "    fir_bit_layers_batch, spread_lowpass_qbank)\n"
        "from repro_torch.kernels import blmac_fir, blmac_fir_bank\n"
        "q = spread_lowpass_qbank(8, 31)\n"
        "x = np.random.default_rng(0).integers(-128, 128, (2, 700))\n"
        "eng = FilterBankEngine(q, channels=2, device='cpu')\n"
        "y = eng.push(x)\n"
        "assert np.array_equal(y, fir_bit_layers_batch(x, q))\n"
        "blmac_fir(x[0], q[0], device='cpu')\n"
        "import repro_torch.compiler.optimize, repro_torch.kernels.runtime\n"
        "import repro_torch.core.costmodel\n"
        "from repro_torch.compiler import cse_pass\n"
        "opt = cse_pass(compile_bank(q))\n"
        "auto = FilterBankEngine(opt, channels=2, mode='auto', device='cpu')\n"
        "assert auto.dispatch_plan.cse in ('optimized', 'declined')\n"
        "assert np.array_equal(auto.push(x), fir_bit_layers_batch(x, q))\n"
        "packed = FilterBankEngine(opt, channels=2, mode='packed',\n"
        "                          device='cpu')\n"
        "assert np.array_equal(packed.push(x), fir_bit_layers_batch(x, q))\n"
        "cache_stats()\n"
        "from repro_torch.compiler import BACKENDS, lower\n"
        "from repro_torch.core import (FirBlmacMachine, FirBlmacVMachine,\n"
        "    MachineSpec, machine_cycles_batch)\n"
        "prog = compile_bank(q)\n"
        "want = fir_bit_layers_batch(x, q)\n"
        "for b in BACKENDS:\n"
        "    for p in (prog, opt):\n"
        "        y = lower(p, b, device='cpu', channels=2)(x)\n"
        "        assert np.array_equal(y, want)\n"
        "from repro_torch.distributed import FaultInjector, bank_mesh\n"
        "from repro_torch.filters import ShardedFilterBankEngine\n"
        "from repro_torch.serving import AsyncBankServer\n"
        "inj = FaultInjector().kill_shard(1, at_chunk=1)\n"
        "seng = ShardedFilterBankEngine(q, channels=2, n_bank_shards=4,\n"
        "    mesh=bank_mesh(4, 2, devices=['cpu'] * 8), fault_injector=inj)\n"
        "srv = AsyncBankServer(seng)\n"
        "got = srv.submit(x[:, :350]) + srv.submit(x[:, 350:]) + srv.drain()\n"
        "assert np.array_equal(np.concatenate(got, axis=2), want)\n"
        "assert seng.fault_stats()['recoveries'] == 1\n"
        "from repro_torch.launch.serve import main\n"
        "main(['--fir-bank', '4', '--taps', '15', '--chunk', '256',\n"
        "      '--chunks', '2', '--device', 'cpu'])\n"
        "spec = MachineSpec(taps=31)\n"
        "vm = FirBlmacVMachine(spec)\n"
        "fits = vm.program_bank(q)\n"
        "assert np.array_equal(vm.run(x[0]).outputs, want[:, 0])\n"
        "assert np.array_equal(prog.machine_cycles(spec),\n"
        "                      machine_cycles_batch(q))\n"
        "opt.machine_cycles(), opt.shared_cycles()\n"
        "m = FirBlmacMachine(spec)\n"
        "m.program(q[0])\n"
        "assert np.array_equal(m.run(x[0]).outputs, want[0, 0])\n"
        "from repro_torch.kernels.blmac_matmul import pulse_quantize\n"
        "from repro_torch.core.serve_quant import quantize_param_tree\n"
        "from repro_torch.kernels import pulse_matmul_op\n"
        "w = np.random.default_rng(1).standard_normal((64, 32))\n"
        "codes, ge = pulse_quantize(w, 2, device='cpu')\n"
        "pulse_matmul_op(np.ones((2, 64), np.float32), codes, ge, 2,\n"
        "                device='cpu')\n"
        "quantize_param_tree({'w': codes[0].double()}, 2, min_size=1,\n"
        "                    device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n",
        devices=1, timeout=300,
    )
    assert "LOADED []" in out


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
    re.MULTILINE,
)


def test_no_port_source_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("port_*.py"))
    assert len(examples) >= 2
    files += examples
    assert len(files) > 10
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders


def test_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.filters import FilterBankEngine
    from repro_torch.kernels import blmac_fir_bank, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.zeros((2, 15), np.int64)
    q[:, 7] = [3, 5]
    x = np.arange(100)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: blmac_fir_bank(x, q),
                 lambda: FilterBankEngine(q)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("entry", ["pulse_matmul_op", "pulse_quantize",
                                   "quantize_param_tree"])
def test_pulse_entry_points_default_to_the_gpu(monkeypatch, entry):
    from repro_torch.core.serve_quant import quantize_param_tree
    from repro_torch.kernels import pulse_matmul_op, pulse_quantize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.ones((32, 4))
    codes = np.full((1, 32, 4), 15, np.uint8)
    calls = {
        "pulse_matmul_op": lambda: pulse_matmul_op(
            np.ones((2, 32), np.float32), codes, np.zeros((1, 4), np.int8), 1),
        "pulse_quantize": lambda: pulse_quantize(w, 2),
        "quantize_param_tree": lambda: quantize_param_tree(
            {"w": torch.ones((32, 128))}, 2),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_sharded_entry_points_default_to_the_gpu(monkeypatch):
    """`bank_mesh()`, the sharded engine, `lower(..., "sharded")` and the
    launcher take the card unless asked for the CPU, and raise without
    one."""
    from repro_torch.compiler import compile_bank, lower
    from repro_torch.distributed import bank_mesh
    from repro_torch.filters import ShardedFilterBankEngine
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.zeros((2, 15), np.int64)
    q[:, 7] = [3, 5]
    for call in (lambda: bank_mesh(), lambda: ShardedFilterBankEngine(q),
                 lambda: lower(compile_bank(q), "sharded"),
                 lambda: bank_mesh(1, 1, devices=["cuda"]),
                 lambda: main(["--fir-bank", "2", "--taps", "15",
                               "--chunk", "64", "--chunks", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert bank_mesh(1, 1, devices=["cpu"]).devices[0][0].type == "cpu"
