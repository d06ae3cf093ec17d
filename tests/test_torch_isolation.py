"""The port stands alone: no JAX, no `repro`, and no quiet CPU runs.

A fresh interpreter imports `repro_torch`, runs an engine, the CSE pass
with auto and packed engines on its program (the dispatch planner, the
cost model, the fold), `lower()` on every backend, both machines
and `machine_cycles`, the pulse-code quantizer, matmul and
`quantize_param_tree`, the sharded engine behind `AsyncBankServer` with
a shard killed, the session server journaled and recovered, and the
``--fir-bank`` and ``--sessions`` launchers on the CPU, and another the
language-model stack (configs, `repro_torch.nn`, `ServeEngine`, the
quantized engine, ``--arch``), and a third the training half
(`repro_torch.training`, `.checkpoint`, `.data`, `.distributed.fault`,
the compressed all-reduce, ``launch.train``), and a fourth the language
model on a mesh of slots (the sharding rules, `.distributed.placement`,
``launch.mesh``, the mesh train step, `ServeEngine`, `TrainLoop` and
sharded checkpoints), and a fifth the dry run (``launch.dryrun``,
`roofline`); each must end with neither
`jax` nor any `repro` module loaded; no source file
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
        "main(['--fir-bank', '8', '--taps', '15', '--sessions', '4',\n"
        "      '--slots', '2', '--chunk', '64', '--chunks', '3',\n"
        "      '--device', 'cpu'])\n"
        "import tempfile\n"
        "from repro_torch.serving import BankSessionServer\n"
        "wal = tempfile.mkdtemp() + '/wal'\n"
        "ss = BankSessionServer(q, n_slots=2, device='cpu', journal=wal)\n"
        "t = ss.open_session([1, 3])\n"
        "t.push(x[0])\n"
        "del ss\n"
        "rs = BankSessionServer.recover(wal, compile_bank(q), device='cpu')\n"
        "assert np.array_equal(rs.sessions['s0'].pull(), want[[1, 3], 0])\n"
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


def test_language_model_stack_leaves_jax_and_repro_unloaded():
    """`repro_torch.configs`, `.nn` and the LM half of `.serving`: every
    arch's declarations, a reduced model's forward, loss and decode, the
    engine, the quantized engine and the ``--arch`` launcher."""
    out = run_py(
        "import sys\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import all_configs, get_config\n"
        "from repro_torch.nn import (LanguageModel, ShardCtx,\n"
        "    count_params, flatten_tree, init_params, loss_fn, model_decls)\n"
        "from repro_torch.serving import ServeEngine, abstract_caches\n"
        "from repro_torch.core.serve_quant import quantize_param_tree\n"
        "for name, cfg in all_configs().items():\n"
        "    assert count_params(model_decls(cfg)) > 0\n"
        "    abstract_caches(cfg, 2, 64)\n"
        "for arch in ('qwen2.5-3b', 'mamba2-370m', 'recurrentgemma-2b'):\n"
        "    cfg = get_config(arch).reduced(n_layers=3)\n"
        "    p = init_params(model_decls(cfg), torch.Generator(), 'cpu')\n"
        "    m = LanguageModel(cfg, p)\n"
        "    tok = torch.zeros((2, 8), dtype=torch.int32)\n"
        "    pos = torch.arange(8)[None].expand(2, 8)\n"
        "    loss_fn(m, {'tokens': tok, 'labels': tok}, cfg,\n"
        "            ShardCtx(positions=pos))\n"
        "    eng = ServeEngine(cfg, m, cache_len=16, device='cpu')\n"
        "    assert eng.generate(tok, 3).shape == (2, 3)\n"
        "    q, _ = quantize_param_tree(m.state_dict(), 4, device='cpu')\n"
        "    ServeEngine(cfg, q, cache_len=16, device='cpu').generate(tok, 2)\n"
        "from repro_torch.launch.serve import main\n"
        "main(['--arch', 'starcoder2-3b', '--new-tokens', '2',\n"
        "      '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n",
        devices=1, timeout=300,
    )
    assert "LOADED []" in out


def test_language_model_entry_points_default_to_the_gpu(monkeypatch):
    """`ServeEngine`, `init_params`, `params_from_arrays` and the
    ``--arch`` launcher take the card unless asked for the CPU, and
    raise without one."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.nn import (flatten_tree, init_params, model_decls,
                                params_from_arrays)
    from repro_torch.serving import ServeEngine

    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=64)
    params = init_params(model_decls(cfg), torch.Generator(), device="cpu")
    arrays = {k: v.numpy() for k, v in flatten_tree(params).items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ServeEngine(cfg, params),
                 lambda: ServeEngine(cfg, params, device="cuda"),
                 lambda: init_params(model_decls(cfg), torch.Generator()),
                 lambda: params_from_arrays(cfg, arrays),
                 lambda: main(["--arch", "qwen2.5-3b"]),
                 lambda: main(["--arch", "qwen2.5-3b", "--quant-planes",
                               "4"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    eng = ServeEngine(cfg, params, cache_len=16, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.generate(np.zeros((1, 4), np.int32), 2).device.type == "cpu"


def test_training_stack_leaves_jax_and_repro_unloaded():
    """The train step (AdamW and Adafactor), a checkpoint written and
    restored, the pipeline, `TrainLoop` with a crash and a resume, the
    compressed all-reduce and ``launch.train`` on the CPU."""
    out = run_py(
        "import sys, tempfile\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import DataConfig, TokenPipeline\n"
        "from repro_torch.training import (OptHParams, TrainHParams,\n"
        "    abstract_train_state, make_train_step, train_state_init)\n"
        "from repro_torch.checkpoint import (restore_checkpoint,\n"
        "    save_checkpoint)\n"
        "from repro_torch.distributed.fault import (SimulatedFailure,\n"
        "    TrainLoop)\n"
        "from repro_torch.distributed import (compressed_psum,\n"
        "    make_compressed_dp_grad_fn)\n"
        "from repro_torch.nn import init_params, model_decls\n"
        "pipe = TokenPipeline(DataConfig(64, 4, 16))\n"
        "for arch in ('qwen2.5-3b', 'deepseek-v3-671b'):\n"
        "    cfg = get_config(arch).reduced(n_layers=2, vocab_size=64)\n"
        "    p = init_params(model_decls(cfg), torch.Generator(), 'cpu')\n"
        "    st = train_state_init(p, cfg)\n"
        "    b = {k: torch.as_tensor(v) for k, v in\n"
        "         pipe.global_batch_at(0).items()}\n"
        "    st, m = make_train_step(cfg, TrainHParams())(st, b)\n"
        "    d = tempfile.mkdtemp()\n"
        "    save_checkpoint(d, 1, st)\n"
        "    restore_checkpoint(d, abstract_train_state(cfg,\n"
        "        model_decls(cfg)), device='cpu')\n"
        "cfg = get_config('qwen2.5-3b').reduced(n_layers=2, vocab_size=64)\n"
        "d = tempfile.mkdtemp()\n"
        "loop = TrainLoop(cfg, TrainHParams(), pipe, d, ckpt_every=2,\n"
        "                 device='cpu')\n"
        "try:\n"
        "    loop.run(4, fail_at=3)\n"
        "except SimulatedFailure:\n"
        "    pass\n"
        "assert TrainLoop(cfg, TrainHParams(), pipe, d,\n"
        "                 device='cpu').step == 2\n"
        "compressed_psum([torch.ones(3), torch.zeros(3)])\n"
        "make_compressed_dp_grad_fn(lambda w, x: (x @ w).sum(),\n"
        "    ['cpu', 'cpu'])(torch.ones(3), torch.ones(4, 3))\n"
        "from repro_torch.launch.train import main\n"
        "main(['--arch', 'mamba2-370m', '--steps', '2', '--batch', '2',\n"
        "      '--seq', '16', '--ckpt-dir', tempfile.mkdtemp(),\n"
        "      '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n",
        devices=1, timeout=300,
    )
    assert "LOADED []" in out


def test_mesh_modules_leave_jax_and_repro_unloaded():
    """The LM sharding rules, placement, ``launch.mesh``, a train step
    (AdamW and Adafactor), a `ServeEngine` in both decode cases, a
    `TrainLoop` and a sharded checkpoint re-meshed, on CPU slots."""
    out = run_py(
        "import sys, tempfile\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import DataConfig, TokenPipeline\n"
        "from repro_torch.distributed import (batch_shardings,\n"
        "    device_put, gather, make_mesh, make_rules,\n"
        "    sanitized_shardings)\n"
        "from repro_torch.distributed.fault import TrainLoop\n"
        "from repro_torch.checkpoint import (restore_checkpoint,\n"
        "    save_checkpoint)\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.nn import init_params, model_decls\n"
        "from repro_torch.serving import ServeEngine\n"
        "from repro_torch.training import (TrainHParams,\n"
        "    abstract_train_state, make_train_step, train_state_init,\n"
        "    train_state_pspecs)\n"
        "make_production_mesh(multi_pod=True)\n"
        "mesh = make_mesh((2, 4), ('data', 'model'), devices=['cpu'] * 8)\n"
        "rules = make_rules(mesh, 'train')\n"
        "pipe = TokenPipeline(DataConfig(64, 4, 16))\n"
        "for arch in ('qwen2.5-3b', 'deepseek-v3-671b'):\n"
        "    cfg = get_config(arch).reduced(n_layers=2, vocab_size=64,\n"
        "                                   moe_groups=2)\n"
        "    p = init_params(model_decls(cfg), torch.Generator(), 'cpu')\n"
        "    st = train_state_init(p, cfg)\n"
        "    sh = sanitized_shardings(mesh, train_state_pspecs(cfg,\n"
        "        model_decls(cfg), rules), st)\n"
        "    st = device_put(st, sh)\n"
        "    b = {k: torch.as_tensor(v) for k, v in\n"
        "         pipe.global_batch_at(0).items()}\n"
        "    b = device_put(b, batch_shardings(mesh, rules, b))\n"
        "    st, m = make_train_step(cfg, TrainHParams(), mesh, rules)(st, b)\n"
        "    d = tempfile.mkdtemp()\n"
        "    save_checkpoint(d, 1, st, sharded=True)\n"
        "    like = abstract_train_state(cfg, model_decls(cfg))\n"
        "    m41 = make_mesh((4, 1), ('data', 'model'), devices=['cpu'] * 4)\n"
        "    restore_checkpoint(d, like, shardings=sanitized_shardings(\n"
        "        m41, train_state_pspecs(cfg, model_decls(cfg),\n"
        "        make_rules(m41, 'train')), like))\n"
        "    for gb in (None, 1):\n"
        "        eng = ServeEngine(cfg, p, cache_len=16, mesh=mesh,\n"
        "                          rules=make_rules(mesh, 'decode', gb))\n"
        "        eng.generate(torch.zeros((4, 4), dtype=torch.int32), 2)\n"
        "cfg = get_config('qwen2.5-3b').reduced(n_layers=2, vocab_size=64)\n"
        "loop = TrainLoop(cfg, TrainHParams(), pipe, tempfile.mkdtemp(),\n"
        "                 ckpt_every=2, mesh=mesh)\n"
        "loop.run(2)\n"
        "gather(loop.state, 'cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n",
        devices=1, timeout=300,
    )
    assert "LOADED []" in out


def test_dry_run_leaves_jax_and_repro_unloaded(tmp_path):
    """The dry run (``launch.dryrun``, `roofline`): a cell through its
    launcher and a step through `analyze_step` in a fresh interpreter,
    with neither `jax` nor any `repro` module loaded after, and no
    environment variable set (``torch._dynamo``, which any dispatch mode
    loads, sets its own cache directory's when imported: imported
    first)."""
    out = run_py(
        "import os, sys\n"
        "import torch, torch._dynamo\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch.dryrun import main\n"
        "from repro_torch.roofline import analyze_step\n"
        f"main(['--arch', 'mamba2-370m', '--shape', 'decode_32k',\n"
        f"      '--set', 'n_layers=1', '--out', {str(tmp_path)!r}])\n"
        "a = torch.empty((4, 8), device='meta')\n"
        "assert analyze_step(lambda: a @ a.t()).flops == 2 * 4 * 4 * 8\n"
        "assert dict(os.environ) == env\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n",
        devices=1, timeout=300,
    )
    assert "LOADED []" in out
    assert (tmp_path / "mamba2-370m__decode_32k__pod1.json").exists()


def test_mesh_constructors_take_the_gpus_unless_given_devices(monkeypatch):
    """`make_mesh` (and so `TrainLoop` and `ServeEngine` on a mesh built
    by it) spans the visible GPUs by default and raises without one; the
    production meshes hold ``meta`` slots unless given devices."""
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_mesh(devices=["cuda"] * 4)
    assert {d.type for d in make_production_mesh().devices.flat} == {"meta"}
    mesh = make_test_mesh(devices=["cpu"] * 4)
    assert {d.type for d in mesh.devices.flat} == {"cpu"}


def test_training_entry_points_default_to_the_gpu(monkeypatch, tmp_path):
    """`TrainLoop`, ``launch.train`` and a checkpoint restored into
    ``meta`` leaves take the card unless asked for the CPU, and raise
    without one."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import TrainLoop
    from repro_torch.launch.train import main
    from repro_torch.training import TrainHParams

    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=64)
    pipe = TokenPipeline(DataConfig(64, 2, 8))
    save_checkpoint(str(tmp_path / "c"), 1, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TrainLoop(cfg, TrainHParams(), pipe,
                                   str(tmp_path / "a")),
                 lambda: TrainLoop(cfg, TrainHParams(), pipe,
                                   str(tmp_path / "a"), device="cuda"),
                 lambda: main(["--arch", "qwen2.5-3b", "--steps", "1",
                               "--ckpt-dir", str(tmp_path / "b")]),
                 lambda: restore_checkpoint(str(tmp_path / "c"),
                                            {"w": torch.ones(2)},
                                            device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    loop = TrainLoop(cfg, TrainHParams(), pipe, str(tmp_path / "a"),
                     device="cpu")
    assert loop.device.type == "cpu"
    assert {t.device.type for t in loop.state["params"]["embed"].values()} \
        == {"cpu"}


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
    """`bank_mesh()`, the sharded engine, `lower(..., "sharded")`, the
    session server and the launcher take the card unless asked for the
    CPU, and raise without one."""
    from repro_torch.compiler import compile_bank, lower
    from repro_torch.distributed import bank_mesh
    from repro_torch.filters import ShardedFilterBankEngine
    from repro_torch.launch.serve import main
    from repro_torch.serving import BankSessionServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.zeros((2, 15), np.int64)
    q[:, 7] = [3, 5]
    for call in (lambda: bank_mesh(), lambda: ShardedFilterBankEngine(q),
                 lambda: lower(compile_bank(q), "sharded"),
                 lambda: bank_mesh(1, 1, devices=["cuda"]),
                 lambda: BankSessionServer(q, n_slots=2),
                 lambda: main(["--fir-bank", "2", "--taps", "15",
                               "--chunk", "64", "--chunks", "1"]),
                 lambda: main(["--fir-bank", "2", "--taps", "15",
                               "--sessions", "2", "--chunk", "64",
                               "--chunks", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert bank_mesh(1, 1, devices=["cpu"]).devices[0][0].type == "cpu"
