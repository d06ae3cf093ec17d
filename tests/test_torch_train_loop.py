"""The port's `TrainLoop` on the CPU: crash → auto-resume bit-exact with
the uninterrupted run (after ``tests/test_fault.py``); a run `repro`
started and checkpointed, resumed by the port and held against
`repro`'s own resume; and train → checkpoint → `ServeEngine` (after
``tests/test_system.py``'s cycle)."""
import shutil

import numpy as np
import pytest
import torch

from torch_differential import (adam_drift_bound, ref_param_arrays,
                                train_tree_gap)

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed import SimulatedFailure, TrainLoop
from repro_torch.nn import flatten_tree
from repro_torch.training import OptHParams, TrainHParams

SMALL = dict(n_layers=2, vocab_size=128, d_model=64, d_ff=128)
OPT = OptHParams(learning_rate=3e-3, warmup_steps=5, total_steps=40)
STATE_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models on one thread: beside the other test workers, a pool of
    spinning OpenMP threads a process slows them by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(ckpt_dir, seed=1, **kw):
    cfg = get_config("qwen2.5-3b").reduced(**SMALL, **kw)
    pipe = TokenPipeline(DataConfig(128, 8, 32, seed=seed))
    return TrainLoop(cfg, TrainHParams(opt=OPT), pipe, str(ckpt_dir),
                     ckpt_every=5, device="cpu")


def test_crash_resume_bit_exact(tmp_path, capsys):
    a = _mk(tmp_path / "a")
    a.run(20)
    b = _mk(tmp_path / "b")
    with pytest.raises(SimulatedFailure):
        b.run(20, fail_at=13)
    assert b.step == 13
    b2 = _mk(tmp_path / "b")  # auto-resumes from step 10
    assert "[fault] resumed from checkpoint at step 10" in \
        capsys.readouterr().out
    assert b2.step == 10 and b2.state["step"].dtype == torch.int32
    b2.run(20)
    pa = flatten_tree(a.state)
    pb = flatten_tree(b2.state)
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert [h["step"] for h in b2.metrics_history] == list(range(10, 20))
    assert len(a.stragglers.times) == 20


def test_the_port_resumes_a_reference_run(tmp_path):
    """`repro` trains 10 steps and checkpoints; the port resumes that
    directory and trains to 20; `repro` resumes a copy of it to 20, in
    float32 compute.  The two runs' params within 1e-4 of each leaf's
    scale (elements whose own moments are looser counted, as in
    ``test_torch_train_step``), losses within 1e-4."""
    import repro.training as rt
    from repro.configs import get_config as r_get
    from repro.data import DataConfig as RData
    from repro.data import TokenPipeline as RPipe
    from repro.distributed.fault import TrainLoop as RLoop

    def ref_loop(d):
        cfg = r_get("qwen2.5-3b").reduced(**SMALL, compute_dtype="float32")
        hp = rt.TrainHParams(opt=rt.OptHParams(learning_rate=3e-3,
                                               warmup_steps=5,
                                               total_steps=40))
        return RLoop(cfg, hp, RPipe(RData(128, 8, 32, seed=1)), str(d),
                     ckpt_every=5)

    ref_loop(tmp_path / "ref").run(10)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    r = ref_loop(tmp_path / "ref")
    assert r.step == 10
    rhist = r.run(20)
    p = _mk(tmp_path / "port", compute_dtype="float32")
    assert p.step == 10
    phist = p.run(20)
    np.testing.assert_allclose([h["loss"] for h in phist],
                               [h["loss"] for h in rhist[-10:]], rtol=1e-4)
    gap = train_tree_gap(flatten_tree(p.state["params"]),
                         ref_param_arrays(r.state["params"]), STATE_REL,
                         opt=(flatten_tree(p.state["opt"]),
                              ref_param_arrays(r.state["opt"])),
                         drift=adam_drift_bound(OPT, range(10, 20)))
    assert gap["worst"] <= STATE_REL, gap
    assert set(gap["amplified_leaves"]) <= {"stage0/slot0/mixer/bk"}, gap


def test_train_checkpoint_serve_cycle(tmp_path):
    """120 steps at lr 1e-2 memorise the markov map; the checkpoint
    restores into `ServeEngine`, whose greedy continuations follow the
    map far above chance (1/128)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.serving import ServeEngine

    cfg = get_config("qwen2.5-3b").reduced(**SMALL)
    pipe = TokenPipeline(DataConfig(128, 8, 32, seed=7))
    hp = TrainHParams(opt=OptHParams(learning_rate=1e-2, warmup_steps=3,
                                     total_steps=120))
    loop = TrainLoop(cfg, hp, pipe, str(tmp_path), ckpt_every=40,
                     device="cpu")
    hist = loop.run(120)
    assert hist[-1]["loss"] < hist[0]["loss"]
    state, step = restore_checkpoint(str(tmp_path), loop.state)
    assert step == 120
    eng = ServeEngine(cfg, state["params"], cache_len=64, device="cpu")
    out = eng.generate(np.zeros((2, 8), np.int32), max_new_tokens=6)
    assert tuple(out.shape) == (2, 6)
    out = out.numpy()
    nxt = (out[:, :-1].astype(np.int64) * pipe._a + pipe._c) % 128
    agree = (out[:, 1:] == nxt).mean()
    assert agree > 0.5, agree
