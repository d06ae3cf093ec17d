"""The train step on a mesh of CPU slots.

* Against `repro`'s unsharded jitted step, for the configuration of
  `tests/test_sharded.py` (qwen2.5-3b reduced to 2 layers, vocab 256,
  d_model 128, d_ff 256, float32, B 8 × 32, lr 1e-3) on a (2, 4) mesh:
  the reference test's own bounds, |Δloss| < 1e-4 and params max
  |Δ| < 1e-4, for its one step; and for three steps at the peak rate,
  each loss within 1e-4 and the params and optimizer state within 1e-4
  of each leaf's scale (`train_tree_gap`, its Adam-amplified elements
  counted within its limits).
* Against the port's own unsharded step, every arch reduced, float32,
  two steps (the schedule's lr 0, then its peak): metrics within the LM
  tests' rtol 2e-4 / atol 2e-5, params and optimizer state within 1e-4
  of each leaf's scale under `train_tree_gap`'s excuses and no other —
  AdamW and Adafactor (deepseek-v3-671b), MoE with ``moe_groups = 2``,
  ``grad_accum = 2``, remat on, and slots on eight distinct devices
  (``cpu:0`` … ``cpu:7``: replicated blocks summed across their copies).
* `TrainLoop` on a mesh crashes and resumes bit-exact, with the rules'
  batch shardings and with explicit ones (the batch replicated).

A mesh step splits the batch's rows over two data slots and sums their
gradients, so its float32 sums run in another order than the unsharded
step's: 1e-4 of scale, not 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_differential import (adam_drift_bound, lm_train_batch,
                                ref_config, ref_lm_params, ref_param_arrays,
                                train_tree_gap)

from repro_torch.configs import all_configs, get_config
from repro_torch.distributed import (ShardedTensor, batch_shardings,
                                     device_put, gather, make_mesh,
                                     make_rules, sanitized_shardings)
from repro_torch.nn import flatten_tree, init_params, model_decls
from repro_torch.nn.common import map_tree
from repro_torch.training import (OptHParams, TrainHParams, make_train_step,
                                  train_state_init, train_state_pspecs)

SAME = ["cpu"] * 8
DISTINCT = [f"cpu:{i}" for i in range(8)]
REF_BOUND = 1e-4  # tests/test_sharded.py
STATE_REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
OPT = OptHParams(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ROWS, SEQ = 8, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(devices=SAME):
    return make_mesh((2, 4), ("data", "model"), devices=devices)


def _placed_state(cfg, params, mesh, rules):
    state = train_state_init(map_tree(lambda t: t.clone(), params), cfg)
    return device_put(state, sanitized_shardings(
        mesh, train_state_pspecs(cfg, model_decls(cfg), rules), state))


def _placed_batch(batch, mesh, rules):
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return device_put(batch, batch_shardings(mesh, rules, batch))


def _sharded_cfg():
    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256,
                                           d_model=128, d_ff=256)
    return dataclasses.replace(cfg, compute_dtype="float32")


def _sharded_batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
            "labels": rng.integers(0, 256, (8, 32)).astype(np.int32),
            "mask": np.ones((8, 32), np.float32)}


def _ref_hp(hp):
    import repro.training as rt

    return rt.TrainHParams(opt=rt.OptHParams(**dataclasses.asdict(hp.opt)),
                           grad_accum=hp.grad_accum)


@pytest.mark.parametrize("steps,opt", [(1, OptHParams(learning_rate=1e-3)),
                                       (3, OPT)],
                         ids=["reference_test", "three_steps_at_peak"])
def test_mesh_step_matches_the_reference_unsharded_step(steps, opt):
    import repro.training as rt

    cfg = _sharded_cfg()
    hp = TrainHParams(opt=opt)
    rparams, tparams = ref_lm_params(cfg, seed=0)
    rstate = rt.train_state_init(rparams, ref_config(cfg))
    rstep = jax.jit(rt.make_train_step(ref_config(cfg), _ref_hp(hp)))
    mesh = _mesh()
    rules = make_rules(mesh, "train")
    state = _placed_state(cfg, tparams, mesh, rules)
    step = make_train_step(cfg, hp, mesh, rules)
    batch = _sharded_batch()
    placed = _placed_batch(batch, mesh, rules)
    for i in range(steps):
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, placed)
        assert abs(float(met["loss"]) - float(rmet["loss"])) < REF_BOUND
        for k in rmet:
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL)
        host = gather(state, "cpu")
        rp = ref_param_arrays(rstate["params"])
        tp = flatten_tree(host["params"])
        if steps == 1:  # the reference test's own check, absolute
            assert max(float(np.abs(tp[k].numpy() - rp[k]).max())
                       for k in rp) < REF_BOUND
        ropt = ref_param_arrays(rstate["opt"])
        gap = train_tree_gap(tp, rp, STATE_REL,
                             opt=(flatten_tree(host["opt"]), ropt),
                             drift=adam_drift_bound(opt, range(i + 1)))
        assert gap["worst"] <= STATE_REL, gap
        ogap = train_tree_gap(flatten_tree(host["opt"]), ropt, STATE_REL)
        assert ogap["worst"] <= STATE_REL, ogap
        assert int(host["step"]) == int(rstate["step"]) == i + 1
    assert all(isinstance(x, ShardedTensor)
               for x in flatten_tree(state).values())


CASES = [(arch, 1, "same", None) for arch in sorted(all_configs())] + [
    ("qwen2.5-3b", 2, "same", None),
    ("deepseek-v3-671b", 2, "same", None),
    ("qwen2.5-3b", 1, "same", "full"),
    ("qwen2.5-3b", 2, "distinct", "full"),
    ("deepseek-v3-671b", 1, "distinct", None),
    ("mixtral-8x22b", 1, "distinct", "full"),
]


@pytest.mark.parametrize("arch,grad_accum,devices,remat", CASES)
def test_mesh_step_matches_the_unsharded_step(arch, grad_accum, devices,
                                              remat):
    cfg = get_config(arch).reduced(compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=2)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    hp = TrainHParams(opt=OPT, grad_accum=grad_accum)
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = _mesh(SAME if devices == "same" else DISTINCT)
    rules = make_rules(mesh, "train")
    ref = train_state_init(map_tree(lambda t: t.clone(), params), cfg)
    state = _placed_state(cfg, params, mesh, rules)
    ref_step = make_train_step(cfg, hp)
    step = make_train_step(cfg, hp, mesh, rules)
    for i in range(2):
        batch = lm_train_batch(cfg, ROWS, SEQ, seed=i)
        ref, rmet = ref_step(ref, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
        state, met = step(state, _placed_batch(batch, mesh, rules))
        for k in rmet:
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL)
    host = gather(state, "cpu")
    ropt, topt = flatten_tree(ref["opt"]), flatten_tree(host["opt"])
    gap = train_tree_gap(flatten_tree(host["params"]),
                         flatten_tree(ref["params"]), STATE_REL,
                         opt=(topt, ropt) if cfg.optimizer == "adamw"
                         else None,
                         drift=adam_drift_bound(OPT, range(2)))
    assert gap["worst"] <= STATE_REL, gap
    ogap = train_tree_gap(topt, ropt, STATE_REL)
    assert ogap["worst"] <= STATE_REL, ogap
    assert int(host["step"]) == 2
    # replicas of a block on distinct devices stay equal
    for x in flatten_tree(state).values():
        for ids in x.groups().values():
            assert all(torch.equal(x.pieces[j], x.pieces[ids[0]])
                       for j in ids)


def test_the_mesh_step_updates_the_pieces_in_place():
    cfg = _sharded_cfg()
    _, tparams = ref_lm_params(cfg, seed=0)
    mesh = _mesh()
    rules = make_rules(mesh, "train")
    state = _placed_state(cfg, tparams, mesh, rules)
    ptrs = [p.data_ptr() for x in flatten_tree(
        {"p": state["params"], "o": state["opt"]}).values() for p in x.pieces]
    new, _ = make_train_step(cfg, TrainHParams(opt=OPT), mesh, rules)(
        state, _placed_batch(lm_train_batch(cfg, 4, 8, seed=0), mesh, rules))
    assert ptrs == [p.data_ptr() for x in flatten_tree(
        {"p": new["params"], "o": new["opt"]}).values() for p in x.pieces]
    # on one device a (2, 4) mesh stores every leaf once
    for x in flatten_tree(new["params"]).values():
        assert sum(p.numel() for p in x.pieces) == int(np.prod(x.shape))


def test_moe_groups_must_split_over_the_data_slots():
    cfg = get_config("mixtral-8x22b").reduced(compute_dtype="float32")
    assert cfg.moe_groups == 1
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = _mesh()
    rules = make_rules(mesh, "train")
    state = _placed_state(cfg, params, mesh, rules)
    step = make_train_step(cfg, TrainHParams(opt=OPT), mesh, rules)
    with pytest.raises(ValueError, match="moe_groups=2"):
        step(state, _placed_batch(lm_train_batch(cfg, 4, 8, seed=0), mesh,
                                  rules))


def test_microbatches_must_split_over_the_data_slots():
    cfg = _sharded_cfg()
    _, tparams = ref_lm_params(cfg, seed=0)
    mesh = _mesh()
    rules = make_rules(mesh, "train")
    step = make_train_step(cfg, TrainHParams(opt=OPT, grad_accum=4), mesh,
                           rules)
    with pytest.raises(ValueError, match="data slots"):
        step(_placed_state(cfg, tparams, mesh, rules),
             _placed_batch(lm_train_batch(cfg, 4, 8, seed=0), mesh, rules))


def _train_loop(path, replicated: bool = False):
    """A `TrainLoop` of qwen2.5-3b reduced on a (2, 4) mesh, checkpoints
    every 5 steps in ``path``; ``replicated``: batch shardings given
    explicitly, every batch leaf replicated over the whole mesh."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import NamedSharding, PartitionSpec, TrainLoop

    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=128,
                                           d_model=64, d_ff=128)
    hp = TrainHParams(opt=OptHParams(learning_rate=3e-3, warmup_steps=5,
                                     total_steps=40))
    pipe = TokenPipeline(DataConfig(128, 8, 32, seed=1))
    mesh = _mesh()
    sh = ({k: NamedSharding(mesh, PartitionSpec())
           for k in pipe.global_batch_at(0)} if replicated else None)
    return TrainLoop(cfg, hp, pipe, str(path), ckpt_every=5, mesh=mesh,
                     batch_shardings=sh)


def _crash_resume_matches(tmp_path, replicated: bool):
    """An uninterrupted run to step 20 under the rules' batch shardings,
    and a run (``replicated`` or not) killed at step 13 and resumed from
    its step-10 checkpoint: the two end bit-exact."""
    from repro_torch.distributed import SimulatedFailure

    a = _train_loop(tmp_path / "a")
    a.run(20)
    b = _train_loop(tmp_path / "b", replicated)
    with pytest.raises(SimulatedFailure):
        b.run(20, fail_at=13)
    b2 = _train_loop(tmp_path / "b", replicated)
    assert b2.step == 10
    assert isinstance(b2.state["params"]["embed"]["table"], ShardedTensor)
    b2.run(20)
    pa, pb = (flatten_tree(gather(x.state, "cpu")) for x in (a, b2))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert [h["loss"] for h in a.metrics_history[-7:]] == \
        [h["loss"] for h in b2.metrics_history[-7:]]
    return b2


def test_train_loop_on_a_mesh_resumes_bit_exact(tmp_path):
    """`tests/test_fault.py`'s crash → resume on a (2, 4) mesh: the run
    killed at step 13 and resumed from its step-10 checkpoint ends
    bit-exact with the uninterrupted one."""
    _crash_resume_matches(tmp_path, replicated=False)


def test_train_loop_on_a_mesh_takes_explicit_batch_shardings(tmp_path):
    """`TrainLoop(batch_shardings=)` places each batch as given — here
    replicated over the whole mesh instead of split over ``data`` — and
    its crash → resume ends bit-exact with an uninterrupted run under the
    rules' own batch shardings (a data slot reads its rows wherever they
    lie)."""
    from repro_torch.distributed import PartitionSpec

    loop = _crash_resume_matches(tmp_path, replicated=True)
    placed = loop._put(loop.pipeline.global_batch_at(0))
    assert all(v.spec == PartitionSpec() for v in placed.values())
