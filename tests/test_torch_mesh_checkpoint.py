"""Sharded checkpoints across meshes and across the two packages.

* The port's ``sharded=True`` files (one a slot of a (2, 4) mesh of CPU
  slots, in mesh order, each with its block's index ranges) are read by
  `repro`'s restore, bit for bit.
* `repro`'s per-shard files, written on 8 forced host devices (a qwen2.5
  -3b reduced train state placed by its rules on a (2, 4) mesh, and the
  reference's elastic-test array), are read by the port into (2, 4) and
  (4, 1) meshes, bit for bit.
* The elastic re-mesh of `tests/test_checkpoint.py`, 8 → 4 → 8 slots,
  each step through sharded files and a different layout: bit-exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from _subproc import run_py
from torch_differential import ref_config, ref_lm_params, ref_param_arrays

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.distributed import (NamedSharding, PartitionSpec,
                                     ShardedTensor, device_put, gather,
                                     make_mesh, make_rules,
                                     sanitized_shardings)
from repro_torch.nn import flatten_tree, model_decls
from repro_torch.nn.common import map_tree
from repro_torch.training import (abstract_train_state, train_state_init,
                                  train_state_pspecs)

SAME = ["cpu"] * 8


def _cfg():
    return get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256,
                                            d_model=128, d_ff=256)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=SAME[:int(np.prod(shape))])


def _state_shardings(cfg, mesh, like):
    return sanitized_shardings(mesh, train_state_pspecs(
        cfg, model_decls(cfg), make_rules(mesh, "train")), like)


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def _host(tree) -> dict:
    return {k: v.numpy() for k, v in flatten_tree(gather(tree, "cpu"))
            .items()}


def test_port_sharded_files_restore_in_the_reference(tmp_path):
    from repro.checkpoint import restore_checkpoint as r_restore
    import repro.training as rt

    cfg = _cfg()
    rparams, tparams = ref_lm_params(cfg, seed=0)
    state = train_state_init(tparams, cfg)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    mesh = _mesh((2, 4))
    placed = device_put(state, _state_shardings(cfg, mesh, state))
    d = save_checkpoint(str(tmp_path), 7, placed, sharded=True)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["sharded"] is True
    wq = manifest["leaves"]["params__stage0__slot0__mixer__wq"]
    assert len(wq["shards"]) == 8 and wq["dtype"] == "float32"
    like = rt.train_state_init(rparams, ref_config(cfg))
    got, step = r_restore(str(tmp_path), like)
    assert step == 7 and int(got["step"]) == 7
    want = _host(state)
    have = {"params/" + k: v for k, v in
            ref_param_arrays(got["params"]).items()}
    have.update({"opt/" + k: v for k, v in
                 ref_param_arrays(got["opt"]).items()})
    have["step"] = np.asarray(got["step"])
    assert _equal(have, want)


REF_STATE = """
import dataclasses, tempfile, jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.checkpoint import save_checkpoint
from repro.distributed.sharding import make_rules, sanitized_shardings
from repro.nn import init_params, model_decls
from repro.training import train_state_init
from repro.training.train_step import train_state_pspecs
cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256,
                                       d_model=128, d_ff=256)
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = make_rules(mesh, "train")
state = train_state_init(init_params(model_decls(cfg), jax.random.key(0)),
                         cfg)
ssh = sanitized_shardings(mesh, train_state_pspecs(cfg, model_decls(cfg),
                                                   rules), state)
save_checkpoint(ROOT + "/state", 3, jax.device_put(state, ssh),
                sharded=True)
mesh8 = jax.make_mesh((8,), ("data",))
x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
save_checkpoint(ROOT + "/elastic", 7,
                {"w": jax.device_put(x, NamedSharding(mesh8, P("data",
                                                                None)))},
                sharded=True)
print("SAVED")
"""


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_sharded"))
    out = run_py(f"ROOT = {root!r}\n" + REF_STATE, devices=8)
    assert "SAVED" in out
    return root


@pytest.mark.parametrize("shape", [(2, 4), (4, 1)])
def test_reference_sharded_files_restore_on_a_port_mesh(ref_files, shape):
    cfg = _cfg()
    with open(os.path.join(ref_files, "state", "step_000000003",
                           "manifest.json")) as f:
        meta = json.load(f)["leaves"]["params__stage0__slot0__mixer__wq"]
    assert len(meta["shards"]) == 8  # the reference wrote its shards
    _, tparams = ref_lm_params(cfg, seed=0)
    want = _host(train_state_init(tparams, cfg))
    mesh = _mesh(shape)
    like = abstract_train_state(cfg, model_decls(cfg))
    got, step = restore_checkpoint(os.path.join(ref_files, "state"), like,
                                   shardings=_state_shardings(cfg, mesh,
                                                              like))
    assert step == 3
    assert all(isinstance(x, ShardedTensor) and x.mesh is mesh
               for x in flatten_tree(got).values())
    assert _equal(_host(got), want)
    x, _ = restore_checkpoint(
        os.path.join(ref_files, "elastic"),
        {"w": torch.empty((8, 8), device="meta")},
        shardings={"w": NamedSharding(mesh, PartitionSpec("data", None))})
    assert torch.equal(gather(x["w"], "cpu"),
                       torch.arange(64, dtype=torch.float32).reshape(8, 8))


def test_elastic_remesh_8_to_4_to_8(tmp_path):
    """Saved sharded on 8 slots, restored under a 4-slot sharding, saved
    sharded again and restored on 8 slots in another layout."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    m8, m4 = _mesh((8, 1)), _mesh((4, 1))
    xs = device_put({"w": x}, {"w": NamedSharding(m8, PartitionSpec(
        "data", None))})
    save_checkpoint(str(tmp_path / "a"), 7, xs, sharded=True)
    like = {"w": torch.empty((8, 8), device="meta")}
    r4, step = restore_checkpoint(str(tmp_path / "a"), like, shardings={
        "w": NamedSharding(m4, PartitionSpec("data", None))})
    assert step == 7 and len(r4["w"].pieces) == 4
    assert torch.equal(gather(r4["w"], "cpu"), x)
    save_checkpoint(str(tmp_path / "b"), 8, r4, sharded=True)
    with open(tmp_path / "b" / "step_000000008" / "manifest.json") as f:
        assert len(json.load(f)["leaves"]["w"]["shards"]) == 4
    r8, _ = restore_checkpoint(str(tmp_path / "b"), like, shardings={
        "w": NamedSharding(m8, PartitionSpec(None, "data"))})
    assert len(r8["w"].pieces) == 8 and r8["w"].spec == (None, "data")
    assert torch.equal(gather(r8["w"], "cpu"), x)
    # a placed tree restores into its own placement
    r, _ = restore_checkpoint(str(tmp_path / "b"), r8)
    assert r["w"].spec == (None, "data")
    assert torch.equal(gather(r["w"], "cpu"), x)


def test_a_train_state_remeshes_and_stays_exact(tmp_path):
    """A placed train state saved sharded on (2, 4) restores onto (4, 1)
    and back through its own files: every leaf bit-exact, placed by
    `train_state_pspecs` on each mesh."""
    cfg = _cfg()
    _, tparams = ref_lm_params(cfg, seed=0)
    state = train_state_init(map_tree(lambda t: t.clone(), tparams), cfg)
    want = _host(state)
    m24, m41 = _mesh((2, 4)), _mesh((4, 1))
    placed = device_put(state, _state_shardings(cfg, m24, state))
    save_checkpoint(str(tmp_path), 1, placed, sharded=True)
    like = abstract_train_state(cfg, model_decls(cfg))
    on41, _ = restore_checkpoint(str(tmp_path), like,
                                 shardings=_state_shardings(cfg, m41, like))
    assert _equal(_host(on41), want)
    save_checkpoint(str(tmp_path), 2, on41, sharded=True)
    back, step = restore_checkpoint(str(tmp_path), placed)
    assert step == 2 and _equal(_host(back), want)
