"""The port's LM sharding rules and specs against `repro`'s, as tuples.

For all ten archs at their published widths, on the (2, 4), (8, 1),
(16, 16) and (2, 16, 16) meshes, and for the train, prefill and decode
kinds (decode also with a global batch below the data size):
`make_rules`, `param_pspecs`, `sanitized_shardings` with and without
``tp_fallback_axis``, `train_state_pspecs` (and its sanitized
shardings over the abstract train state), `cache_pspecs` (and its
sanitized shardings over the abstract caches) and `batch_shardings`
must equal the reference's entry for entry.

`repro`'s functions read only a mesh's axis names and sizes, and its
`NamedSharding` takes a `jax.sharding.AbstractMesh`, so the reference
runs here on abstract meshes of those shapes: no devices are forced.
The port's meshes hold ``meta`` slots (`repro_torch.launch.mesh`).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from torch_differential import ref_config

from repro_torch.configs import all_configs, get_config
from repro_torch.distributed import (PartitionSpec, batch_pspec,
                                     batch_shardings, data_axes, data_size,
                                     make_mesh, make_rules, sanitize_spec,
                                     sanitized_shardings)
from repro_torch.nn import abstract_params, model_decls, param_pspecs
from repro_torch.serving import abstract_caches, cache_pspecs
from repro_torch.training import abstract_train_state, train_state_pspecs

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = [("train", None), ("prefill", None), ("decode", None),
         ("decode", 1)]  # the last: a decode batch below the data size
CACHE_LEN, DECODE_BATCH = 256, 4


def _port_mesh(name):
    shape, names = MESHES[name]
    return make_mesh(shape, names, devices=["meta"] * int(np.prod(shape)))


def _ref_mesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _norm(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


def _spec(s) -> tuple:
    return tuple(_norm(e) for e in s)


def _flat(tree, prefix=""):
    """{key path: leaf} over nested dicts, lists and tuples; a
    PartitionSpec of either package and a NamedSharding are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, jax.sharding.PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _specs(tree) -> dict:
    """{path: spec as a tuple}; NamedSharding leaves give their spec."""
    return {k: _spec(getattr(v, "spec", v)) for k, v in _flat(tree).items()}


def _ref_abstract_state(cfg):
    from repro.nn import model_decls as r_decls
    from repro.training.train_step import abstract_train_state as r_ats

    rc = ref_config(cfg)
    return r_ats(rc, r_decls(rc))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_rules_and_specs_equal_the_reference(arch, mesh_name):
    import repro.distributed.sharding as rs
    from repro.nn import abstract_params as r_abstract
    from repro.nn import model_decls as r_decls
    from repro.nn.common import param_pspecs as r_pspecs
    from repro.serving.engine import abstract_caches as r_caches
    from repro.serving.engine import cache_pspecs as r_cache_pspecs
    from repro.training.train_step import (
        train_state_pspecs as r_train_pspecs)

    cfg = get_config(arch)
    rc = ref_config(cfg)
    pm, rm = _port_mesh(mesh_name), _ref_mesh(mesh_name)
    assert data_axes(pm) == rs.data_axes(rm)
    assert data_size(pm) == rs.data_size(rm)
    decls, rdecls = model_decls(cfg), r_decls(rc)
    aparams, raparams = abstract_params(decls), r_abstract(rdecls)
    for kind, gb in KINDS:
        rules = make_rules(pm, kind, gb)
        rrules = rs.make_rules(rm, kind, gb)
        assert {k: _norm(v) for k, v in rules.items()} == \
            {k: _norm(v) for k, v in rrules.items()}, (kind, gb)
        ps = param_pspecs(decls, rules)
        assert len(_specs(ps)) >= 8
        assert _specs(ps) == _specs(r_pspecs(rdecls, rrules)), (kind, gb)
        for fb in (None, "model"):
            got = sanitized_shardings(pm, ps, aparams, tp_fallback_axis=fb)
            want = rs.sanitized_shardings(rm, r_pspecs(rdecls, rrules),
                                          raparams, tp_fallback_axis=fb)
            assert _specs(got) == _specs(want), (kind, gb, fb)
        if kind == "train":
            tps = train_state_pspecs(cfg, decls, rules)
            assert _specs(tps) == _specs(r_train_pspecs(rc, rdecls, rrules))
            got = sanitized_shardings(pm, tps,
                                      abstract_train_state(cfg, decls))
            want = rs.sanitized_shardings(
                rm, r_train_pspecs(rc, rdecls, rrules),
                _ref_abstract_state(cfg))
            assert _specs(got) == _specs(want)
        else:
            cps = cache_pspecs(cfg, rules)
            assert _specs(cps) == _specs(r_cache_pspecs(rc, rrules))
            b = gb or DECODE_BATCH
            got = sanitized_shardings(pm, cps,
                                      abstract_caches(cfg, b, CACHE_LEN))
            want = rs.sanitized_shardings(rm, r_cache_pspecs(rc, rrules),
                                          r_caches(rc, b, CACHE_LEN))
            assert _specs(got) == _specs(want), (kind, gb)
        if rules["batch"] is not None:
            batch = {"tokens": torch.empty((16, 8), device="meta"),
                     "embeds": torch.empty((16, 8, 4), device="meta")}
            rbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                      for k, v in batch.items()}
            assert _specs(batch_shardings(pm, rules, batch)) == _specs(
                rs.batch_shardings(rm, rrules, rbatch))
            assert _spec(batch_pspec(pm, rules, 3)) == _spec(
                rs.batch_pspec(rm, rrules, 3))


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (8, 8)),
    (("data", "model"), (6, 8)),        # 6 rows do not split over data=4
    ((("data", "model"),), (32, 3)),    # a tuple entry: 32 ways needed
    ((("data", "model"),), (16, 3)),
    ((None, "model"), (4, 3)),          # 3 kv heads on model=2
    (("model",), (3, 5, 7)),            # a short spec pads with None
])
def test_sanitize_spec_equals_the_reference(spec, shape):
    import repro.distributed.sharding as rs

    pm = make_mesh((4, 2), ("data", "model"), devices=["meta"] * 8)
    rm = AbstractMesh((4, 2), ("data", "model"))
    got = sanitize_spec(pm, PartitionSpec(*spec), shape)
    want = rs.sanitize_spec(rm, jax.sharding.PartitionSpec(*spec), shape)
    assert _spec(got) == _spec(want)
    assert len(got) == len(shape)


def test_qwen_kv_heads_replicate_and_cache_seq_takes_model():
    """qwen2.5-3b has 2 kv heads on a model axis of 4: `sanitize_spec`
    replicates them, and in decode rules `cache_pspecs` drops kv_heads
    where cache_seq uses model (the issue the reference documents)."""
    cfg = get_config("qwen2.5-3b")
    mesh = _port_mesh("2x4")
    rules = make_rules(mesh, "train")
    wk = sanitized_shardings(
        mesh, param_pspecs(model_decls(cfg), rules),
        abstract_params(model_decls(cfg)))["stage0"]["slot0"]["mixer"]["wk"]
    assert _spec(wk.spec) == (None, "data", None, None)
    for gb, cs in ((None, "model"), (1, ("data", "model"))):
        rules = make_rules(mesh, "decode", gb)
        k = cache_pspecs(cfg, rules)[0][0]["k"]
        assert _spec(k)[2] is None and _spec(k)[3] == cs


def test_partition_spec_compares_as_a_tuple():
    s = PartitionSpec("data", ["pod", "data"], None)
    assert s == ("data", ("pod", "data"), None)
    assert tuple(s) == ("data", ("pod", "data"), None)
    assert len(s) == 3 and s[1] == ("pod", "data")
    assert s == PartitionSpec("data", ("pod", "data"), None)
    assert s != PartitionSpec("data")
    sh = sanitized_shardings(_port_mesh("8x1"),
                             {"w": PartitionSpec("data", "model")},
                             {"w": torch.empty((8, 8, 2), device="meta")})
    assert dataclasses.is_dataclass(sh["w"])
    assert sh["w"].spec == ("data", "model", None)
