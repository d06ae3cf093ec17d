"""The dry run's per-device FLOPs on a (2, 2) mesh against what XLA's
partitioner makes of `repro`: for reduced qwen2.5-3b, starcoder2-3b
and gemma2-27b (4 heads and 2 kv heads, d_ff 256 and vocab 512: every
dense product splits 2 ways), `repro`'s sharded train step (B 8 × 64),
prefill (B 8 × 64) and decode step (B 8, cache 64) are compiled on 4
forced host devices (in a subprocess: `jax.jit` with the dry run's
``in_shardings``) and `analyze_hlo` reads each device's dot FLOPs from
the partitioned program.  The port's `run_cell` on (2, 2) ``meta``
slots charges a device with its (data, model) slot's products and the
data slot's replicated ones; the two are equal: XLA splits every dot
over ``model`` as the port's product rule does."""
import json

import pytest

from _subproc import run_py
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.dryrun import run_cell

ARCHS = ["qwen2.5-3b", "starcoder2-3b", "gemma2-27b"]
KINDS = ("train", "prefill", "decode")
B, S = 8, 64

_REF = """
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs import ShapeSpec, get_config, input_specs
from repro.distributed.sharding import (make_rules, sanitize_spec,
                                        sanitized_shardings)
from repro.nn.common import abstract_params, param_pspecs
from repro.nn.model import model_decls
from repro.roofline.hlo_analysis import analyze_hlo
from repro.serving.engine import (abstract_caches, cache_pspecs,
                                  make_decode_fn, make_prefill_fn)
from repro.training.train_step import (TrainHParams, abstract_train_state,
                                       make_train_step, train_state_pspecs)

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
B, S = %d, %d


def bsh(rules, ab):
    return {k: NamedSharding(mesh, sanitize_spec(mesh, PartitionSpec(
        rules.get("batch"), *([None] * (len(v.shape) - 1))), tuple(v.shape)))
        for k, v in ab.items()}


out = {}
for arch in %r:
    cfg = get_config(arch).reduced()
    decls = model_decls(cfg)
    r = {}
    rules = make_rules(mesh, "train", B)
    astate = abstract_train_state(cfg, decls)
    ab = input_specs(cfg, ShapeSpec("t", S, B, "train"))
    ssh = sanitized_shardings(mesh, train_state_pspecs(cfg, decls, rules),
                              astate)
    f = jax.jit(make_train_step(cfg, TrainHParams(), mesh, rules),
                in_shardings=(ssh, bsh(rules, ab)),
                out_shardings=(ssh, None), donate_argnums=0)
    r["train"] = analyze_hlo(f.lower(astate, ab).compile().as_text()).flops
    aparams = abstract_params(decls, jnp.dtype(cfg.param_dtype))
    for kind in ("prefill", "decode"):
        rules = make_rules(mesh, kind, B)
        psh = sanitized_shardings(mesh, param_pspecs(decls, rules), aparams,
                                  tp_fallback_axis="model")
        ab = input_specs(cfg, ShapeSpec("x", S, B, kind))
        if kind == "prefill":
            low = jax.jit(make_prefill_fn(cfg, cache_len=S, mesh=mesh,
                                          rules=rules),
                          in_shardings=(psh, bsh(rules, ab))).lower(aparams,
                                                                    ab)
        else:
            acaches = abstract_caches(cfg, B, S)
            csh = sanitized_shardings(mesh, cache_pspecs(cfg, rules),
                                      acaches)
            pos = jax.ShapeDtypeStruct((B,), jnp.int32)
            st = {"caches": csh, "pos": NamedSharding(mesh, sanitize_spec(
                mesh, PartitionSpec(rules.get("batch")), pos.shape))}
            low = jax.jit(make_decode_fn(cfg, mesh=mesh, rules=rules),
                          in_shardings=(psh, bsh(rules, ab), st),
                          out_shardings=(None, st), donate_argnums=2).lower(
                aparams, ab, {"caches": acaches, "pos": pos})
        r[kind] = analyze_hlo(low.compile().as_text()).flops
    out[arch] = r
print(json.dumps(out))
""" % (B, S, ARCHS)


@pytest.fixture(scope="module")
def ref_flops():
    return json.loads(run_py(_REF, devices=4, timeout=600)
                      .strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_dot_flops_equal_the_partitioned_reference(arch,
                                                              ref_flops):
    cfg = get_config(arch).reduced()
    for kind in KINDS:
        r = run_cell(arch, ShapeSpec(kind[0], S, B, kind), out_dir=None,
                     mesh_shape=(2, 2), cfg=cfg)
        want = ref_flops[arch][kind]
        assert r["op_flops_per_dev"] == want > 0, kind
        # every product splits 2 ways: a device computes half its slot's
        assert 2 * r["op_flops_per_dev"] == r["op_flops_per_data_slot"]
