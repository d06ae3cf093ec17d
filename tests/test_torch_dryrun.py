"""The port's dry run (`repro_torch.launch.dryrun`) against `repro`'s:
prefill FLOPs against `analyze_hlo` of the compiled reference for all
ten archs, `model_flops` and the parameter counts for every cell, and
the per-device argument bytes on a (2, 4) mesh against XLA's memory
analysis; and the launcher writing a cell's JSON.

`repro.launch.dryrun` sets ``XLA_FLAGS`` when it is imported, so the
reference's dry run is imported in subprocesses only.
"""
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from _subproc import run_py
from repro.configs import ShapeSpec as RefShape
from repro.configs import all_configs
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_specs
from repro.nn.common import abstract_params as ref_abstract
from repro.nn.model import model_decls as ref_decls
from repro.roofline.hlo_analysis import analyze_hlo
from repro.serving.engine import make_prefill_fn as ref_prefill
from repro_torch.configs import SHAPES, ShapeSpec, cells_for, get_config
from repro_torch.configs import input_specs
from repro_torch.launch import dryrun
from repro_torch.nn import count_active_params, count_params, model_decls
from repro_torch.nn.common import map_tree, torch_dtype
from repro_torch.roofline import analyze_step
from repro_torch.serving.engine import make_prefill_fn

ARCHS = sorted(all_configs())
B, S = 2, 64  # the prefill cell of the comparison, unsharded


def _meta_params(cfg):
    dt = torch_dtype(cfg.param_dtype)
    return map_tree(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                    model_decls(cfg))


@functools.cache
def _prefill_costs(arch):
    """(the compiled reference's `analyze_hlo`, the port's `analyze_step`)
    of ``arch``'s prefill, reduced (2 layers, or its block pattern's),
    unsharded, B 2 × 64."""
    rc = ref_config(arch).reduced()
    lowered = jax.jit(ref_prefill(rc, cache_len=S)).lower(
        ref_abstract(ref_decls(rc), jnp.dtype(rc.param_dtype)),
        ref_specs(rc, RefShape("p", S, B, "prefill")))
    cfg = get_config(arch).reduced()
    return (analyze_hlo(lowered.compile().as_text()),
            analyze_step(make_prefill_fn(cfg, cache_len=S),
                         _meta_params(cfg),
                         input_specs(cfg, ShapeSpec("p", S, B, "prefill"))))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_dot_flops_equal_the_reference_hlo(arch):
    """The port's `analyze_step` on ``meta`` tensors counts exactly the
    dot FLOPs `analyze_hlo` reads from the compiled reference (the MoE
    archs trace on ``meta`` since `_positions_in_expert` takes no
    data-dependent shape)."""
    want, got = _prefill_costs(arch)
    assert got.flops == want.flops > 0


_MATMULS = ("mm", "bmm", "addmm", "baddbmm")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_hbm_bytes_against_the_reference_hlo(arch):
    """``hbm_bytes`` is the reference's per-op model without XLA's
    fusions, a lower bound on `analyze_hlo`'s, and the gap is the
    fusions': on these ten cells the port's is 0.25–0.39 of the
    reference's.  Its parts:

    * matmuls: the compiled reference's dots read and write float32 on
      the CPU (its bf16 legalization): twice the port's bf16 ``mm`` /
      ``bmm`` bytes, exactly for the float32-parameter archs and 128 KiB
      less (0.9–2.8%) for the five bf16-parameter archs;
    * the rest: the reference charges each fusion (an element-wise
      chain, a reduction with its producers) a round trip, 49–63% of
      its bytes, where the port charges element-wise ops nothing and a
      reduction alone: the port's non-matmul bytes are 0.10–0.31 of the
      reference's non-dot bytes."""
    want, got = _prefill_costs(arch)
    mm = sum(got.hbm_by_op.get(k, 0) for k in _MATMULS)
    dot = want.hbm_by_op["dot"]
    assert 0 <= 2 * mm - dot <= 0.03 * dot
    rest, ref_rest = got.hbm_bytes - mm, want.hbm_bytes - dot
    assert 0.08 * ref_rest <= rest <= 0.35 * ref_rest
    assert 0.22 * want.hbm_bytes <= got.hbm_bytes <= 0.42 * want.hbm_bytes


@pytest.fixture(scope="module")
def ref_model_flops():
    return json.loads(run_py(
        "import json\n"
        "from repro.configs import SHAPES, all_configs, cells_for, "
        "get_config\n"
        "from repro.launch.dryrun import model_flops\n"
        "from repro.nn.common import count_active_params, count_params\n"
        "from repro.nn.model import model_decls\n"
        "out = {}\n"
        "for arch in sorted(all_configs()):\n"
        "    cfg = get_config(arch)\n"
        "    d = model_decls(cfg)\n"
        "    out[arch] = {'n_params': count_params(d),\n"
        "        'n_active_params': count_active_params(\n"
        "            d, cfg.experts_per_token, cfg.n_experts),\n"
        "        'cells': {s: model_flops(cfg, d, SHAPES[s])\n"
        "                  for s in cells_for(arch)}}\n"
        "print(json.dumps(out))\n", devices=1, timeout=300
    ).strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_params_equal_the_reference(arch, ref_model_flops):
    want = ref_model_flops[arch]
    cfg = get_config(arch)
    decls = model_decls(cfg)
    assert count_params(decls) == want["n_params"]
    assert count_active_params(decls, cfg.experts_per_token,
                               cfg.n_experts) == want["n_active_params"]
    assert sorted(cells_for(arch)) == sorted(want["cells"])
    for shape in cells_for(arch):
        cell = dryrun.build_cell(arch, shape)
        assert dryrun.model_flops(cell.cfg, cell.decls, SHAPES[shape]) \
            == want["cells"][shape], shape


_REF_ARGUMENT_BYTES = """
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs import ShapeSpec, get_config, input_specs
from repro.distributed.sharding import (make_rules, sanitize_spec,
                                        sanitized_shardings)
from repro.nn.common import abstract_params, param_pspecs
from repro.nn.model import model_decls
from repro.serving.engine import abstract_caches, cache_pspecs, make_decode_fn
from repro.training.train_step import (TrainHParams, abstract_train_state,
                                       make_train_step, train_state_pspecs)

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = get_config("qwen2.5-3b").reduced()
decls = model_decls(cfg)


def bsh(rules, ab):
    return {k: NamedSharding(mesh, sanitize_spec(mesh, PartitionSpec(
        rules.get("batch"), *([None] * (len(v.shape) - 1))), tuple(v.shape)))
        for k, v in ab.items()}


out = {}
shape = ShapeSpec("t", 64, 8, "train")
rules = make_rules(mesh, "train", 8)
astate = abstract_train_state(cfg, decls)
ab = input_specs(cfg, shape)
ssh = sanitized_shardings(mesh, train_state_pspecs(cfg, decls, rules), astate)
f = jax.jit(make_train_step(cfg, TrainHParams(), mesh, rules),
            in_shardings=(ssh, bsh(rules, ab)), out_shardings=(ssh, None),
            donate_argnums=0)
out["train"] = f.lower(astate, ab).compile().memory_analysis(
    ).argument_size_in_bytes

shape = ShapeSpec("d", 64, 8, "decode")
rules = make_rules(mesh, "decode", 8)
aparams = abstract_params(decls, jnp.dtype(cfg.param_dtype))
psh = sanitized_shardings(mesh, param_pspecs(decls, rules), aparams,
                          tp_fallback_axis="model")
ab = input_specs(cfg, shape)
acaches = abstract_caches(cfg, 8, 64)
csh = sanitized_shardings(mesh, cache_pspecs(cfg, rules), acaches)
pos = jax.ShapeDtypeStruct((8,), jnp.int32)
pos_sh = NamedSharding(mesh, sanitize_spec(
    mesh, PartitionSpec(rules.get("batch")), pos.shape))
state_sh = {"caches": csh, "pos": pos_sh}
f = jax.jit(make_decode_fn(cfg, mesh=mesh, rules=rules),
            in_shardings=(psh, bsh(rules, ab), state_sh),
            out_shardings=(None, state_sh), donate_argnums=2)
out["decode"] = f.lower(aparams, ab, {"caches": acaches, "pos": pos}
                        ).compile().memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


def test_argument_bytes_per_device_equal_xla_s():
    """qwen2.5-3b reduced on a (2, 4) mesh, a train step (B 8 × 64) and
    a decode step (B 8, cache 64): the bytes a slot holds before the
    step (state and batch) are the compiled reference's per-device
    argument bytes (8 forced host devices, in a subprocess)."""
    want = json.loads(run_py(_REF_ARGUMENT_BYTES, devices=8,
                             timeout=300).strip().splitlines()[-1])
    cfg = get_config("qwen2.5-3b").reduced()
    for kind in ("train", "decode"):
        r = dryrun.run_cell("qwen2.5-3b", ShapeSpec(kind[0], 64, 8, kind),
                            out_dir=None, mesh_shape=(2, 4), cfg=cfg)
        assert r["mem_argument_bytes"] == want[kind] > 0, kind


def test_launcher_writes_a_cell(tmp_path, capsys):
    """``--arch --shape --set`` through `main`: one JSON with the
    reference's keys (``hlo_*`` renamed ``op_*``) and the port's, the
    printed lines carrying the card they price against."""
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                 "--set", "n_layers=1", "--out", str(tmp_path),
                 "--save-ops"])
    out = capsys.readouterr().out
    assert "[dryrun] OK   mamba2-370m × decode_32k × 1-pod(256)" in out
    assert out.count(dryrun.CARD) == 2
    r = json.loads((tmp_path / "mamba2-370m__decode_32k__pod1.json")
                   .read_text())
    for key in ("arch", "shape", "kind", "multi_pod", "n_devices", "seq_len",
                "global_batch", "tag", "n_params", "n_active_params",
                "model_flops_total", "model_flops_per_dev",
                "op_flops_per_dev", "op_hbm_bytes_per_dev",
                "collective_bytes_per_dev", "collectives",
                "collective_counts", "hbm_by_op", "mem_argument_bytes",
                "mem_temp_bytes", "mem_per_device_bytes", "fits_hbm",
                "compute_term_s", "memory_term_s", "collective_term_s",
                "dominant", "useful_flops_ratio", "ops_per_dev",
                "kernel_bytes_per_dev", "mem_one_device_bytes"):
        assert key in r, key
    assert not any(k.startswith("hlo_") or k == "xla_flops_per_dev"
                   for k in r)
    assert (r["n_devices"], r["mesh"]) == (256, {"data": 16, "model": 16})
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["ops_per_dev"] > 0 and r["op_flops_per_dev"] > 0
    ops = json.loads((tmp_path / "mamba2-370m__decode_32k__pod1.ops.json")
                     .read_text())
    assert ops["slot"]["mm"] > 0
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-3b"])
