"""The dry run's per-device FLOPs on a (2, 2) mesh against what XLA's
partitioner makes of `repro`: for reduced qwen2.5-3b, starcoder2-3b and
gemma2-27b (4 heads and 2 kv heads, d_ff 256 and vocab 512: every dense
product splits 2 ways), and mixtral-8x22b, deepseek-v3-671b (2 MoE
groups, the data size), recurrentgemma-2b and mamba2-370m, `repro`'s
sharded train step (B 8 × 64), prefill (B 8 × 64) and decode step (B 8,
cache 64) are compiled on 4 forced host devices (in a subprocess:
`jax.jit` with the dry run's ``in_shardings``) and `analyze_hlo` reads
each device's dot FLOPs from the partitioned program.  The port's
`run_cell` on (2, 2) ``meta`` slots charges a device with its (data,
model) slot's products and the data slot's replicated ones.

For the dense archs the two are equal: XLA splits every dot over
``model`` as the port's product rule does.  For the four others they
are equal but for what XLA's partitioner does otherwise, which
`_xla_gap` states term by term (port − XLA; each within 2% of XLA's
figure but the two `ABOVE_2_PCT` names):

  * train: the weight gradient of a weight replicated over ``model``
    (the MoE router, MLA's ``wq_a``/``wkv_a``, recurrentgemma's single
    kv head's ``wk``/``wv``) XLA splits over ``model`` along d_model;
    the port computes it whole on each data slot;
  * prefill: the MoE router, which the fallback cuts over d_model, XLA
    gathers (4 KiB) and computes whole; the port computes it
    row-parallel, as the rule says;
  * mamba2's SSD: XLA splits the chunks' C·Bᵀ over the state dim N and
    all-reduces it; the port has B and C whole on each model slot and
    computes it there (an all-reduce of (B, Q, Q) a chunk would cost the
    card more than the product), with the backward terms
    `tests/test_torch_dryrun_train.py` names at the slot's heads;
  * decode: recurrentgemma's attention (1 kv head, its ring cut over
    ``model``) XLA attends over the whole ring on every device; the
    port attends each device's piece.
"""
import json

import pytest

from _subproc import run_py
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.nn import stage_plan
from repro_torch.nn.attention import cache_size

DENSE = ["qwen2.5-3b", "starcoder2-3b", "gemma2-27b"]
ARCHS = DENSE + ["mixtral-8x22b", "deepseek-v3-671b", "recurrentgemma-2b",
                 "mamba2-370m"]
KINDS = ("train", "prefill", "decode")
B, S = 8, 64
M = D = 2  # the mesh's model and data sizes

_REF = """
import dataclasses
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
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=2)
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


def _layers(cfg, pred) -> int:
    return sum(st.repeat * sum(map(pred, st.metas)) for st in stage_plan(cfg))


def _xla_gap(cfg, kind) -> dict:
    """Port − XLA per device on (2, 2), term by term (module notes)."""
    b = B // D  # a data slot's rows
    t = b * S if kind != "decode" else b  # its tokens
    d = cfg.d_model
    n_moe = _layers(cfg, lambda m: m.ffn == "moe")
    n_mla = _layers(cfg, lambda m: m.mixer == "mla")
    n_attn = _layers(cfg, lambda m: m.mixer == "attn")
    n_ssd = _layers(cfg, lambda m: m.mixer == "ssd")
    mqa = cfg.n_kv_heads % M if n_attn else 0
    half = (M - 1) / M
    gap = {}
    if kind == "train":  # dW = xᵀ·dy of weights replicated over model
        outs = (n_moe * [cfg.n_experts]
                + n_mla * [cfg.q_lora_rank, cfg.kv_lora_rank
                           + cfg.qk_rope_dim]
                + (2 * n_attn * [cfg.n_kv_heads * cfg.head_dim_] if mqa
                   else []))
        gap["replicated_dw"] = sum(2 * t * d * o * half for o in outs)
    if kind == "prefill":  # the router: XLA's whole, the port's row cut
        gap["router"] = -n_moe * 2 * t * d * cfg.n_experts * half
    if n_ssd and kind != "decode":
        q = min(cfg.ssm_chunk, S)
        while S % q:
            q -= 1
        cb = 2 * b * q * q * cfg.ssm_state  # C·Bᵀ of a chunk
        per = cb * half if kind == "prefill" else (
            3 * cb * half - cb / M
            - 2 * (2 * b * q * cfg.ssm_heads // M * cfg.ssm_head_dim))
        gap["ssd_cb"] = n_ssd * (S // q) * per
    if kind == "decode" and mqa:  # q·k and a·v over the ring's other part
        w = cache_size(S, cfg.window_pattern[0])
        gap["mqa_ring"] = -n_attn * 2 * (2 * b * cfg.n_heads * cfg.head_dim_
                                         * w) * half
    return {k: int(v) for k, v in gap.items() if v}


# the two terms above 2% of XLA's figure at this size: mamba2's prefill
# C·Bᵀ (+2.7%: 2 layers × half of a 1 MFLOP product, in a 39 MFLOP
# prefill) and recurrentgemma's decode ring (−2.1%: XLA attends the
# whole ring of 64 on each device, the port half of it); each is kept,
# the port's way being the cheaper one on the card
ABOVE_2_PCT = {("mamba2-370m", "prefill", "ssd_cb"),
               ("recurrentgemma-2b", "decode", "mqa_ring")}


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_dot_flops_equal_the_partitioned_reference(arch,
                                                              ref_flops):
    cfg = get_config(arch).reduced()
    for kind in KINDS:
        r = run_cell(arch, ShapeSpec(kind[0], S, B, kind), out_dir=None,
                     mesh_shape=(2, 2), cfg=cfg)
        want = ref_flops[arch][kind]
        gap = _xla_gap(cfg, kind)
        assert r["op_flops_per_dev"] == want + sum(gap.values()) > 0, kind
        for term, v in gap.items():
            assert ((arch, kind, term) in ABOVE_2_PCT) == (
                abs(v) > 0.02 * want), (kind, term)
        if arch in DENSE:
            assert not gap
            # every product splits 2 ways: a device computes half its
            # slot's
            assert 2 * r["op_flops_per_dev"] == r["op_flops_per_data_slot"]
        else:  # most of it splits: the replicated remainder is small
            assert r["op_flops_per_dev"] < 0.55 * r["op_flops_per_data_slot"]
