"""`run_cell` end to end on the production meshes of ``meta`` slots —
(16, 16) and (2, 16, 16) — at the cells' own shapes, every arch with its
depth cut by ``--set``-style overrides (one repeat of its block pattern,
after DeepSeek's dense layers).

Each arch runs its decode_32k cell on both meshes and its prefill_32k
cell on one pod; long_500k runs for one arch, train_4k for two.  The
other cells cost host time without new paths: recurrentgemma-2b's
prefill and train walk an RG-LRU scan step by step (32,768 and 4,096
steps a layer, about 40 s each), and a train cell traces the optimizer
over all 256 pieces of every leaf (5–40 s); `launch.dryrun --all` runs
them all."""
import dataclasses
import json
import math

import pytest

from repro_torch.configs import SHAPES, all_configs, cells_for, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.nn import model_decls

CASES = ([(a, "decode_32k", mp) for a in sorted(all_configs())
          for mp in (False, True)]
         + [(a, "prefill_32k", False) for a in sorted(all_configs())
            if a != "recurrentgemma-2b"]
         + [("mamba2-370m", "long_500k", False),
            ("mamba2-370m", "train_4k", False),
            ("qwen2.5-3b", "train_4k", True)])


def _depth(arch) -> int:
    cfg = get_config(arch)
    return len(cfg.block_pattern) + cfg.first_dense_layers


@pytest.mark.parametrize("arch,shape,multi_pod", CASES)
def test_run_cell_on_the_production_mesh(arch, shape, multi_pod, tmp_path):
    assert shape in cells_for(arch)
    cfg = dataclasses.replace(get_config(arch), n_layers=_depth(arch))
    r = run_cell(arch, shape, multi_pod, str(tmp_path), cfg=cfg)
    stem = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}.json"
    assert json.loads((tmp_path / stem).read_text()) == r
    n_dev = 512 if multi_pod else 256
    spec = SHAPES[shape]
    d = 1 if spec.global_batch < (32 if multi_pod else 16) else \
        (32 if multi_pod else 16)
    assert (r["n_devices"], r["n_data_slots"]) == (n_dev, d)
    assert r["traced"] == ("all slots" if d == 1 else "one data slot")
    assert r["op_flops_per_dev"] > 0 and r["ops_per_dev"] > 0
    # the data slots compute the same; a train step's update adds no
    # FLOPs; a device computes its (data, model) slot's part of its data
    # slot's: the split products' share and the replicated ones whole
    assert r["op_flops_total"] == d * r["op_flops_per_data_slot"]
    assert r["op_flops_per_dev"] <= r["op_flops_per_data_slot"]
    assert r["n_model_slots"] == 16
    assert r["mem_per_device_bytes"] == (r["mem_argument_bytes"]
                                         + r["mem_temp_bytes"])
    assert r["fits_hbm"] == (r["mem_per_device_bytes"] <= HBM_BYTES)
    terms = {k: r[f"{k}_term_s"] for k in ("compute", "memory",
                                           "collective")}
    assert r["dominant"] == max(terms, key=terms.get)
    # each slot all-gathers (its model block of a weight over the data
    # axes or a norm's scale) and a device's FLOPs are at least the
    # model's share less the embedding lookup's: 2·N·D counts an untied
    # table's parameters, whose lookup computes no product (every other
    # product is split over ``model`` or repeated on each device)
    assert r["collective_counts"]["all-gather"] > 0
    emb = model_decls(cfg).get("embed")
    table = 0 if cfg.tie_embeddings or emb is None else math.prod(
        emb["table"].shape)
    assert r["op_flops_per_dev"] >= r["model_flops_per_dev"] * (
        1 - table / r["n_active_params"])
