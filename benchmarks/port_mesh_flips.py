#!/usr/bin/env python3
"""bf16 on a mesh of the card's slots against one device: where the
update direction of `chip_smoke.py`'s full-width block cells parts.

    python3 benchmarks/port_mesh_flips.py --arch mamba2-370m --meshes 2x1 1x4 2x4
    python3 benchmarks/port_mesh_flips.py --ssd-forward [--device cpu]

``--arch``: one of `chip_smoke.MESH_BLOCK_CELLS` at its cut depth, two
bf16 train steps unsharded and on each (data, model) mesh of ``cuda:0``
slots from the same init (`chip_smoke._train_pair`): the share of
elements whose step-1 update direction differs from the unsharded
run's, the worst leaves, the loss and grad norm gaps, and for an MoE
the share of routed slots sent to other experts.  A (d, 1) mesh is data
parallelism alone, a (1, m) one tensor parallelism alone.

``--ssd-forward``: one mamba2-370m SSD mixer at its published widths,
bf16, B 16 × 256, on (1, 4) slots against the same mixer unsharded: the
share of its output's elements that differ, and the same for a bare
row-parallel ``out_proj`` on identical inputs.

Prints one JSON object a line, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]


def flips(arch: str, meshes, dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import make_mesh
    from repro_torch.nn import model_decls

    cfg = dataclasses.replace(get_config(arch), **cs.MESH_BLOCK_CELLS[arch])
    decls = model_decls(cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, cs.TRAIN_BATCH,
                                    cs.TRAIN_SEQ, kind="markov"))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.global_batch_at(0).items()}
    cs.MESH_WORST_LEAVES = 12
    for shape in meshes:
        mesh = make_mesh(shape, ("data", "model"),
                         devices=[dev] * (shape[0] * shape[1]))
        r = cs._train_pair(cfg, decls, dev, mesh, batch)
        f = r["step1_update_sign_flips"]
        print(json.dumps({"arch": arch, "mesh": shape, "flipped_share":
                          f["share"], "worst_leaves": f["worst_leaves"],
                          "loss_rel": r["loss_rel_by_step"],
                          "grad_norm_rel": r["grad_norm_rel_by_step"],
                          "routed_slots_rerouted":
                          r["routed_slots_rerouted_step0"]}), flush=True)


def ssd_forward(dev) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import (device_put, make_mesh, make_rules,
                                         sanitized_shardings)
    from repro_torch.distributed.sharding import PartitionSpec
    from repro_torch.nn import flatten_tree, init_params, model_decls
    from repro_torch.nn import param_pspecs, ssd
    from repro_torch.nn.common import ShardCtx, Split, cast, tp_product

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=1)
    decls = model_decls(cfg)
    mesh = make_mesh((1, 4), ("data", "model"), devices=[dev] * 4)
    rules = make_rules(mesh, "train")

    def mixer(tree):  # the first layer's mixer leaves, its layer axis off
        return {k.split("mixer/")[1]: v for k, v in flatten_tree(tree).items()
                if "mixer/" in k}

    p = {k: v[0] for k, v in mixer(init_params(
        decls, torch.Generator(device=dev).manual_seed(0), device=dev)).items()}
    specs = {k: PartitionSpec(*list(v)[1:])
             for k, v in mixer(param_pspecs(decls, rules)).items()}
    placed = device_put(p, sanitized_shardings(mesh, specs, p))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((16, 256, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(256, device=dev)[None].expand(16, 256)
    ctx = ShardCtx(positions=pos, compute_dtype=torch.bfloat16, rules=rules,
                   mesh=mesh, device=dev, rows=(0, 16))
    with torch.no_grad():
        want, _ = ssd.ssd_apply(p, x, ShardCtx(
            positions=pos, compute_dtype=torch.bfloat16), cfg, None)
        got, _ = ssd.ssd_apply(placed, x, ctx, cfg, None)
        h = torch.randn((16, 256, cfg.ssm_heads * cfg.ssm_head_dim),
                        generator=g, device=dev).to(torch.bfloat16)
        whole = h @ cast(p["out_proj"], h.dtype)
        rows = ctx.whole(tp_product(Split(list(h.chunk(4, -1)), 2),
                                    placed["out_proj"], ctx))

    def gap(a, b):
        return {"unequal_share": float((a != b).float().mean()),
                "rel": float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())}

    print(json.dumps({"ssd_mixer_1x4_vs_unsharded": gap(got, want),
                      "row_parallel_out_proj_vs_whole": gap(rows, whole)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--meshes", nargs="*", default=["2x1", "1x4", "2x4"])
    ap.add_argument("--ssd-forward", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    if dev.type == "cuda":
        print(cs.nvidia_smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.arch:
        flips(args.arch, [tuple(int(v) for v in m.split("x"))
                          for m in args.meshes], dev)
    if args.ssd_forward:
        ssd_forward(dev)


if __name__ == "__main__":
    main()
