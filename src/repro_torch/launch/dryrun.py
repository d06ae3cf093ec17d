"""Multi-pod dry run of the port: build every (architecture × input
shape × mesh) cell on the production mesh of ``meta`` slots, run its
step shape-only, and price it against the H100's constants.

The counterpart of `repro.launch.dryrun`, which lowers and compiles each
cell with XLA and reads its HLO: here the cell's train step, prefill or
decode runs eagerly on ``meta`` tensors under `roofline.OpCounter`, which
counts the aten operations it dispatches (FLOPs, fusion-optimistic HBM
bytes, the eager port's ops, kernel bytes and live memory) and the
placement layer's collectives.  No card is needed and no environment
variable is set.  One JSON per cell lands in ``benchmarks/out/dryrun_torch/``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Every data slot runs the same shapes, so a cell traces **one** data slot
(the mesh with its batch axes cut to one slot, the slot's rows of the
batch, the MoE groups the slot dispatches) and charges it to each slot;
the train step's second part (the clip and the optimizer, over every
piece of the mesh) is traced once.  ``all_slots=True`` also traces the
step as it runs on one device with every slot (`chip_smoke.py`'s mesh
phase): its totals and ``mem_one_device_bytes``.

A data slot's work is split over its model slots (every mixer's and
FFN's products, the embedding and the head: `nn.common.tp_product`; the
ring pieces of a decode cache; the recurrent states' pieces): each op
is counted under the device slot that issues it, and a device is
charged with what its (data, model) slot computes — the data slot's
untagged work (the MoE routing, MLA's latent projections, the products
of weights replicated over ``model``), which the reference repeats on
every device of the model group, and its own model slot's part
(`OpCounter.device_cost`).  A step-by-step loop whose iterations all
have one shape (the RG-LRU scan) is walked once on ``meta`` tensors and
counted for every iteration (`distributed.placement.repeated`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import SHAPES, ShapeSpec, all_configs, cells_for, get_config
from ..configs import input_specs
from ..distributed.placement import device_put, placed_bytes
from ..distributed.sharding import (PartitionSpec, batch_axes,
                                    batch_shardings, data_size, make_mesh,
                                    make_rules, sanitized_shardings)
from ..nn.common import (abstract_params, count_active_params, count_params,
                         param_pspecs)
from ..nn.model import model_decls
from ..roofline.op_analysis import CompCost, OpCounter
from ..serving.engine import (abstract_caches, cache_pspecs, make_decode_fn,
                              make_prefill_fn)
from ..training.train_step import (TrainHParams, grad_buffers, make_grad_fn,
                                   make_update_fn, train_state_init,
                                   train_state_pspecs)
from .mesh import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                   make_production_mesh)

__all__ = ["CARD", "Cell", "build_cell", "main", "model_flops", "run_cell",
           "trace_cell"]

CARD = "NVIDIA H100 80GB HBM3 SXM, 700 W (data sheet)"

OUT_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "benchmarks", "out", "dryrun_torch")

_META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    """One cell: its config (MoE groups set to the data size, overrides
    applied), declarations, mesh of ``meta`` slots, rules, shape and
    batch (``meta`` tensors of the global batch)."""

    shape: ShapeSpec
    cfg: object
    decls: dict
    mesh: object
    rules: dict
    batch: dict

    @property
    def n_data(self) -> int:
        """The data slots the rules split the batch over."""
        return math.prod(self.mesh.shape[a] for a in batch_axes(self.rules))


def _meta_mesh(shape, names):
    return make_mesh(shape, names, [_META] * math.prod(shape))


def build_cell(arch: str, shape, multi_pod: bool = False, mesh_shape=None,
               cfg=None) -> Cell:
    """The cell of ``arch`` at ``shape`` (a `SHAPES` name or a
    `ShapeSpec`) on the production mesh (``mesh_shape``: a (data, model)
    mesh of that shape instead), its batch `input_specs`'; ``cfg``: a
    config in place of the registry's (``reduced()``, or with ``--set``'s
    overrides)."""
    if mesh_shape is not None:
        mesh = _meta_mesh(tuple(mesh_shape), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch) if cfg is None else cfg
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=data_size(mesh))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rules = make_rules(mesh, shape.kind, shape.global_batch)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device=_META)
             for k, v in input_specs(cfg, shape).items()}
    return Cell(shape, cfg, model_decls(cfg), mesh, rules, batch)


def model_flops(cfg, decls, shape) -> float:
    """6·N·D (train) / 2·N·D (forward), N = active params."""
    n_act = count_active_params(decls, cfg.experts_per_token, cfg.n_experts)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # decode: one token per row


# ---------------------------------------------------------------------------
# tracing a cell
# ---------------------------------------------------------------------------


def _one_slot(cell: Cell):
    """(mesh, cfg, batch) of one data slot: the mesh with the batch axes
    cut to one slot, the config whose MoE groups are the slot's share,
    the slot's rows of the batch."""
    d = cell.n_data
    mesh = cell.mesh
    if d == 1:
        return mesh, cell.cfg, cell.batch
    axes = batch_axes(cell.rules)
    shape = tuple(1 if a in axes else n for a, n in mesh.shape.items())
    cfg = cell.cfg
    if cfg.n_experts:
        if cfg.moe_groups % d:
            raise ValueError(f"{cfg.name}: {cfg.moe_groups} MoE groups do "
                             f"not split over {d} data slots")
        cfg = dataclasses.replace(cfg, moe_groups=cfg.moe_groups // d)
    rows = next(iter(cell.batch.values())).shape[0] // d
    return _meta_mesh(shape, mesh.axis_names), cfg, {
        k: v[:rows] for k, v in cell.batch.items()}


def _placed(tree, mesh, pspecs, **kw):
    return device_put(tree, sanitized_shardings(mesh, pspecs, tree, **kw))


def _batch(cell: Cell, mesh, batch):
    return device_put(batch, batch_shardings(mesh, cell.rules, batch))


def _traced(cell: Cell, all_slots: bool):
    """(mesh, cfg, placed batch) the trace runs — the cell's, or one data
    slot's (`_one_slot`) — and the whole batch placed on the cell's
    mesh."""
    whole = _batch(cell, cell.mesh, cell.batch)
    if all_slots:
        return cell.mesh, cell.cfg, whole, whole
    mesh, cfg, batch = _one_slot(cell)
    return mesh, cfg, _batch(cell, mesh, batch), whole


def _trace_train(cell: Cell, hp, all_slots: bool) -> dict:
    # the state `train_state_init(init_params(decls))` holds: the
    # declarations' dtypes, not ``cfg.param_dtype`` (which the reference's
    # abstract state, and `abstract_train_state`, declare)
    state = _placed(train_state_init(abstract_params(cell.decls), cell.cfg),
                    cell.mesh,
                    train_state_pspecs(cell.cfg, cell.decls, cell.rules))
    mesh, cfg, batch, whole = _traced(cell, all_slots)
    grad_fn = make_grad_fn(cfg, hp, mesh, cell.rules)
    update = make_update_fn(cell.cfg, hp)
    with OpCounter("slot" if all_slots else "alloc") as oc:
        if not all_slots:
            # the grad part first zeroes the gradient of every piece of
            # the mesh: counted alone, so that it is charged once
            grad_buffers(state["params"], hp)
            oc.phase("slot")
        loss, metrics, grads = grad_fn(state["params"], batch)
        oc.phase("update")
        update(state, loss, metrics, grads)
    return {"oc": oc, "held": placed_bytes({"state": state, "batch": whole}),
            "made": placed_bytes(grads)}


def _trace_serve(cell: Cell, all_slots: bool) -> dict:
    params = _placed(abstract_params(cell.decls), cell.mesh,
                     param_pspecs(cell.decls, cell.rules),
                     tp_fallback_axis="model")
    b, s = cell.shape.global_batch, cell.shape.seq_len
    mesh, cfg, batch, whole = _traced(cell, all_slots)
    if cell.shape.kind == "prefill":
        fn = make_prefill_fn(cfg, cache_len=s, mesh=mesh, rules=cell.rules)
        with OpCounter("slot") as oc:
            fn(params, batch)
        held = placed_bytes({"params": params, "batch": whole})
        return {"oc": oc, "held": held, "made": None}
    # decode: the whole state placed on the cell's mesh (a slot's pieces
    # count in its memory), the traced slot's rows on the traced mesh
    def state(rows, on):
        pos = torch.empty((rows,), dtype=torch.int32, device=_META)
        return _placed({"caches": abstract_caches(cfg, rows, s), "pos": pos},
                       on, {"caches": cache_pspecs(cfg, cell.rules),
                            "pos": PartitionSpec(cell.rules.get("batch"))})

    full = state(b, cell.mesh)
    traced = full if mesh is cell.mesh else state(
        next(iter(batch.values())).shape[0], mesh)
    fn = make_decode_fn(cfg, mesh=mesh, rules=cell.rules)
    with OpCounter("slot") as oc:
        fn(params, batch, traced)
    held = placed_bytes({"params": params, "state": full, "batch": whole})
    return {"oc": oc, "held": held, "made": None}


def trace_cell(cell: Cell, hp: TrainHParams | None = None,
               all_slots: bool = False) -> dict:
    """Trace ``cell``'s step: ``{"oc": the OpCounter (phases "slot" and,
    for a train step, "alloc" (one slot) and "update"), "state":
    placed_bytes of what the mesh holds before the step, "made":
    placed_bytes of the gradients the step allocates (train) or None,
    "all_slots": whether every data slot was traced}``; one data slot
    unless ``all_slots``."""
    if cell.shape.kind == "train":
        tr = _trace_train(cell, hp or TrainHParams(), all_slots)
    else:
        tr = _trace_serve(cell, all_slots)
    tr["all_slots"] = all_slots or cell.n_data == 1
    return tr


def slot_cost(oc: OpCounter, device: bool = False) -> CompCost:
    """A one-slot trace's data slot alone: its "slot" phase less the
    mesh-wide gradient zeroing ("alloc"); ``device``: the busiest device
    of the slot's model group alone (`OpCounter.device_cost`)."""
    slot = oc.device_cost("slot") if device else oc.costs["slot"]
    out = _share(slot, 1.0)
    if "alloc" in oc.costs:
        out.add(oc.costs["alloc"], -1.0)
    out.peak_live_bytes = slot.peak_live_bytes
    return out


def mesh_cost(tr: dict, n_data: int) -> CompCost:
    """The whole mesh's step from `trace_cell`'s ``tr``: an all-slot
    trace's phases, or a one-slot trace's slot × ``n_data`` plus its
    mesh-wide phases once."""
    oc = tr["oc"]
    if tr["all_slots"]:
        return oc.total()
    out = _share(slot_cost(oc), float(n_data))
    out.add(_share(oc.costs.get("alloc"), 1.0))
    out.add(_share(oc.costs.get("update"), 1.0))
    return out


# ---------------------------------------------------------------------------
# the roofline of a cell
# ---------------------------------------------------------------------------


def _share(cost: CompCost | None, f: float) -> CompCost:
    out = CompCost()
    if cost is not None:
        out.add(cost, f)
    return out


def _pending(tr: dict, n_data: int) -> dict:
    """The gradient a one-slot trace cannot see: the port runs one
    backward over every data slot, so a slot's reduce-scattered gradient
    waits in the input buffer of the piece's leaf until every slot's has
    arrived — up to the gradient pieces once more (``placed_bytes``:
    total and per slot; none for one data slot or serving)."""
    if tr["all_slots"] or n_data == 1 or not tr["made"]:
        return {"total": 0, "per_slot": [0]}
    return tr["made"]


def _per_device(tr: dict, n_data: int) -> tuple[CompCost, int, int, int]:
    """(the busiest slot's cost, its memory, its argument bytes, its
    temporaries) from a one-slot trace: the busiest device's part of
    the data slot (`slot_cost` with ``device``), the
    mesh-wide parts (the gradient zeroing, the update) in the share of
    the mesh's pieces the slot holds.  The arguments are what the slot
    holds before the step (state and batch), the temporaries the trace's
    peak above them, the gradient counted at the slot's pieces, with its
    pending copy (`_pending`) during the backward."""
    oc = tr["oc"]
    per = tr["held"]["per_slot"] or [0]
    share = max(per) / max(sum(per), 1)
    made = tr["made"] or {"total": 0, "per_slot": [0]}
    upd = oc.costs.get("update")
    cost = slot_cost(oc, device=True)
    peak = cost.peak_live_bytes
    cost.add(_share(upd, share))
    cost.add(_share(oc.costs.get("alloc"), share))
    temps = max(peak - made["total"]
                + max(_pending(tr, n_data)["per_slot"] or [0]),
                int((upd.peak_live_bytes if upd else 0) * share))
    temps += max(made["per_slot"] or [0])
    args = max(per)
    return cost, args + temps, args, temps


def _one_device_bytes(tr: dict, n_data: int) -> int:
    """Every slot of the mesh on one device: what the mesh holds (each
    distinct piece once) and the step's peak live bytes (from a one-slot
    trace: every slot's temporaries added and the pending gradient
    (`_pending`), an upper bound)."""
    oc = tr["oc"]
    held = tr["held"]["total"]
    if tr["all_slots"]:
        return held + oc.total().peak_live_bytes
    made = tr["made"]["total"] if tr["made"] else 0
    slot = oc.costs["slot"].peak_live_bytes - made
    upd = oc.costs.get("update")
    return held + made + max(n_data * slot + _pending(tr, n_data)["total"],
                             upd.peak_live_bytes if upd else 0)


def _raw(cost: CompCost) -> dict:
    return {k: {f: int(v) for f, v in r.items()}
            for k, r in sorted(cost.coll_raw.items())}


def run_cell(arch: str, shape, multi_pod: bool = False,
             out_dir: str | None = OUT_DEFAULT, save_ops: bool = False,
             tag: str = "baseline", mesh_shape=None,
             hp: TrainHParams | None = None, all_slots: bool = False,
             cfg=None) -> dict:
    """Build, trace and price one cell; writes its JSON into ``out_dir``
    (None: nowhere) and returns it.  ``all_slots``: trace the whole mesh
    as one device runs it as well (the totals ``*_total`` and
    ``mem_one_device_bytes`` from it; ``mem_one_device_bytes_one_slot``
    is the one-slot trace's upper bound on the latter, the trace every
    per-device figure comes from)."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, multi_pod, mesh_shape, cfg)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = trace_cell(cell, hp)
    t_trace = time.perf_counter() - t0
    n_data = cell.n_data
    traced_all = tr["all_slots"]
    whole, t_all = (tr if traced_all else None), 0.0
    if all_slots and not traced_all:
        t0 = time.perf_counter()
        whole = trace_cell(cell, hp, all_slots=True)
        t_all = time.perf_counter() - t0
    dev, mem_dev, mem_args, mem_temp = _per_device(tr, n_data)
    total = mesh_cost(whole or tr, n_data)
    mem_one = _one_device_bytes(whole or tr, n_data)

    shp = cell.shape
    n_dev = cell.mesh.size
    mf = model_flops(cell.cfg, cell.decls, shp)
    compute_s = dev.flops / PEAK_FLOPS_BF16
    memory_s = dev.hbm_bytes / HBM_BW
    coll_s = dev.total_coll_bytes / NVLINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    shape_name = shp.name
    result = dict(
        arch=arch, shape=shape_name, kind=shp.kind, multi_pod=multi_pod,
        n_devices=n_dev, seq_len=shp.seq_len, global_batch=shp.global_batch,
        mesh=dict(cell.mesh.shape), n_data_slots=n_data,
        n_model_slots=cell.mesh.shape.get("model", 1),
        traced="all slots" if traced_all else "one data slot",
        tag=tag, card=CARD,
        build_s=t_build, trace_s=t_trace, trace_all_slots_s=t_all,
        n_params=count_params(cell.decls),
        n_active_params=count_active_params(
            cell.decls, cell.cfg.experts_per_token, cell.cfg.n_experts),
        model_flops_total=mf,
        model_flops_per_dev=mf / n_dev,
        op_flops_per_dev=dev.flops,
        op_flops_per_data_slot=slot_cost(tr["oc"]).flops,
        op_hbm_bytes_per_dev=dev.hbm_bytes,
        collective_bytes_per_dev=dev.total_coll_bytes,
        collectives=dev.coll_bytes,
        collective_counts=dev.coll_counts,
        hbm_by_op=dict(sorted(dev.hbm_by_op.items(),
                              key=lambda kv: -kv[1])[:12]),
        ops_per_dev=dev.ops,
        kernel_bytes_per_dev=dev.kernel_bytes,
        mem_argument_bytes=mem_args,
        mem_temp_bytes=mem_temp,
        mem_per_device_bytes=mem_dev,
        mem_one_device_bytes=mem_one,
        mem_one_device_bytes_one_slot=_one_device_bytes(tr, n_data),
        fits_hbm=bool(mem_dev <= HBM_BYTES),
        compute_term_s=compute_s,
        memory_term_s=memory_s,
        collective_term_s=coll_s,
        dominant=dominant,
        useful_flops_ratio=(mf / n_dev) / dev.flops if dev.flops else 0.0,
        op_flops_total=total.flops,
        op_hbm_bytes_total=total.hbm_bytes,
        ops_total=total.ops,
        kernel_bytes_total=total.kernel_bytes,
        collective_bytes_total=total.total_coll_bytes,
        collective_raw_total=_raw(total),
        totals_from="an all-slot trace" if whole else
        "one slot × the data slots + the update",
    )
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        stem = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
        if mesh_shape is not None:
            stem = f"{arch}__{shape_name}__{'x'.join(map(str, mesh_shape))}"
        if tag != "baseline":
            stem += f"__{tag}"
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(result, f, indent=1)
        if save_ops:
            table = {ph: dict(c.ops_by_name.most_common())
                     for ph, c in tr["oc"].costs.items()}
            with open(os.path.join(out_dir, stem + ".ops.json"), "w") as f:
                json.dump(table, f, indent=1)
    return result


def summary_lines(r: dict) -> list[str]:
    """The two lines `main` prints for a cell."""
    return [
        f"mem/dev {r['mem_per_device_bytes'] / 2**30:.2f} GiB of "
        f"{HBM_BYTES / 2**30:.2f} (fits={r['fits_hbm']}), "
        f"dominant={r['dominant']}, host {r['trace_s']:.1f} s [{CARD}]",
        f"terms: compute {r['compute_term_s']:.4f} s | memory "
        f"{r['memory_term_s']:.4f} s | collective "
        f"{r['collective_term_s']:.4f} s | useful-flops "
        f"{r['useful_flops_ratio']:.3f} [{CARD}]"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape × mesh) cell")
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--save-ops", "--save-hlo", dest="save_ops",
                    action="store_true",
                    help="also write the cell's op table (aten op → count)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=int, e.g. --set n_layers=2")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = int(v)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in all_configs():
            for shape in cells_for(arch):
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in cells:
        label = f"{arch} × {shape} × {'2-pod(512)' if mp else '1-pod(256)'}"
        try:
            cfg = dataclasses.replace(get_config(arch), **overrides)
            r = run_cell(arch, shape, mp, args.out, args.save_ops, args.tag,
                         cfg=cfg)
            first, terms = summary_lines(r)
            print(f"[dryrun] OK   {label}: {first}", flush=True)
            print(f"         {terms}", flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[dryrun] FAIL {label}: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
