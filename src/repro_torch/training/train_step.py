"""The train step of the port: microbatched grads → clip → optimizer.

`repro.training.train_step` in PyTorch, unsharded or on a mesh of
device slots (below).  The gradient is `torch.autograd`'s backward of
`loss_fn`; gradient accumulation is a Python loop over ``grad_accum`` microbatches
(the reference's `lax.scan`), summed and scaled by ``1/grad_accum`` as
there.  The state is the reference's tree, ``{"params", "opt", "step"}``
with ``step`` a 0-d int32 tensor, and the step updates its tensors in
place.

Each stacked ``(layers, …)`` parameter is cut into one leaf a repeat, a
view of its storage, whose ``.grad`` is preset to the matching slice of
the step's gradient buffer: backward writes every layer's gradient
straight into that buffer.  Slicing the stacked leaf inside the graph
(``p[r]``) would instead make autograd build a zero tensor the size of
the whole stack for every layer.

On a mesh (``make_train_step(cfg, hp, mesh, rules)``) the state is
placed by ``sanitized_shardings(mesh, train_state_pspecs(...))`` and the
batch by `batch_shardings`: every leaf a `ShardedTensor`.  The step is
data-parallel over the rules' batch axes: each data slot runs its rows
of every microbatch on its own device and its model slots (the
tensor-parallel products of `nn.common.tp_product`), each weight taken
in the block its slot computes with, gathered over the data axes (a
repeat unit's inside its remat region), and the slots' loss sums are
added on the first slot's device and divided by the global mask count
before one ``backward()`` over the whole multi-device graph; autograd
sums every slot's gradient into the pieces' preset ``.grad`` (the
reduce-scatter), and blocks replicated on several devices are then
summed across their copies.  Clip and optimizer update the pieces in
place.  No value is read on the host inside the step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.placement import (ShardedTensor, data_slots, rows_of,
                                     sync_replicas, zeros_placed)
from ..distributed.sharding import NamedSharding, PartitionSpec, make_rules
from ..nn.common import (ShardCtx, flatten_tree, map_tree, param_pspecs,
                         torch_dtype, unflatten_tree)
from ..nn.model import loss_from_parts, loss_parts, stage_plan
from .optimizer import OptHParams, clip_by_global_norm, make_optimizer

__all__ = ["TrainHParams", "abstract_train_state", "grad_buffers",
           "make_grad_fn", "make_positions", "make_train_step",
           "make_update_fn", "train_state_init", "train_state_pspecs"]

METRICS = ("xent", "zloss", "aux")


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: OptHParams = OptHParams()
    grad_accum: int = 1
    z_loss: float = 1e-4


def train_state_init(params, cfg) -> dict:
    """The state of ``params``: zero optimizer moments and step.  Placed
    parameters (`ShardedTensor` leaves) give a placed state: the moments
    as `train_state_pspecs` places them, the step replicated."""
    opt_init, _ = make_optimizer(cfg.optimizer)
    first = _first(params)
    if isinstance(first, ShardedTensor):
        step = zeros_placed(NamedSharding(first.mesh, PartitionSpec()), (),
                            torch.int32)
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"params": params, "opt": opt_init(params), "step": step}


def train_state_pspecs(cfg, decls, rules) -> dict:
    """PartitionSpec tree mirroring `abstract_train_state`: Adafactor's
    ``vr`` drops the leaf's last entry, ``vc`` its second last."""
    pspecs = param_pspecs(decls, rules)
    if cfg.optimizer == "adamw":
        opt = {"m": pspecs, "v": pspecs}
    else:
        def fac(s):
            entries = list(s)
            if len(entries) >= 2:
                return {"vr": PartitionSpec(*entries[:-1]),
                        "vc": PartitionSpec(*entries[:-2], entries[-1])}
            return {"v": s}

        opt = {"f": map_tree(fac, pspecs)}
    return {"params": pspecs, "opt": opt, "step": PartitionSpec()}


def abstract_train_state(cfg, decls) -> dict:
    """The train state as ``meta`` tensors (params in ``cfg.param_dtype``,
    float32 optimizer state): its shapes and dtypes without allocating
    the (possibly 671B-parameter) model."""
    pdt = torch_dtype(cfg.param_dtype)
    aparams = map_tree(lambda d: torch.empty(d.shape, dtype=pdt,
                                             device="meta"), decls)
    opt_init, _ = make_optimizer(cfg.optimizer)
    return {"params": aparams, "opt": opt_init(aparams),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def make_positions(batch) -> torch.Tensor:
    leaf = batch.get("tokens", batch.get("embeds"))
    b, s = leaf.shape[0], leaf.shape[1]
    return torch.arange(s, dtype=torch.int32,
                        device=leaf.device)[None].expand(b, s)


def _first(tree) -> torch.Tensor:
    return next(iter(flatten_tree(tree).values()))


def _leaf(p, b):
    """A fresh leaf over ``p``'s storage whose ``.grad`` is ``b``; on a
    mesh, a `ShardedTensor` of such leaves, one a piece."""
    if isinstance(p, ShardedTensor):
        return dataclasses.replace(
            p, pieces=[_leaf(t, g) for t, g in zip(p.pieces, b.pieces)])
    t = p.detach().requires_grad_(True)
    t.grad = b
    return t


def _layer_leaves(cfg, params, bufs):
    """The forward's tree of fresh leaves over ``params``' storage (a
    stage's entry: the list of its repeats' unit trees), each leaf's
    ``.grad`` preset to its slice of ``bufs``."""
    flat_p, flat_b = flatten_tree(params), flatten_tree(bufs)

    tree = unflatten_tree({k: _leaf(p, flat_b[k]) for k, p in flat_p.items()
                           if not k.startswith("stage")})
    for si, st in enumerate(stage_plan(cfg)):
        pre = f"stage{si}/"
        names = [k for k in flat_p if k.startswith(pre)]
        tree[f"stage{si}"] = [
            unflatten_tree({k[len(pre):]: _leaf(flat_p[k][r], flat_b[k][r])
                            for k in names})
            for r in range(st.repeat)]
    return tree


def _zeros(p, dtype):
    if isinstance(p, ShardedTensor):
        return p.map(lambda t: torch.zeros(t.shape, dtype=dtype,
                                           device=t.device))
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _pieces(x) -> list:
    return x.pieces if isinstance(x, ShardedTensor) else [x]


def grad_buffers(params, hp: TrainHParams) -> tuple:
    """(grads, bufs): the zeroed gradient tree a step fills (float32
    when it accumulates several microbatches, else the parameters'
    dtypes) and the tree backward writes into — ``grads``' own leaves
    where the dtypes agree, else a buffer of the parameter's dtype that
    is summed into ``grads``.  On a mesh, placed as the params are."""
    grads = map_tree(lambda p: _zeros(p, torch.float32 if hp.grad_accum > 1
                                       else p.dtype), params)
    bufs = unflatten_tree({
        k: g if g.dtype == p.dtype else _zeros(p, p.dtype)
        for (k, p), g in zip(flatten_tree(params).items(),
                             flatten_tree(grads).values())})
    return grads, bufs


def make_grad_fn(cfg, hp: TrainHParams, mesh=None, rules=None):
    """(params, batch) → (loss, metrics, grads): the loss and metrics of
    ``loss_fn`` (its z-loss weighted by ``hp.z_loss``; the reference's
    step fixes it at the default 1e-4) and its gradient, averaged over
    ``hp.grad_accum`` microbatches of the batch's rows (float32 sums
    when there are several microbatches, as in the reference); ``grads``
    mirrors ``params``.

    With a ``mesh``, ``params`` and ``grads`` are placed trees and each
    microbatch's rows are split over the data slots (microbatch ``i`` is
    rows ``[i·mb, (i+1)·mb)`` of the global batch, as unsharded)."""
    cdt = torch_dtype(cfg.compute_dtype)
    n = hp.grad_accum
    if mesh is not None and rules is None:
        rules = make_rules(mesh, "train")

    def grad_fn(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")
        mb = rows // n
        slots = (data_slots(mesh, rules, mb) if mesh is not None
                 else [(0, None, 0, mb)])
        grads, bufs = grad_buffers(params, hp)
        leaves = _layer_leaves(cfg, params, bufs)
        staged = [(g, b) for g, b in zip(flatten_tree(grads).values(),
                                         flatten_tree(bufs).values())
                  if g is not b]
        loss, metrics = 0.0, dict.fromkeys(METRICS, 0.0)
        for i in range(n):
            parts = []
            for d, dev, lo, hi in slots:
                lo, hi = i * mb + lo, i * mb + hi
                if mesh is None:
                    micro = {k: v[lo:hi] for k, v in batch.items()}
                else:
                    micro = {k: rows_of(v, lo, hi, dev)
                             for k, v in batch.items()}
                ctx = ShardCtx(positions=make_positions(micro),
                               compute_dtype=cdt, rules=rules, mesh=mesh,
                               data_slot=d, device=dev, rows=(lo, hi))
                parts.append(loss_parts(leaves, micro, cfg, ctx))
            l, m = loss_from_parts(parts, cfg, z_loss=hp.z_loss)
            l.backward()
            for g, b in staged:
                for gp, bp in zip(_pieces(g), _pieces(b)):
                    gp.add_(bp)
                    bp.zero_()
            loss = loss + l.detach()
            metrics = {k: metrics[k] + m[k].detach() for k in METRICS}
        for g in flatten_tree(grads).values():
            if isinstance(g, ShardedTensor):
                sync_replicas(g)
        if n > 1:
            inv = 1.0 / n
            loss = loss * inv
            for g in flatten_tree(grads).values():
                for gp in _pieces(g):
                    gp.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        return loss, metrics, grads

    return grad_fn


def make_update_fn(cfg, hp: TrainHParams):
    """(state, loss, metrics, grads) → (state, metrics): the step's second
    part, after `make_grad_fn`'s — the clip, the optimizer's update in
    place and ``step`` advanced."""
    _, opt_update = make_optimizer(cfg.optimizer)

    def update(state, loss, metrics, grads):
        params = state["params"]
        grads, gnorm = clip_by_global_norm(grads, hp.opt.grad_clip)
        with torch.no_grad():
            opt_update(grads, state["opt"], params, state["step"], hp.opt)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        step = state["step"]
        step = step.map(lambda t: t + 1) if isinstance(
            step, ShardedTensor) else step + 1
        return {"params": params, "opt": state["opt"], "step": step}, metrics

    return update


def make_train_step(cfg, hp: TrainHParams, mesh=None, rules=None):
    """``train_step(state, batch) → (state, metrics)``: the state's params
    and optimizer state updated in place, ``step`` advanced; metrics
    ``xent``, ``zloss``, ``aux``, ``loss`` and ``grad_norm`` as 0-d
    tensors on the device (on a mesh, the first data slot's).  With a
    ``mesh`` (``rules`` default: ``make_rules(mesh, "train")``) the state
    and batch are placed trees (see the module notes).  The step is
    `make_grad_fn`'s part, then `make_update_fn`'s."""
    grad_fn = make_grad_fn(cfg, hp, mesh, rules)
    update = make_update_fn(cfg, hp)

    def train_step(state, batch):
        return update(state, *grad_fn(state["params"], batch))

    return train_step
