"""The train step of the port: microbatched grads → clip → optimizer.

`repro.training.train_step` in PyTorch, in the reference's unsharded
mode.  The gradient is `torch.autograd`'s backward of `loss_fn`;
gradient accumulation is a Python loop over ``grad_accum`` microbatches
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
"""
from __future__ import annotations

import dataclasses

import torch

from ..nn.common import ShardCtx, flatten_tree, map_tree, torch_dtype, \
    unflatten_tree
from ..nn.model import loss_fn, stage_plan
from .optimizer import OptHParams, clip_by_global_norm, make_optimizer

__all__ = ["TrainHParams", "abstract_train_state", "make_grad_fn",
           "make_positions", "make_train_step", "train_state_init"]

METRICS = ("xent", "zloss", "aux")


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: OptHParams = OptHParams()
    grad_accum: int = 1
    z_loss: float = 1e-4


def train_state_init(params, cfg) -> dict:
    opt_init, _ = make_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_first(params).device)}


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


def _layer_leaves(cfg, params, bufs):
    """The forward's tree of fresh leaves over ``params``' storage (a
    stage's entry: the list of its repeats' unit trees), each leaf's
    ``.grad`` preset to its slice of ``bufs``."""
    flat_p, flat_b = flatten_tree(params), flatten_tree(bufs)

    def leaf(p, b):
        t = p.detach().requires_grad_(True)
        t.grad = b
        return t

    tree = unflatten_tree({k: leaf(p, flat_b[k]) for k, p in flat_p.items()
                           if not k.startswith("stage")})
    for si, st in enumerate(stage_plan(cfg)):
        pre = f"stage{si}/"
        names = [k for k in flat_p if k.startswith(pre)]
        tree[f"stage{si}"] = [
            unflatten_tree({k[len(pre):]: leaf(flat_p[k][r], flat_b[k][r])
                            for k in names})
            for r in range(st.repeat)]
    return tree


def make_grad_fn(cfg, hp: TrainHParams):
    """(params, batch) → (loss, metrics, grads): the loss and metrics of
    ``loss_fn`` (its z-loss weighted by ``hp.z_loss``; the reference's
    step fixes it at the default 1e-4) and its gradient, averaged over ``hp.grad_accum``
    microbatches of the batch's rows (float32 sums when there are several
    microbatches, as in the reference); ``grads`` mirrors ``params``."""
    cdt = torch_dtype(cfg.compute_dtype)
    n = hp.grad_accum

    def grad_fn(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")

        def acc_buf(p):
            dt = torch.float32 if n > 1 else p.dtype
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        grads = map_tree(acc_buf, params)
        # backward writes into ``grads`` where the dtypes agree, else into
        # a buffer of the parameter's dtype that is summed into ``grads``
        bufs = unflatten_tree({
            k: g if g.dtype == p.dtype else torch.zeros_like(p)
            for (k, p), g in zip(flatten_tree(params).items(),
                                 flatten_tree(grads).values())})
        leaves = _layer_leaves(cfg, params, bufs)
        staged = [(g, b) for g, b in zip(flatten_tree(grads).values(),
                                         flatten_tree(bufs).values())
                  if g is not b]
        mb = rows // n
        loss, metrics = 0.0, dict.fromkeys(METRICS, 0.0)
        for i in range(n):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            ctx = ShardCtx(positions=make_positions(micro),
                           compute_dtype=cdt)
            l, m = loss_fn(leaves, micro, cfg, ctx, z_loss=hp.z_loss)
            l.backward()
            for g, b in staged:
                g.add_(b)
                b.zero_()
            loss = loss + l.detach()
            metrics = {k: metrics[k] + m[k].detach() for k in METRICS}
        if n > 1:
            inv = 1.0 / n
            loss = loss * inv
            for g in flatten_tree(grads).values():
                g.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        return loss, metrics, grads

    return grad_fn


def make_train_step(cfg, hp: TrainHParams):
    """``train_step(state, batch) → (state, metrics)``: the state's params
    and optimizer state updated in place, ``step`` advanced; metrics
    ``xent``, ``zloss``, ``aux``, ``loss`` and ``grad_norm`` as 0-d
    tensors on the device."""
    _, opt_update = make_optimizer(cfg.optimizer)
    grad_fn = make_grad_fn(cfg, hp)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, hp.opt.grad_clip)
        with torch.no_grad():
            opt_update(grads, state["opt"], params, state["step"], hp.opt)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return {"params": params, "opt": state["opt"],
                "step": state["step"] + 1}, metrics

    return train_step
