"""The language model: embed → staged residual blocks → head.

The port of `repro.nn.model`.  Heterogeneous layer stacks (gemma2's
local/global alternation, Griffin's R-R-A pattern, DeepSeek's
dense-then-MoE split) are grouped into *stages*: maximal runs of a
repeating layer unit (`stage_plan`, the reference's).  Each stage's
params are stacked along a leading `layers` axis — the reference's
layout, leaf for leaf and name for name (``stage0/slot0/ffn/down``), so
`quantize_param_tree` sees the same leaves — and the model walks the
repeats in Python where the reference scans them.

Caches have the reference's stacked layout (``scan_layers=True``): one
list entry a stage, one dict a slot, a leading repeat axis on every
tensor.  `decode_step` writes into them in place.

`LanguageModel` is the `torch.nn.Module` that holds such a tree; its
parameter names are the reference's key paths, so ``state_dict()`` is
the flat tree `quantize_param_tree` takes and ``load_state_dict`` takes
back.

On a mesh (``ctx.mesh``) a call computes one data slot: the parameters
are `ShardedTensor`s, taken just before use — a repeat unit's inside
its remat region, so the recompute takes them again — and the loss is
returned as partial sums (`loss_parts`) that the step adds over the
slots before it divides (`loss_from_parts`).  On a mesh with a
``model`` axis every mixer's and FFN's products, the embedding and the
head are split over the slot's model slots (`nn.common.tp_product`; the
blocks' dispatch is `blocks.gather_block`): the logits stay cut over
vocab, and the loss's log-sum-exp is taken over the cut
(`vocab_parallel_xent`); only the norms are gathered onto the slot's
device.  A recurrent mixer's cache comes out of prefill cut over its
model slots (a `Split` of each leaf), and decode opens its pieces in
place.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .blocks import (BlockMeta, block_apply, block_decls, block_decode,
                     gather_block)
from .common import (ParamDecl, ShardCtx, Split, flatten_tree, map_tree,
                     torch_dtype, unflatten_tree)
from .layers import (apply_norm, embed_decls, embed_lookup, norm_decls,
                     sinusoidal, unembed, unembed_decls)
from .moe import switch_aux


@dataclasses.dataclass(frozen=True)
class Stage:
    metas: tuple[BlockMeta, ...]
    repeat: int


def _layer_meta(cfg, idx: int) -> BlockMeta:
    mixer = cfg.block_pattern[idx % len(cfg.block_pattern)]
    if mixer == "attn" and cfg.attn_kind == "mla":
        mixer = "mla"
    window = 0
    if mixer in ("attn", "mla"):
        window = cfg.window_pattern[idx % len(cfg.window_pattern)]
    if cfg.ffn_pattern == "none":
        ffn = "none"
    elif cfg.n_experts and idx >= cfg.first_dense_layers:
        ffn = "moe"
    else:
        ffn = "mlp"
    return BlockMeta(mixer=mixer, window=window, ffn=ffn, d_ff=cfg.d_ff)


def stage_plan(cfg) -> tuple[Stage, ...]:
    metas = [_layer_meta(cfg, i) for i in range(cfg.n_layers)]
    stages: list[Stage] = []
    i = 0
    n = len(metas)
    while i < n:
        best_u, best_r = 1, 1
        for u in (1, 2, 3, 4, 6):
            if i + u > n:
                break
            r = 1
            while (i + (r + 1) * u <= n
                   and metas[i + r * u : i + (r + 1) * u] == metas[i : i + u]):
                r += 1
            if r >= 2 and u * r > best_u * best_r:
                best_u, best_r = u, r
        stages.append(Stage(tuple(metas[i : i + best_u]), best_r))
        i += best_u * best_r
    return tuple(stages)


def _stack_decl(d: ParamDecl, repeat: int) -> ParamDecl:
    axes = d.axes or (None,) * len(d.shape)
    return ParamDecl((repeat,) + d.shape, d.dtype, ("layers",) + tuple(axes),
                     d.init, d.scale, d.fan_axis + 1)


def model_decls(cfg) -> dict:
    decls: dict[str, Any] = {}
    if cfg.input_kind == "tokens":
        decls["embed"] = embed_decls(cfg.vocab_size, cfg.d_model)
    for si, st in enumerate(stage_plan(cfg)):
        unit = {f"slot{j}": block_decls(cfg, m) for j, m in enumerate(st.metas)}
        decls[f"stage{si}"] = map_tree(lambda d, r=st.repeat: _stack_decl(d, r),
                                       unit)
    decls["final_norm"] = norm_decls(cfg.d_model, cfg.norm)
    if not (cfg.tie_embeddings and cfg.input_kind == "tokens"):
        decls["lm_head"] = unembed_decls(cfg.d_model, cfg.vocab_size)
    return decls


def as_tree(params) -> dict:
    """A `LanguageModel`, a nested tree or a flat ``"/"``-keyed dict of
    parameters → the nested tree."""
    if isinstance(params, LanguageModel):
        return params.tree()
    if isinstance(params, Mapping) and all(
            not isinstance(v, Mapping) for v in params.values()):
        return unflatten_tree(params)
    return params


def _embed_in(params, batch, cfg, ctx: ShardCtx):
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.input_kind == "embeds":
        x = batch.get("embeds", batch.get("embed")).to(dt)
    else:
        tokens = batch.get("tokens", batch.get("token"))
        x = embed_lookup(params["embed"], tokens, ctx,
                         scale_by_sqrt_d=cfg.embed_scale)
        x = x.to(dt)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal(ctx.positions, cfg.d_model).to(dt)
    return x


def _head(params, x, cfg, ctx: ShardCtx):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    tied = params["embed"]["table"] if (
        cfg.tie_embeddings and cfg.input_kind == "tokens") else None
    return unembed(params.get("lm_head"), x, ctx, tied_table=tied,
                   softcap=cfg.logit_softcap or None)


def _layer(tree, r: int) -> dict:
    """Repeat ``r``'s slice (views) of a stacked tree, or entry ``r`` of
    a list of the repeats' trees."""
    if isinstance(tree, list):
        return tree[r]
    return map_tree(lambda t: t[r], tree)


def _gather_unit(unit: dict, metas, ctx: ShardCtx) -> dict:
    """A repeat unit's weights as its blocks take them (`gather_block`)."""
    return {f"slot{j}": gather_block(unit[f"slot{j}"], ctx, m)
            for j, m in enumerate(metas)}


def _unit_apply(x, unit: dict, metas, ctx: ShardCtx, cfg):
    """One repeat unit of a stage: its blocks in order, its weights
    taken first on a mesh.  Returns (x, the blocks' caches, the list
    of its MoE blocks' routing sums)."""
    if ctx.mesh is None:
        return _unit_blocks(x, unit, metas, ctx, cfg)
    from ..distributed.placement import issuing

    with issuing(None):  # the data slot's: a remat recompute runs here too
        return _unit_blocks(x, _gather_unit(unit, metas, ctx), metas, ctx,
                            cfg)


def _unit_blocks(x, unit: dict, metas, ctx: ShardCtx, cfg):
    cs, sums = [], []
    for j, meta in enumerate(metas):
        x, c, a = block_apply(unit[f"slot{j}"], x, ctx, cfg, meta)
        cs.append(c)
        if a is not None:
            sums.append(a)
    return x, cs, sums


def _gather_top(params, ctx: ShardCtx) -> dict:
    """The parameters outside the stages gathered onto the slot's device
    (the stages stay as they are: a unit gathers its own); on a
    tensor-parallel mesh the embedding and head stay in their pieces."""
    keep = ("embed", "lm_head") if ctx.tp else ()
    return dict(params, **ctx.gather(
        {k: v for k, v in params.items()
         if not k.startswith("stage") and k not in keep}))


def forward(params, batch, cfg, ctx: ShardCtx, whole_logits: bool = True):
    """Full-sequence pass.  Returns (logits, the MoE blocks' routing
    sums, caches|None).  On a tensor-parallel mesh the logits are joined
    over vocab (an all-gather), or with ``whole_logits=False`` left a
    `Split` cut over vocab where the head cuts them.

    A stage's entry of ``params`` may also be the list of its repeats'
    unit trees (the train step's per-layer leaves).  With
    ``cfg.scan_layers`` and ``cfg.remat == "full"``, and gradients on,
    each repeat unit is checkpointed (the reference's `jax.checkpoint`
    with ``nothing_saveable``): only its input is kept, and the backward
    recomputes the rest.  The values do not change.

    The routing sums are a list, one (2, E) tensor an MoE block over
    ``batch``'s tokens (on a mesh, the slot's rows): `loss_from_parts`
    makes the aux loss of them."""
    params = _gather_top(as_tree(params), ctx)
    x = _embed_in(params, batch, cfg, ctx)
    caches = [] if ctx.make_cache else None
    remat = (cfg.scan_layers and cfg.remat == "full"
             and torch.is_grad_enabled())
    sums = []
    for si, st in enumerate(stage_plan(cfg)):
        sp = params[f"stage{si}"]
        per_repeat = []
        for r in range(st.repeat):
            unit = _layer(sp, r)
            if remat:
                x, cs, a = checkpoint(_unit_apply, x, unit, st.metas, ctx,
                                      cfg, use_reentrant=False)
            else:
                x, cs, a = _unit_apply(x, unit, st.metas, ctx, cfg)
            sums.extend(a)
            per_repeat.append(cs)
        if caches is not None:
            caches.append(tuple(
                {k: _stacked([cs[j][k] for cs in per_repeat])
                 for k in per_repeat[0][j]}
                for j in range(len(st.metas))))
    logits = _head(params, x, cfg, ctx)
    if whole_logits:
        logits = ctx.whole(logits)
    return logits, sums, caches


def _stacked(layers):
    """The repeats' cache leaves stacked; `Split`s (a tensor-parallel
    mixer's state, cut over its model slots) part by part."""
    if isinstance(layers[0], Split):
        return Split([torch.stack(ps) for ps in zip(*(t.parts
                                                      for t in layers))],
                     layers[0].dim + 1)
    return torch.stack(layers)


# the sequence dimension of a decode cache's leaves (one layer, one
# slot's rows): the dimension `cache_seq` shards
_CACHE_SEQ_DIM = {"attn": {"k": 2, "v": 2, "pos": 1},
                  "mla": {"c_kv": 1, "k_rope": 1, "pos": 1}}
# the dimension of a recurrent state that ``model`` cuts (its heads or
# channels): each model slot reads and writes its piece
_CACHE_MODEL_DIM = {"ssd": {"state": 1, "conv_tail": 2},
                    "rglru": {"h": 1, "conv_tail": 2}}


def decode_step(params, batch, caches, ctx: ShardCtx, cfg):
    """One-token step against the cache.  Returns (logits, caches): the
    new token's entries are written into ``caches`` in place.  On a mesh
    the caches are `ShardedTensor`s and the step computes the rows of
    ``ctx``'s data slot (`distributed.placement.open_cache`)."""
    params = _gather_top(as_tree(params), ctx)
    x = _embed_in(params, batch, cfg, ctx)
    for si, st in enumerate(stage_plan(cfg)):
        sp = params[f"stage{si}"]
        cache_si = caches[si]
        for r in range(st.repeat):
            unit = _gather_unit(_layer(sp, r), st.metas, ctx) \
                if ctx.mesh is not None else _layer(sp, r)
            for j, meta in enumerate(st.metas):
                cache = _layer(cache_si[j], r)
                if ctx.mesh is not None:
                    from ..distributed.placement import open_cache

                    cache, close = open_cache(
                        cache, ctx, _CACHE_SEQ_DIM.get(meta.mixer, {}),
                        _CACHE_MODEL_DIM.get(meta.mixer))
                x, _ = block_decode(unit[f"slot{j}"], x, cache, ctx, cfg,
                                    meta)
                if ctx.mesh is not None:
                    close()
    logits = ctx.whole(_head(params, x, cfg, ctx))
    return logits, caches


def loss_parts(params, batch, cfg, ctx: ShardCtx) -> dict:
    """The loss's sums over ``batch``'s tokens: ``xent`` (masked token
    cross-entropy), ``zsq`` (masked logZ²), ``count`` (the mask's sum),
    ``tokens`` (an int) and ``aux`` (the forward's MoE routing sums)."""
    logits, aux, _ = forward(params, batch, cfg, ctx, whole_logits=False)
    labels = batch["labels"].long()
    mask = batch.get("mask")
    if isinstance(logits, Split):
        logz, ll = vocab_parallel_xent(logits, labels, ctx)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logz.device)
    xent = (logz - ll) * mask
    return {"xent": xent.sum(), "zsq": ((logz * mask) ** 2).sum(),
            "count": mask.sum(), "tokens": labels.numel(), "aux": aux}


def vocab_parallel_xent(logits: Split, labels: torch.Tensor,
                        ctx: ShardCtx) -> tuple:
    """(logZ, the label's logit) over float32 logits cut over vocab (a
    `Split` of even blocks, slot ``m``'s the ``m``-th), on the data
    slot's device: the max an all-reduce max (no gradient), the sum of
    exponentials an all-reduce sum, the label's logit taken on the slot
    that owns it and summed."""
    from ..distributed.placement import all_reduce_max

    n = logits.parts[0].shape[-1]
    mx = all_reduce_max(ctx.per_slot(
        lambda s, lg: lg.detach().amax(dim=-1), logits), ctx.device,
        ctx.data_slot)

    def stats(s, lg):
        lab = labels.to(s.device) - s.m * n
        mine = (lab >= 0) & (lab < n)
        ll = torch.take_along_dim(lg, torch.clamp(lab, 0, n - 1)[..., None],
                                  dim=-1)[..., 0]
        return (torch.exp(lg - mx.to(s.device)[..., None]).sum(dim=-1),
                torch.where(mine, ll, 0.0))

    st = ctx.per_slot(stats, logits)
    se = ctx.whole(Split([a for a, _ in st], "sum"))
    ll = ctx.whole(Split([b for _, b in st], "sum"))
    return mx + torch.log(se), ll


def _global_aux(stats, cfg, tokens: int, device) -> torch.Tensor:
    """The switch aux loss from every slot's routing sums: each MoE
    block's probability and routed-slot sums added over the slots, so
    its means run over all ``tokens`` as the reference's do."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for per_block in zip(*stats):
        aux = aux + switch_aux(sum(t.to(device) for t in per_block), tokens,
                               cfg)
    return aux


def loss_from_parts(parts: list, cfg, z_loss: float = 1e-4, device=None):
    """(total, metrics) from one or several slots' `loss_parts`, added on
    ``device`` (default: the first's) and then divided by the global
    mask count — never a mean of the slots' means."""
    if device is None:
        device = parts[0]["xent"].device

    def added(key):
        out = parts[0][key].to(device)
        for p in parts[1:]:
            out = out + p[key].to(device)
        return out

    xent, zsq, count = added("xent"), added("zsq"), added("count")
    aux = _global_aux([p["aux"] for p in parts], cfg,
                      sum(p["tokens"] for p in parts), device)
    denom = torch.clamp(count, min=1.0)
    loss = xent / denom
    zloss = z_loss * zsq / denom
    total = loss + zloss + cfg.aux_loss_coef * aux
    metrics = {"xent": loss, "zloss": zloss, "aux": aux}
    return total, metrics


def loss_fn(params, batch, cfg, ctx: ShardCtx, z_loss: float = 1e-4):
    """Masked token cross-entropy (+ MoE aux, + ``z_loss`` × mean logZ²):
    its value, with the reference's metrics (``zloss`` is the weighted
    term)."""
    return loss_from_parts([loss_parts(params, batch, cfg, ctx)], cfg,
                           z_loss)


class LanguageModel(torch.nn.Module):
    """The model's stacked parameters as a `torch.nn.Module`, named by the
    reference's key paths (``stage0/slot0/ffn/down``); ``forward`` and
    ``decode_step`` run the functions above on them."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        flat = flatten_tree(as_tree(params))
        want = flatten_tree(model_decls(cfg))
        if set(flat) != set(want):
            raise ValueError(f"parameters do not match {cfg.name}'s "
                             f"declarations: missing "
                             f"{sorted(set(want) - set(flat))[:4]}, extra "
                             f"{sorted(set(flat) - set(want))[:4]}")
        for name in want:
            t = flat[name]
            if tuple(t.shape) != want[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, declared "
                                 f"{want[name].shape}")
            self.register_parameter(
                name, torch.nn.Parameter(t, requires_grad=False))

    def tree(self) -> dict:
        return unflatten_tree(dict(self.named_parameters()))

    def forward(self, batch, ctx: ShardCtx):
        return forward(self.tree(), batch, self.cfg, ctx)

    def decode_step(self, batch, caches, ctx: ShardCtx):
        return decode_step(self.tree(), batch, caches, ctx, self.cfg)
