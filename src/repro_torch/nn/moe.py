"""Mixture-of-Experts FFN: top-k routing, group-local capacity dispatch.

The port of `repro.nn.moe`.  Dispatch is GShard-style and group-local:
tokens are split into G groups, each group scatters into its own
(E, C_g, d) buffer by the rank of each routed slot within its expert
(a stable sort); slots past the capacity are dropped and add nothing.
Router styles: `softmax` (Mixtral) and `sigmoid_norm` (DeepSeek-V3).
Shared experts (DeepSeek) are a plain dense MLP added to the routed path.

On a tensor-parallel mesh the routing runs once on the data slot's
device (the router by `tp_product`'s rule; the top-k, the ranks and the
capacity drops as unsharded, so every drop is the unsharded one), and
the expert products follow their weights' ``model`` axis: on the
experts, each model slot builds the rows of ``buf`` of its experts from
its copy of the tokens (the reference's tokens are replicated over
``model``: no data moves), runs them, and combines its experts' rows of
each routed slot into a partial output, summed over the slots (an
all-reduce); on ``expert_ff``, ``gate``/``up`` column- and ``down``
row-parallel on the whole ``buf``, each slot combining its partial
``yb``; replicated, computed on the data slot's device.

`top_k` breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (a stable descending sort); ``torch.topk`` promises no order.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .common import ParamDecl, ShardCtx, Split, cast, tp_layout, tp_product
from .layers import apply_mlp, mlp_decls


def moe_decls(cfg) -> dict:
    d, e, ffe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    f32 = torch.float32
    decls: dict[str, Any] = {
        "router": ParamDecl((d, e), f32, ("d_model", None), "fan_in"),
        "gate": ParamDecl((e, d, ffe), f32,
                          ("experts", "d_model", "expert_ff"), "fan_in", fan_axis=1),
        "up": ParamDecl((e, d, ffe), f32,
                        ("experts", "d_model", "expert_ff"), "fan_in", fan_axis=1),
        "down": ParamDecl((e, ffe, d), f32,
                          ("experts", "expert_ff", "d_model"), "fan_in", fan_axis=1),
    }
    if cfg.n_shared_experts:
        decls["shared"] = mlp_decls(
            d, cfg.moe_d_ff * cfg.n_shared_experts, "swiglu"
        )
    return decls


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions_in_expert(e_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each routed slot within its expert (stable, sort-based).

    ``e_idx``: (M,) expert ids.  Returns (M,) int32 positions
    0..count_e-1, in order of appearance."""
    m = e_idx.shape[0]
    order = torch.argsort(e_idx, stable=True)
    sorted_e = e_idx[order]
    # the counts by index_add_ (bincount's result, without its
    # data-dependent length: the step traces on ``meta`` tensors)
    counts = torch.zeros((n_experts,), dtype=torch.int64,
                         device=e_idx.device).index_add_(
        0, sorted_e, torch.ones_like(sorted_e, dtype=torch.int64))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(m, device=e_idx.device) - starts[sorted_e]
    out = torch.zeros((m,), dtype=torch.int32, device=e_idx.device)
    out[order] = rank_sorted.to(torch.int32)
    return out


def moe_apply(p, x: torch.Tensor, ctx: ShardCtx, cfg):
    """x: (B, S, d) → (y, routing sums).  Groups = cfg.moe_groups.

    The routing sums, (2, E), are the router probabilities' sum over
    ``x``'s tokens and its routed-slot counts: `switch_aux` makes the
    reference's aux loss of them (`loss_from_parts` first adds them over
    the data slots, so its means run over the whole batch).  On a mesh
    ``x`` is one data slot's rows: the slot dispatches its share of the
    global batch's groups, so each group (and the capacity) is the one
    the whole batch would have."""
    b, s, d = x.shape
    t = b * s
    n_data = ctx.data_size
    t_all = t * n_data
    g = max(1, min(cfg.moe_groups, t_all))
    while t_all % g:
        g -= 1
    if g % n_data:
        raise ValueError(
            f"{cfg.name}: {g} MoE groups do not split over {n_data} data "
            f"slots; set moe_groups to a multiple of the data size, e.g. "
            f"dataclasses.replace(cfg, moe_groups={n_data})")
    g //= n_data
    tg = t // g
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(k, int(cfg.capacity_factor * tg * k / e))
    xt = x.reshape(g, tg, d)
    dev = x.device
    tp = ctx.tp and not torch.is_tensor(p["gate"])
    xs = ctx.fan_out(xt) if tp else None

    if tp:
        logits = ctx.whole(tp_product(xs, p["router"], ctx)).float()
    else:
        logits = (xt @ cast(p["router"], x.dtype)).float()
    if cfg.router == "sigmoid_norm":
        scores = torch.sigmoid(logits)
        w, idx = top_k(scores, k)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = top_k(probs, k)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)

    # dispatch: each group's routed slots by (expert, rank); a dropped
    # slot goes to a spare row `cap` that is cut off before the experts
    e_flat = idx.reshape(g, tg * k)
    pos = torch.stack([_positions_in_expert(e_flat[gi], e) for gi in range(g)])
    keep = pos < cap
    p_idx = torch.where(keep, pos, cap).long()
    route = (e_flat, p_idx, keep, cap, k)
    if tp:
        y = _experts_tp(p, xt, xs, w, route, ctx).reshape(b, s, d)
    else:
        buf = _dispatch(xt, route, 0, e)
        h_g = torch.einsum("gecd,edf->gecf", buf, cast(p["gate"], x.dtype))
        h_u = torch.einsum("gecd,edf->gecf", buf, cast(p["up"], x.dtype))
        h = F.silu(h_g) * h_u
        yb = torch.einsum("gecf,efd->gecd", h, cast(p["down"], x.dtype))
        y = _combine(yb, w, route, 0).reshape(b, s, d)

    # the load-balance aux's sums (switch-style)
    counts = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=dev))
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], x, "swiglu", ctx)
    return y, torch.stack([probs.sum(dim=(0, 1)), counts])


def _local(route, e0: int, e1: int, dev):
    """The routed slots of experts ``[e0, e1)`` on ``dev``: (each slot's
    expert less e0, clamped into the range; its rank; whether it is
    kept and local)."""
    e_flat, p_idx, keep = (t.to(dev) for t in route[:3])
    local = keep & (e_flat >= e0) & (e_flat < e1)
    return torch.clamp(e_flat - e0, 0, e1 - e0 - 1), p_idx, local


def _dispatch(xt, route, e0: int, e1: int) -> torch.Tensor:
    """The (G, e1 − e0, C, d) buffer of experts ``[e0, e1)``: each kept
    routed slot's token at (its expert, its rank)."""
    g, tg, d = xt.shape
    cap, k = route[3], route[4]
    em = e1 - e0
    el, p_idx, local = _local(route, e0, e1, xt.device)
    x_rep = torch.repeat_interleave(xt, k, dim=1)  # (G, Tg*k, d)
    gidx = torch.arange(g, device=xt.device)[:, None]
    row = (gidx * em + el) * (cap + 1) + torch.where(local, p_idx, cap)
    buf = torch.zeros((g * em * (cap + 1), d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, row.reshape(-1),
                   (x_rep * local[..., None].to(xt.dtype)).reshape(-1, d))
    return buf.reshape(g, em, cap + 1, d)[:, :, :cap]  # (G, E, C, d)


def _combine(yb, w, route, e0: int) -> torch.Tensor:
    """(G, Tg, d): each token's kept routed slots of the experts ``yb``
    holds (from ``e0`` on) read back, weighted by ``w`` and summed."""
    g, em, cap, d = yb.shape
    k = route[4]
    el, p_idx, local = _local(route, e0, e0 + em, yb.device)
    gidx = torch.arange(g, device=yb.device)[:, None]
    p_read = torch.clamp(p_idx, max=cap - 1)
    y_sel = yb[gidx, el, p_read] * local[..., None].to(yb.dtype)
    y_sel = y_sel.reshape(g, -1, k, d) * w[..., None].to(yb.dtype)
    return y_sel.sum(dim=2)


def _experts_tp(p, xt, xs, w, route, ctx: ShardCtx) -> torch.Tensor:
    """The routed experts on a tensor-parallel mesh: (G, Tg, d) on the
    data slot's device.  ``xs``: the tokens' copies on the model slots;
    ``w``: the routing weights."""
    dt = xt.dtype
    e = p["gate"].shape[0]

    def prod(h, wt, eq):
        return tp_product(h, wt, ctx, contract=(1,), shared=((0, 1, 1),),
                          fn=lambda a, b: torch.einsum(eq, a, cast(b, dt)))

    def ready(y):  # cut or whole: the activation is element-wise
        return ctx.whole(y) if isinstance(y, Split) and y.dim == "sum" else y

    if tp_layout(p["gate"], (1,), (0,))[0] == "shared":
        def rows(s, xm):
            a, b = p["gate"].model_range(s.m)[0]
            return _dispatch(xm, route, a, b)

        buf = Split(ctx.per_slot(rows, xs), 1)
    else:
        buf = _dispatch(xt, route, 0, e)
    hg = ready(prod(buf, p["gate"], "gecd,edf->gecf"))
    hu = ready(prod(buf, p["up"], "gecd,edf->gecf"))
    if isinstance(hg, Split) != isinstance(hu, Split) or (
            isinstance(hg, Split) and hg.dim != hu.dim):
        raise ValueError(f"gate {p['gate'].spec} and up {p['up'].spec} "
                         f"cut their outputs apart")
    h = Split(ctx.per_slot(lambda _, gm, um: F.silu(gm) * um, hg, hu),
              hg.dim) if isinstance(hg, Split) else F.silu(hg) * hu
    yb = prod(h, p["down"], "gecf,efd->gecd")
    if not isinstance(yb, Split):
        return _combine(yb, w, route, 0)
    ws = ctx.fan_out(w)

    def comb(s, ybm, wm):
        e0 = p["down"].model_range(s.m)[0][0] if yb.dim == 1 else 0
        return _combine(ybm, wm, route, e0)

    # experts or partial sums: a partial output; d_model: its block
    return ctx.whole(Split(ctx.per_slot(comb, yb, ws),
                           2 if yb.dim == 3 else "sum"))


def switch_aux(sums: torch.Tensor, tokens: int, cfg) -> torch.Tensor:
    """The switch load-balance loss from one MoE block's routing sums
    over ``tokens`` tokens (`moe_apply`): E · Σ_e me_e · ce_e, with me
    the mean router probability and ce the share of routed slots."""
    e, k = cfg.n_experts, cfg.experts_per_token
    return e * torch.sum((sums[0] / tokens) * (sums[1] / (tokens * k)))
