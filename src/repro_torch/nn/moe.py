"""Mixture-of-Experts FFN: top-k routing, group-local capacity dispatch.

The port of `repro.nn.moe`.  Dispatch is GShard-style and group-local:
tokens are split into G groups, each group scatters into its own
(E, C_g, d) buffer by the rank of each routed slot within its expert
(a stable sort); slots past the capacity are dropped and add nothing.
Router styles: `softmax` (Mixtral) and `sigmoid_norm` (DeepSeek-V3).
Shared experts (DeepSeek) are a plain dense MLP added to the routed path.

`top_k` breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (a stable descending sort); ``torch.topk`` promises no order.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .common import ParamDecl, ShardCtx, cast
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
    x_rep = torch.repeat_interleave(xt, k, dim=1)  # (G, Tg*k, d)
    gidx = torch.arange(g, device=dev)[:, None]
    row = (gidx * e + e_flat) * (cap + 1) + p_idx  # (G, Tg*k)
    buf = torch.zeros((g * e * (cap + 1), d), dtype=x.dtype, device=dev)
    buf.index_add_(0, row.reshape(-1),
                   (x_rep * keep[..., None].to(x.dtype)).reshape(-1, d))
    buf = buf.reshape(g, e, cap + 1, d)[:, :, :cap]  # (G, E, C, d)

    h_g = torch.einsum("gecd,edf->gecf", buf, cast(p["gate"], x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", buf, cast(p["up"], x.dtype))
    h = F.silu(h_g) * h_u
    yb = torch.einsum("gecf,efd->gecd", h, cast(p["down"], x.dtype))

    p_read = torch.clamp(p_idx, max=cap - 1)
    y_sel = yb[gidx, e_flat, p_read] * keep[..., None].to(yb.dtype)
    y_sel = y_sel.reshape(g, tg, k, d) * w[..., None].to(yb.dtype)
    y = y_sel.sum(dim=2).reshape(b, s, d)

    # the load-balance aux's sums (switch-style)
    counts = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=dev))
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], x, "swiglu", ctx)
    return y, torch.stack([probs.sum(dim=(0, 1)), counts])


def switch_aux(sums: torch.Tensor, tokens: int, cfg) -> torch.Tensor:
    """The switch load-balance loss from one MoE block's routing sums
    over ``tokens`` tokens (`moe_apply`): E · Σ_e me_e · ce_e, with me
    the mean router probability and ce the share of routed slots."""
    e, k = cfg.n_experts, cfg.experts_per_token
    return e * torch.sum((sums[0] / tokens) * (sums[1] / (tokens * k)))
