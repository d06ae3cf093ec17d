"""Shared layers: norms, embeddings, position encodings, MLPs.

The port of `repro.nn.layers`.  ``jax.nn.gelu`` is the tanh
approximation by default, so every GeLU here is
``F.gelu(..., approximate="tanh")``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .common import (ParamDecl, ShardCtx, Split, cast, tp_bias, tp_layout,
                     tp_product)

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_decls(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDecl((d,), torch.float32, ("d_model",), "zeros")}
    if kind == "rmsnorm_unit":  # plain 1.0-centred scale
        return {"scale": ParamDecl((d,), torch.float32, ("d_model",), "ones")}
    if kind == "layernorm":
        return {
            "scale": ParamDecl((d,), torch.float32, ("d_model",), "ones"),
            "bias": ParamDecl((d,), torch.float32, ("d_model",), "zeros"),
        }
    raise ValueError(kind)


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind in ("rmsnorm", "rmsnorm_unit"):
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        # gemma-style (1 + w) for "rmsnorm" (zero-init scale); unit for others
        w = p["scale"] + 1.0 if kind == "rmsnorm" else p["scale"]
        return (y * w).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings & unembedding
# ---------------------------------------------------------------------------


def embed_decls(vocab: int, d: int) -> dict:
    # fan-in (1/sqrt d) init keeps tied-head logits O(1); archs that feed
    # the table straight into the stack (gemma family) set embed_scale to
    # recover unit-variance activations.
    return {
        "table": ParamDecl((vocab, d), torch.float32, ("vocab", "d_model"),
                           "fan_in", fan_axis=1)
    }


def embed_lookup(p: dict, tokens: torch.Tensor, ctx: ShardCtx,
                 scale_by_sqrt_d: bool = False) -> torch.Tensor:
    # gather the rows first, then cast: the same values as casting the
    # whole table, without a compute-dtype copy of it every step
    if ctx.tp:
        x = _embed_tp(p["table"], tokens, ctx)
    else:
        x = cast(p["table"][tokens.long()], ctx.compute_dtype)
    if scale_by_sqrt_d:
        x = x * math.sqrt(p["table"].shape[-1])
    return x


def _embed_tp(table, tokens: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The lookup on a mesh, by where the table's ``model`` axis lies:
    over vocab, each model slot looks up the tokens in its range (zeros
    elsewhere) and the rows are summed over ``model``; over d_model,
    each looks up its columns and they are joined; nowhere, the table is
    gathered onto the data slot's device."""
    kind, at = tp_layout(table, ())
    dt = ctx.compute_dtype
    if kind == "replicated":
        return cast(table.full(ctx.device, ctx.data_slot)[tokens.long()], dt)
    tok = tokens.long()

    def look(s):
        blk = table.block(s.m, s.device, ctx.data_slot)
        t = tok.to(s.device)
        if at == 1:  # columns of d_model
            return cast(blk[t], dt)
        lo, hi = table.model_range(s.m)[0]
        mine = (t >= lo) & (t < hi)
        rows = blk[torch.clamp(t - lo, 0, hi - lo - 1)]
        return cast(torch.where(mine[..., None], rows, 0.0), dt)

    return ctx.whole(Split(ctx.per_slot(look),
                           "sum" if at == 0 else tok.ndim))


def unembed_decls(d: int, vocab: int) -> dict:
    return {
        "kernel": ParamDecl((d, vocab), torch.float32, ("d_model", "vocab"),
                            "fan_in")
    }


def unembed(p: dict | None, x: torch.Tensor, ctx: ShardCtx,
            tied_table: torch.Tensor | None = None,
            softcap: float | None = None):
    """float32 logits; on a mesh with a ``model`` axis, a `Split` cut
    over vocab where the head's weight is (the reference's constraint),
    else whole on the data slot's device."""
    if ctx.tp:
        if tied_table is not None:
            y = tp_product(x, tied_table, ctx, contract=(1,),
                           fn=lambda a, w: a @ cast(w, a.dtype).t())
        else:
            y = tp_product(x, p["kernel"], ctx)
        if isinstance(y, Split) and y.dim == "sum":
            y = ctx.whole(y)

        def finish(_, lg):
            lg = lg.float()
            return softcap * torch.tanh(lg / softcap) if softcap else lg

        if isinstance(y, Split):
            return Split(ctx.per_slot(finish, y), y.dim)
        return finish(None, y)
    if tied_table is not None:
        logits = x @ cast(tied_table, x.dtype).t()
    else:
        logits = x @ cast(p["kernel"], x.dtype)
    logits = logits.float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# rotary & sinusoidal position encodings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int32."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )  # (half,)
    ang = positions[..., None].float() * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) → (B, S, d) classic transformer sinusoids."""
    half = d // 2
    freq = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_decls(d: int, ff: int, kind: str, bias: bool = False) -> dict:
    decls: dict[str, Any] = {}
    f32 = torch.float32
    if kind in ("swiglu", "geglu"):
        decls["gate"] = ParamDecl((d, ff), f32, ("d_model", "ff"), "fan_in")
        decls["up"] = ParamDecl((d, ff), f32, ("d_model", "ff"), "fan_in")
    else:  # gelu
        decls["up"] = ParamDecl((d, ff), f32, ("d_model", "ff"), "fan_in")
        if bias:
            decls["up_b"] = ParamDecl((ff,), f32, ("ff",), "zeros")
    decls["down"] = ParamDecl((ff, d), f32, ("ff", "d_model"), "fan_in")
    if bias:
        decls["down_b"] = ParamDecl((d,), f32, ("d_model",), "zeros")
    return decls


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, kind: str, ctx: ShardCtx) -> torch.Tensor:
    """The MLP; weights still in their pieces on a tensor-parallel mesh
    (a dense block's) are split over ``model`` (`_mlp_tp`), gathered
    ones (the MoE's shared expert) run whole."""
    if ctx.tp and not torch.is_tensor(p["down"]):
        return _mlp_tp(p, x, kind, ctx)
    dt = x.dtype
    if kind in ("swiglu", "geglu"):
        g = x @ cast(p["gate"], dt)
        u = x @ cast(p["up"], dt)
        act = F.silu(g) if kind == "swiglu" else gelu(g)
        h = act * u
    else:
        h = x @ cast(p["up"], dt)
        if "up_b" in p:
            h = h + cast(p["up_b"], dt)
        h = gelu(h)
    y = h @ cast(p["down"], dt)
    if "down_b" in p:
        y = y + cast(p["down_b"], dt)
    return y


def _mlp_tp(p: dict, x: torch.Tensor, kind: str, ctx: ShardCtx):
    """The MLP on a mesh: ``gate``/``up`` column-parallel over ff (the
    activation on each slot's slice), ``down`` row-parallel, its partial
    sums reduced over ``model`` and ``down_b`` added once after; other
    layouts by `tp_product`'s rule (partial sums reduced before the
    activation)."""
    xs = ctx.fan_out(x)

    def ready(y):  # cut or whole: the activation is element-wise
        return ctx.whole(y) if isinstance(y, Split) and y.dim == "sum" else y

    if kind in ("swiglu", "geglu"):
        g = ready(tp_product(xs, p["gate"], ctx))
        u = ready(tp_product(xs, p["up"], ctx))

        def act(_, gm, um):
            return (F.silu(gm) if kind == "swiglu" else gelu(gm)) * um
    else:
        g = tp_product(xs, p["up"], ctx)
        if "up_b" in p:
            g = tp_bias(g, p["up_b"], ctx)
        g = u = ready(g)

        def act(_, gm, um):
            return gelu(gm)
    h = Split(ctx.per_slot(act, g, u), g.dim) if isinstance(g, Split) \
        else act(None, g, u)
    y = tp_product(h, p["down"], ctx)
    if "down_b" in p:
        y = tp_bias(y, p["down_b"], ctx)
    return ctx.whole(y)
