"""Residual blocks: (norm → mixer → residual) (+ norm → FFN → residual).

The port of `repro.nn.blocks`.  A `BlockMeta` fixes the *static*
identity of one slot in a stage's layer pattern (mixer kind, attention
window, FFN kind); params for that slot are stacked across the stage's
repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import attention, mla, moe, rglru, ssd
from .attention import AttnMeta
from .common import ShardCtx
from .layers import apply_mlp, apply_norm, mlp_decls, norm_decls


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    mixer: str  # attn | mla | ssd | rglru
    window: int = 0
    ffn: str = "mlp"  # mlp | moe | none
    d_ff: int = 0  # dense ffn width for this slot (moe uses cfg.moe_d_ff)


def block_decls(cfg, meta: BlockMeta) -> dict:
    d = cfg.d_model
    decls: dict[str, Any] = {"norm1": norm_decls(d, cfg.norm)}
    if meta.mixer == "attn":
        decls["mixer"] = attention.attn_decls(cfg)
    elif meta.mixer == "mla":
        decls["mixer"] = mla.mla_decls(cfg)
    elif meta.mixer == "ssd":
        decls["mixer"] = ssd.ssd_decls(cfg)
    elif meta.mixer == "rglru":
        decls["mixer"] = rglru.rglru_decls(cfg)
    else:
        raise ValueError(meta.mixer)
    if cfg.post_norm:
        decls["post_norm1"] = norm_decls(d, cfg.norm)
    if meta.ffn != "none":
        decls["norm2"] = norm_decls(d, cfg.norm)
        if meta.ffn == "moe":
            decls["ffn"] = moe.moe_decls(cfg)
        else:
            decls["ffn"] = mlp_decls(d, meta.d_ff or cfg.d_ff, cfg.mlp,
                                     cfg.mlp_bias)
        if cfg.post_norm:
            decls["post_norm2"] = norm_decls(d, cfg.norm)
    return decls


def gather_block(p: dict, ctx: ShardCtx, meta: BlockMeta) -> dict:
    """A block's weights as its apply takes them on a mesh: on a
    tensor-parallel mesh (`ShardCtx.tp`) the mixer's and the FFN's stay
    in their pieces, which their products take by `tp_product`'s rule
    (and raise on a spec it cannot take); only the norms (the block's
    and MLA's ``q_norm``/``kv_norm``) are gathered whole onto the data
    slot's device.  Without ``model`` everything is gathered there."""
    if not ctx.tp:
        return ctx.gather(p)
    out = {k: v if k in ("mixer", "ffn") else ctx.gather(v)
           for k, v in p.items()}
    out["mixer"] = {k: ctx.gather(v) if k.endswith("_norm") else v
                    for k, v in p["mixer"].items()}
    return out


def _attn_meta(cfg, meta: BlockMeta) -> AttnMeta:
    return AttnMeta(window=meta.window)


def _ffn(p, x, ctx: ShardCtx, cfg, meta: BlockMeta):
    """The FFN half: (x, the MoE routing sums or None)."""
    aux = None
    if meta.ffn != "none":
        h = apply_norm(p["norm2"], x, cfg.norm)
        if meta.ffn == "moe":
            y, aux = moe.moe_apply(p["ffn"], h, ctx, cfg)
        else:
            y = apply_mlp(p["ffn"], h, cfg.mlp, ctx)
        if cfg.post_norm:
            y = apply_norm(p["post_norm2"], y, cfg.norm)
        x = x + y
    return x, aux


def block_apply(p, x, ctx: ShardCtx, cfg, meta: BlockMeta):
    """Full-sequence (train/prefill).  Returns (x, cache, aux)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if meta.mixer == "attn":
        y, cache = attention.attn_apply(p["mixer"], h, ctx, cfg, _attn_meta(cfg, meta))
    elif meta.mixer == "mla":
        y, cache = mla.mla_apply(p["mixer"], h, ctx, cfg, meta)
    elif meta.mixer == "ssd":
        y, cache = ssd.ssd_apply(p["mixer"], h, ctx, cfg, meta)
    else:
        y, cache = rglru.rglru_apply(p["mixer"], h, ctx, cfg, meta)
    if cfg.post_norm:
        y = apply_norm(p["post_norm1"], y, cfg.norm)
    x, aux = _ffn(p, x + y, ctx, cfg, meta)
    return x, cache, aux


def block_decode(p, x, cache, ctx: ShardCtx, cfg, meta: BlockMeta):
    """Single-token decode.  Returns (x, cache), the cache updated in
    place."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if meta.mixer == "attn":
        y, cache = attention.attn_decode(p["mixer"], h, cache, ctx, cfg,
                                         _attn_meta(cfg, meta))
    elif meta.mixer == "mla":
        y, cache = mla.mla_decode(p["mixer"], h, cache, ctx, cfg, meta)
    elif meta.mixer == "ssd":
        y, cache = ssd.ssd_decode(p["mixer"], h, cache, ctx, cfg, meta)
    else:
        y, cache = rglru.rglru_decode(p["mixer"], h, cache, ctx, cfg, meta)
    if cfg.post_norm:
        y = apply_norm(p["post_norm1"], y, cfg.norm)
    x, _ = _ffn(p, x + y, ctx, cfg, meta)
    return x, cache
