"""Multi-head Latent Attention (DeepSeek-V2/V3).

The port of `repro.nn.mla`.  Train/prefill: queries go through a
low-rank bottleneck (q_lora), K/V are generated from a shared compressed
latent c_kv (kv_lora_rank) plus a decoupled shared RoPE key.  Decode: the
*latent* is cached (kv_lora + qk_rope_dim per token) and the
up-projections are **absorbed** into the query/output paths, so
attention runs directly against the latent cache:

    score(t, s) = q_nopeᵀ·(W_uk c_s) + q_ropeᵀ·k_rope_s
                = (W_ukᵀ q_nope)ᵀ·c_s + q_ropeᵀ·k_rope_s
    out_h       = W_uv Σ_s a_s c_s

The latent cache carries absolute positions and is written in place.

On a tensor-parallel mesh the products follow `tp_product`'s rule:
``wq_a``/``wkv_a`` (replicated in train rules, row-parallel over
``d_model`` under the decode rules' fallback), their norms and rope run
on the data slot's device; each model slot projects its heads
(``wq_b``, ``wk_b``, ``wv_b`` column over heads, from the whole latents),
attends them, and ``wo`` is row-parallel over heads.  Decode absorbs
``wk_b`` into each slot's heads of q, joins q (an all-gather: it is
small), attends the latent cache as unsharded (or piece by piece), and
hands each slot its heads of the latent output for ``wv_b`` and ``wo``.
"""
from __future__ import annotations

import math

import torch

from .attention import chunked_attention, write_ring_piece
from .common import ParamDecl, ShardCtx, Split, cast, tp_product
from .layers import apply_norm, norm_decls, rope

NEG = -1e30


def mla_decls(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    f32 = torch.float32
    return {
        "wq_a": ParamDecl((d, qr), f32, ("d_model", None), "fan_in"),
        "q_norm": norm_decls(qr, "rmsnorm_unit"),
        "wq_b": ParamDecl((qr, h, dn + dr), f32, (None, "heads", "head_dim"), "fan_in"),
        "wkv_a": ParamDecl((d, kr + dr), f32, ("d_model", None), "fan_in"),
        "kv_norm": norm_decls(kr, "rmsnorm_unit"),
        "wk_b": ParamDecl((kr, h, dn), f32, (None, "heads", "head_dim"), "fan_in"),
        "wv_b": ParamDecl((kr, h, dvh), f32, (None, "heads", "head_dim"), "fan_in"),
        "wo": ParamDecl((h, dvh, d), f32, ("heads", "head_dim", "d_model"),
                        "fan_in", fan_axis=1),
    }


def _latent(p, x, cfg, positions):
    """x → (c_kv normed, k_rope rotated, q_nope, q_rope)."""
    dt = x.dtype
    kr = cfg.kv_lora_rank
    qa = x @ cast(p["wq_a"], dt)
    qa = apply_norm(p["q_norm"], qa, "rmsnorm_unit")
    q = torch.einsum("bsr,rhk->bshk", qa, cast(p["wq_b"], dt))
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ cast(p["wkv_a"], dt)
    c_kv, k_rope = kv[..., :kr], kv[..., kr:]
    c_kv = apply_norm(p["kv_norm"], c_kv, "rmsnorm_unit")
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope, q_nope, q_rope


def _einsum(eq: str, dt, f32: bool = False):
    """``fn(x, w)`` of `tp_product`: ``torch.einsum(eq)`` with w cast to
    ``dt`` (both operands to float32 with ``f32``)."""
    if f32:
        return lambda a, b: torch.einsum(eq, a.float(), cast(b, dt).float())
    return lambda a, b: torch.einsum(eq, a, cast(b, dt))


def _latent_tp(p, x, ctx: ShardCtx, cfg, positions):
    """`_latent` on a tensor-parallel mesh: c_kv and k_rope on the data
    slot's device; q_nope and q_rope each a `Split` over heads (dim 2)
    or, where ``wq_b`` keeps its heads whole, tensors there."""
    dt = x.dtype
    kr = cfg.kv_lora_rank
    xs = ctx.fan_out(x)
    qa = ctx.whole(tp_product(xs, p["wq_a"], ctx))
    qa = apply_norm(p["q_norm"], qa, "rmsnorm_unit")
    q = tp_product(qa, p["wq_b"], ctx, fn=_einsum("bsr,rhk->bshk", dt),
                   contract=(0,))
    if not isinstance(q, Split) or q.dim != 2:
        q = ctx.whole(q)
    dn = cfg.qk_nope_dim

    def split(_, qm):
        return qm[..., :dn], rope(qm[..., dn:], positions.to(qm.device),
                                  cfg.rope_theta)

    if isinstance(q, Split):
        qs = ctx.per_slot(split, q)
        q_nope, q_rope = (Split([t[i] for t in qs], 2) for i in (0, 1))
    else:
        q_nope, q_rope = split(None, q)
    kv = ctx.whole(tp_product(xs, p["wkv_a"], ctx))
    c_kv, k_rope = kv[..., :kr], kv[..., kr:]
    c_kv = apply_norm(p["kv_norm"], c_kv, "rmsnorm_unit")
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope, q_nope, q_rope


def _heads_cut(*ts) -> bool:
    return all(isinstance(t, Split) and t.dim == 2 for t in ts)


def _mla_apply_tp(p, x, ctx: ShardCtx, cfg, kvc: int):
    """The full-sequence path on a tensor-parallel mesh: (y, c_kv,
    k_rope) on the data slot's device."""
    b, s, _ = x.shape
    pos = ctx.positions
    dt = x.dtype
    c_kv, k_rope, q_nope, q_rope = _latent_tp(p, x, ctx, cfg, pos)
    cs = ctx.fan_out(c_kv)
    k_nope, v = (ctx.whole(y) if not _heads_cut(y) else y for y in (
        tp_product(cs, p[w], ctx, fn=_einsum("bsr,rhk->bshk", dt),
                   contract=(0,)) for w in ("wk_b", "wv_b")))
    kw = dict(scale=_scale(cfg), window=0, softcap=None, kv_chunk=kvc,
              triangular=True)

    def attend(_, qn, qr, kn, vm, krm):
        h = qn.shape[2]
        q = torch.cat([qn, qr], -1)
        k = torch.cat([kn, krm[:, :, None, :].expand(b, s, h,
                                                     cfg.qk_rope_dim)], -1)
        pm = pos.to(q.device)
        return chunked_attention(q, k, vm, pm, pm, **kw)

    if _heads_cut(q_nope, q_rope, k_nope, v):
        out = Split(ctx.per_slot(attend, q_nope, q_rope, k_nope, v,
                                 ctx.fan_out(k_rope)), 2)
    else:
        out = attend(None, *(ctx.whole(t) for t in (q_nope, q_rope, k_nope,
                                                     v)), k_rope)
    y = ctx.whole(tp_product(out, p["wo"], ctx, n_in=2,
                             fn=_einsum("bshk,hkd->bsd", dt)))
    return y, c_kv, k_rope


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_apply(p, x, ctx: ShardCtx, cfg, meta):
    """Full-sequence path: expand K/V per head (standard formulation)."""
    b, s, _ = x.shape
    pos = ctx.positions
    kvc = min(1024, s) if s <= 1024 else max(1024, s // 16)
    if s % kvc:
        kvc = s
    if ctx.tp:
        y, c_kv, k_rope = _mla_apply_tp(p, x, ctx, cfg, kvc)
    else:
        c_kv, k_rope, q_nope, q_rope = _latent(p, x, cfg, pos)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, cast(p["wk_b"], x.dtype))
        v = torch.einsum("bsr,rhk->bshk", c_kv, cast(p["wv_b"], x.dtype))
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(b, s, cfg.n_heads,
                                                  cfg.qk_rope_dim)], -1
        )
        out = chunked_attention(
            q, k, v, pos, pos, scale=_scale(cfg), window=0, softcap=None,
            kv_chunk=kvc, triangular=True,
        )
        y = torch.einsum("bshk,hkd->bsd", out, cast(p["wo"], x.dtype))
    cache = None
    if ctx.make_cache:
        pad = ctx.cache_len - s
        cache = {
            "c_kv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
            "k_rope": torch.nn.functional.pad(k_rope, (0, 0, 0, pad)),
            "pos": torch.nn.functional.pad(pos, (0, pad), value=-1),
        }
    return y, cache


def mla_decode(p, x, cache, ctx: ShardCtx, cfg, meta):
    """Absorbed decode against the latent cache.  x: (B, 1, d)."""
    pos = ctx.positions  # (B, 1)
    dt = x.dtype
    if ctx.tp:
        return _mla_decode_tp(p, x, cache, ctx, cfg), cache
    c_new, kr_new, q_nope, q_rope = _latent(p, x, cfg, pos)
    # absorb W_uk into q:  (B,1,H,dn) × (kr,H,dn) → (B,H,kr); fp32
    # accumulation keeps the absorbed path within ~1e-2 of the expanded one
    q_abs = torch.einsum("bohk,rhk->bhr", q_nope.float(),
                         cast(p["wk_b"], dt).float())
    if torch.is_tensor(cache["c_kv"]):
        out_lat = _latent_whole(q_abs, q_rope, c_new, kr_new, pos, cache,
                                cfg, dt)
    else:  # split over cache_seq on a mesh
        out_lat = _mla_decode_pieces(x, cache, cfg, pos, c_new, kr_new,
                                     q_abs, q_rope, ctx.data_slot)
    out = torch.einsum("bhr,rhk->bhk", out_lat, cast(p["wv_b"], dt))
    y = torch.einsum("bhk,hkd->bd", out, cast(p["wo"], dt))[:, None, :]
    return y, cache


def _mla_decode_tp(p, x, cache, ctx: ShardCtx, cfg):
    """Absorbed decode on a tensor-parallel mesh: each model slot
    absorbs ``wk_b`` into its heads of q; q is joined on the data slot
    (an all-gather), attends the latent cache there (or its pieces), and
    each slot takes its heads of the latent output for ``wv_b`` and
    ``wo``."""
    pos = ctx.positions
    dt = x.dtype
    c_new, kr_new, q_nope, q_rope = _latent_tp(p, x, ctx, cfg, pos)
    q_abs = ctx.whole(tp_product(
        q_nope, p["wk_b"], ctx, fn=_einsum("bohk,rhk->bhr", dt, f32=True),
        contract=(2,), shared=((1, 2, 1),)))
    q_rope = ctx.whole(q_rope)
    if torch.is_tensor(cache["c_kv"]):
        out_lat = _latent_whole(q_abs, q_rope, c_new, kr_new, pos, cache,
                                cfg, dt)
    else:
        out_lat = _mla_decode_pieces(x, cache, cfg, pos, c_new, kr_new,
                                     q_abs, q_rope, ctx.data_slot)
    out = tp_product(out_lat, p["wv_b"], ctx, fn=_einsum("bhr,rhk->bhk", dt),
                     contract=(0,), shared=((1, 1, 1),))
    y = tp_product(out, p["wo"], ctx, fn=_einsum("bhk,hkd->bd", dt),
                   contract=(0, 1))
    return ctx.whole(y)[:, None, :]


def _latent_whole(q_abs, q_rope, c_new, kr_new, pos, cache, cfg, dt):
    """The latent output (B, H, kr) against a cache held whole: the new
    latent written at slot ``pos``."""
    b = q_abs.shape[0]
    slot = pos[:, 0].long()
    bidx = torch.arange(b, device=q_abs.device)
    c, krope, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    c[bidx, slot] = c_new[:, 0]
    krope[bidx, slot] = kr_new[:, 0]
    cpos[bidx, slot] = pos[:, 0].to(cpos.dtype)
    s_lat = torch.einsum("bhr,bsr->bhs", q_abs, c.float())
    s_rope = torch.einsum("bohk,bsk->bhs", q_rope.float(), krope.float())
    s = (s_lat + s_rope) * _scale(cfg)
    valid = (cpos[:, None, :] <= pos[:, :1][:, None, :]) & (cpos[:, None, :] >= 0)
    s = torch.where(valid, s, NEG)
    a = torch.softmax(s, dim=-1).to(dt)  # (B,H,S)
    return torch.einsum("bhs,bsr->bhr", a, c)  # (B,H,kr)


def _mla_decode_pieces(x, cache, cfg, pos, c_new, kr_new, q_abs, q_rope,
                       data_slot=None):
    """The latent output (B, H, kr) of an absorbed decode against a
    latent cache split along its sequence (`SeqShards`): the new latent
    written into the piece owning slot ``pos``, each piece's partial
    softmax (max, sum, latent sum) on its device in float32 (its slot
    issuing the work), merged by log-sum-exp on x's device."""
    from ..distributed.placement import issuing
    from .attention import merge_pieces

    dt = x.dtype
    n = cache["c_kv"].length
    parts = []
    for (lo, hi, c, dev), (_, _, kr, _), (_, _, cp, _), tag in zip(
            cache["c_kv"].parts, cache["k_rope"].parts, cache["pos"].parts,
            cache["c_kv"].slots):
        with issuing(tag):
            parts.append(_latent_piece(q_abs, q_rope, c_new, kr_new, pos,
                                       (lo, hi, n), (c, kr, cp), dev, cfg))
    return merge_pieces(parts, x.device, data_slot).to(dt)  # (B,H,kr)


def _latent_piece(q_abs, q_rope, c_new, kr_new, pos, span, piece, dev, cfg):
    """One piece ``(c_kv, k_rope, pos)`` holding slots ``span`` ``(lo,
    hi, n)`` of ``n``: the new latent written where its slot falls, the
    piece's (max, sum, latent sum) on its device."""
    (lo, hi, n), (c, kr, cp) = span, piece
    b = q_abs.shape[0]
    bidx = torch.arange(b, device=dev)
    p_d = pos.to(dev)
    slot = p_d[:, 0].long() % n
    write_ring_piece(c, bidx, slot, lo, hi, c_new[:, 0].to(dev))
    write_ring_piece(kr, bidx, slot, lo, hi, kr_new[:, 0].to(dev))
    write_ring_piece(cp, bidx, slot, lo, hi, p_d[:, 0])
    s_lat = torch.einsum("bhr,bsr->bhs", q_abs.to(dev), c.float())
    s_rope = torch.einsum("bohk,bsk->bhs", q_rope.float().to(dev), kr.float())
    s = (s_lat + s_rope) * _scale(cfg)
    valid = (cp[:, None, :] <= p_d[:, :1][:, None, :]) & (cp[:, None, :] >= 0)
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, e.sum(dim=-1), torch.einsum("bhs,bsr->bhr", e, c.float())
