"""GQA/MQA attention with chunked online-softmax (flash-style) evaluation.

The port of `repro.nn.attention`, in plain PyTorch.  One code path
serves every attention variant in the zoo: grouped KV heads, RoPE, QKV
bias (qwen), attention-logit softcap (gemma2), sliding windows (mixtral
/ gemma2-local / recurrentgemma), and ring-buffer KV caches whose masks
are driven purely by *absolute positions* stored next to the cache — so
a rotated ring never needs un-rotation; a slot at position −1 is empty.

The evaluation walks KV chunks with a running (max, sum, accumulator) and
never builds an (Sq × Skv) score matrix; for causal self-attention the
triangular form gives each query chunk only the KV chunks its mask can
reach.  The reference's chunk sizes are kept (``kv_chunk`` and its
adaptive choice), so both packages sum in the same order.

Decode writes the new token into the cache tensors **in place** (the
reference returns updated copies); `decode_step` returns the same
tensors.  A cache sharded over ``cache_seq`` on a mesh (`SeqShards`)
is attended piece by piece on each piece's device, the new token written
into the piece that owns its ring slot, and the pieces' running (max,
denominator, accumulator) merged by log-sum-exp (`combine_partials`, an
all-reduce over the pieces).

On a mesh with a ``model`` axis the projections follow `tp_product`'s
rule: each model slot projects q for its heads and k/v for its kv heads
(or takes its q heads' groups of a replicated k/v), attends them with
`chunked_attention`, and ``wo`` is row-parallel over heads.  The caches
keep their layout (the ring over ``model``, kv heads whole), so prefill
joins k/v over ``model`` for `build_kv_cache`, and decode attends the
new token's whole q against the ring's pieces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .common import (ParamDecl, ShardCtx, Split, cast, matmul, tp_bias,
                     tp_product)
from .layers import rope

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    """Static per-instance attention settings (one per block-pattern slot)."""

    window: int = 0  # 0 = global causal; >0 = sliding window
    kv_chunk: int = 1024
    triangular: bool = True  # skip fully-masked kv chunks (train/prefill)


# ---------------------------------------------------------------------------
# functional chunked attention
# ---------------------------------------------------------------------------


def _mask(q_pos, kv_pos, window):
    """(B, Sq), (B, C) → (B, 1, 1, Sq, C) validity."""
    qp = q_pos[:, None, None, :, None]
    kp = kv_pos[:, None, None, None, :]
    ok = (kp <= qp) & (kp >= 0)
    if window > 0:
        ok &= qp - kp < window
    return ok


def _chunk_scores(q, k_c, scale, softcap, kv_layout="bshd"):
    # q: (B, Sq, Hkv, G, D) → scores (B, Hkv, G, Sq, C)
    eq = "bqhgd,bhcd->bhgqc" if kv_layout == "bhsd" else "bqhgd,bchd->bhgqc"
    s = torch.einsum(eq, q, k_c).float() * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def _combine(carry, qg, q_pos, kc, vc, pc, scale, softcap, window,
             kv_layout="bshd"):
    """Online-softmax merge of one kv chunk into the running (max,
    denominator, accumulator)."""
    m, den, acc = carry
    s = _chunk_scores(qg, kc, scale, softcap, kv_layout)  # (B,Hkv,G,Sq,C)
    ok = _mask(q_pos, pc, window)
    s = torch.where(ok, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(ok, p, 0.0)
    den = den * alpha + p.sum(dim=-1)
    ev = "bhgqc,bhcv->bhgqv" if kv_layout == "bhsd" else "bhgqc,bchv->bhgqv"
    pv = torch.einsum(ev, p.to(vc.dtype), vc)
    acc = acc * alpha[..., None] + pv.float()
    return m_new, den, acc


def combine_partials(parts) -> torch.Tensor:
    """Merge online-softmax partials ``(max, denominator, accumulator)``
    of disjoint key sets (on one device) by log-sum-exp: the attention
    output over their union.  A part with no valid key (max −inf or the
    masked floor, denominator 0) adds nothing, and a union with none
    gives 0, never NaN."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    den, acc = None, None
    for mi, di, ai in parts:
        w = torch.exp(mi - m)
        den = di * w if den is None else den + di * w
        acc = ai * w[..., None] if acc is None else acc + ai * w[..., None]
    return acc / torch.clamp(den, min=1e-30)[..., None]


def _init_carry(b, hkv, g, sq, dv, device):
    return (torch.full((b, hkv, g, sq), NEG, dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                        device=device))


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Skv), -1 ⇒ invalid slot
    *,
    scale: float,
    window: int = 0,
    softcap: float | None = None,
    kv_chunk: int = 1024,
    triangular: bool = False,
    kv_layout: str = "bshd",  # decode caches use "bhsd"
) -> torch.Tensor:
    b, sq, h, d = q.shape
    if kv_layout == "bhsd":
        _, hkv, skv, dv = v.shape
    else:
        _, skv, hkv, dv = v.shape
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    c = min(kv_chunk, skv)
    if skv % c:
        raise ValueError(f"Skv={skv} not a multiple of kv_chunk={c}")
    n_chunks = skv // c
    s_axis = 2 if kv_layout == "bhsd" else 1

    def kv_slice(t, i, n=c):
        return t.narrow(s_axis, i * n, n)

    if triangular and sq == skv and n_chunks > 1:
        # Causal (optionally windowed) self-attention: process q in chunks
        # and give each q chunk only the kv chunks its mask can reach.
        out_chunks = []
        for qi in range(n_chunks):
            qc = qg[:, qi * c : (qi + 1) * c]
            qp = q_pos[:, qi * c : (qi + 1) * c]
            carry = _init_carry(b, hkv, g, c, dv, q.device)
            for ki in range(qi + 1):
                if window > 0 and qi * c - ((ki + 1) * c - 1) >= window:
                    continue  # statically unreachable through the window
                carry = _combine(carry, qc, qp, kv_slice(k, ki),
                                 kv_slice(v, ki),
                                 kv_pos[:, ki * c : (ki + 1) * c],
                                 scale, softcap, window, kv_layout)
            _, den, acc = carry
            out_chunks.append(acc / torch.clamp(den, min=1e-30)[..., None])
        out = torch.cat(out_chunks, dim=3)  # (B,Hkv,G,Sq,Dv)
    else:
        carry = _init_carry(b, hkv, g, sq, dv, q.device)
        for i in range(n_chunks):
            carry = _combine(carry, qg, q_pos, kv_slice(k, i), kv_slice(v, i),
                             kv_pos[:, i * c : (i + 1) * c],
                             scale, softcap, window, kv_layout)
        _, den, acc = carry
        out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# the attention mixer block
# ---------------------------------------------------------------------------


def attn_decls(cfg) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32 = torch.float32
    decls: dict[str, Any] = {
        "wq": ParamDecl((d, h, dh), f32, ("d_model", "heads", "head_dim"),
                        "fan_in"),
        "wk": ParamDecl((d, hkv, dh), f32,
                        ("d_model", "kv_heads", "head_dim"), "fan_in"),
        "wv": ParamDecl((d, hkv, dh), f32,
                        ("d_model", "kv_heads", "head_dim"), "fan_in"),
        "wo": ParamDecl((h, dh, d), f32, ("heads", "head_dim", "d_model"),
                        "fan_in", fan_axis=1),
    }
    if cfg.attn_bias:
        decls["bq"] = ParamDecl((h, dh), f32, ("heads", "head_dim"), "zeros")
        decls["bk"] = ParamDecl((hkv, dh), f32, ("kv_heads", "head_dim"), "zeros")
        decls["bv"] = ParamDecl((hkv, dh), f32, ("kv_heads", "head_dim"), "zeros")
    return decls


def _qkv(p, x, cfg, positions):
    dt = x.dtype
    q = matmul(x, cast(p["wq"], dt))
    k = matmul(x, cast(p["wk"], dt))
    v = matmul(x, cast(p["wv"], dt))
    if "bq" in p:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _qkv_tp(p, x, ctx: ShardCtx, cfg, positions):
    """q, k, v on a mesh, each a `Split` cut over its heads (dim 2) or a
    tensor on the data slot's device; biased, and roped on their own
    slots.  A projection cut over ``head_dim`` raises."""
    xs = ctx.fan_out(x)
    out = []
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = tp_product(xs, p[w], ctx)
        if b in p:
            y = tp_bias(y, p[b], ctx)
        if isinstance(y, Split) and y.dim == "sum":
            y = ctx.whole(y)
        if isinstance(y, Split) and y.dim != 2:
            raise ValueError(f"{w} cut over head_dim ({p[w].spec}): the "
                             f"attention takes its heads whole")
        out.append(y)
    q, k, v = out
    if cfg.pos_emb == "rope":
        def roped(t):
            if not isinstance(t, Split):
                return rope(t, positions, cfg.rope_theta)
            return Split(ctx.per_slot(lambda s, tm: rope(
                tm, positions.to(s.device), cfg.rope_theta), t), 2)

        q, k = roped(q), roped(k)
    return q, k, v


def _slot_kv(t, s, n_q: int, g: int) -> torch.Tensor:
    """The kv heads model slot ``s``'s ``n_q`` q heads attend, from the
    whole (B, S, Hkv, D) ``t`` (kv heads that do not split over the
    slots): the one kv head of all of them, or else one a q head."""
    if g % n_q == 0:
        return t.narrow(2, s.m * n_q // g, 1)
    idx = torch.arange(s.m * n_q, (s.m + 1) * n_q, device=t.device) // g
    return t.index_select(2, idx)


def _attn_tp(q, k, v, pos, ctx: ShardCtx, cfg, meta: AttnMeta, kvc: int):
    """Each model slot attends its q heads (a `Split` cut over heads);
    a whole q is attended on the data slot's device."""
    kw = dict(scale=_scale(cfg), window=meta.window, softcap=cfg.attn_softcap,
              kv_chunk=kvc, triangular=meta.triangular)
    if not isinstance(q, Split):
        k, v = ctx.whole(k), ctx.whole(v)
        return chunked_attention(q, k, v, pos, pos, **kw)
    g = cfg.n_heads // cfg.n_kv_heads
    n_q = q.parts[0].shape[2]
    if not isinstance(k, Split):
        k, v = ctx.fan_out(k), ctx.fan_out(v)
        pick = _slot_kv
    else:
        pick = None  # each slot holds its q heads' kv heads

    def one(s, qm, km, vm):
        if pick is not None:
            km, vm = pick(km, s, n_q, g), pick(vm, s, n_q, g)
        pm = pos.to(s.device)
        return chunked_attention(qm, km, vm, pm, pm, **kw)

    return Split(ctx.per_slot(one, q, k, v), 2)


def _scale(cfg) -> float:
    s = cfg.query_scale if cfg.query_scale else cfg.head_dim
    return 1.0 / math.sqrt(s)


def attn_apply(p, x, ctx: ShardCtx, cfg, meta: AttnMeta):
    """Full-sequence path (train & prefill).  Returns (y, cache | None).
    Unsharded, KV heads stay grouped (the reference's unsharded form)."""
    b, s, _ = x.shape
    pos = ctx.positions
    # adaptive chunk: the reference's (about 16 chunks per side)
    kvc = min(meta.kv_chunk, s) if s <= meta.kv_chunk else max(meta.kv_chunk, s // 16)
    if s % kvc:
        kvc = s
    if ctx.tp:
        q, k, v = _qkv_tp(p, x, ctx, cfg, pos)
        out = _attn_tp(q, k, v, pos, ctx, cfg, meta, kvc)
        y = ctx.whole(tp_product(out, p["wo"], ctx, n_in=2))
        cache = None
        if ctx.make_cache:
            cache = build_kv_cache(ctx.whole(k), ctx.whole(v), pos,
                                   ctx.cache_len, meta.window)
        return y, cache
    q, k, v = _qkv(p, x, cfg, pos)
    out = chunked_attention(
        q, k, v, pos, pos,
        scale=_scale(cfg), window=meta.window, softcap=cfg.attn_softcap,
        kv_chunk=kvc, triangular=meta.triangular,
    )
    y = matmul(out, cast(p["wo"], x.dtype), 2)
    cache = None
    if ctx.make_cache:
        cache = build_kv_cache(k, v, pos, ctx.cache_len, meta.window)
    return y, cache


def cache_size(cache_len: int, window: int) -> int:
    return min(cache_len, window) if window > 0 else cache_len


def build_kv_cache(k, v, pos, cache_len: int, window: int) -> dict:
    """Build a (ring) cache from prefilled K/V (rope already applied).

    Layout is (B, Hkv, W, Dh): the decode einsums read it without
    per-chunk transposes; the one transpose here is paid once."""
    b, s, hkv, dh = k.shape
    w = cache_size(cache_len, window)
    dev = k.device
    ck = torch.zeros((b, hkv, w, dh), dtype=k.dtype, device=dev)
    cv = torch.zeros((b, hkv, w, v.shape[-1]), dtype=v.dtype, device=dev)
    cp = torch.full((b, w), -1, dtype=torch.int32, device=dev)
    take = min(s, w)
    ks = k[:, s - take :].transpose(1, 2)  # (B, Hkv, take, Dh)
    vs = v[:, s - take :].transpose(1, 2)
    ps = pos[:, s - take :].long()
    slots = ps % w  # unique because positions are consecutive, take <= w
    bidx = torch.arange(b, device=dev)[:, None, None]
    hidx = torch.arange(hkv, device=dev)[None, :, None]
    ck[bidx, hidx, slots[:, None, :]] = ks
    cv[bidx, hidx, slots[:, None, :]] = vs
    cp[torch.arange(b, device=dev)[:, None], slots] = ps.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cp}


def _decode_chunk(w: int, kv_chunk: int) -> int:
    kvc = min(kv_chunk, w) if w <= kv_chunk else max(kv_chunk, w // 64)
    return w if w % kvc else kvc


def write_ring_piece(t, bidx, slot, lo: int, hi: int, new, head_dims=()):
    """Write ``new[b]`` into row ``b`` of ``t`` — a piece holding ring
    slots ``[lo, hi)`` of a cache — at ``slot[b] − lo``, for the rows
    whose slot falls in the piece; other rows keep their entries.  No
    host sync: the rows are chosen by ``torch.where``, not by indexing.
    ``head_dims``: index tensors of the dims between the row and the
    slot (the kv heads)."""
    sel = (slot >= lo) & (slot < hi)
    loc = torch.clamp(slot - lo, 0, hi - lo - 1)
    at = (bidx[:, None], *(h[None, :] for h in head_dims), loc[:, None]) \
        if head_dims else (bidx, loc)
    keep = sel.reshape(sel.shape + (1,) * (new.dim() - 1))
    t[at] = torch.where(keep, new.to(t.dtype), t[at])


def merge_pieces(parts, device, slot) -> torch.Tensor:
    """`combine_partials` of the pieces' partials on ``device``, recorded
    as an all-reduce over the pieces."""
    from ..distributed.placement import record_collective

    parts = [tuple(t.to(device) for t in p) for p in parts]
    if len(parts) > 1:
        n = sum(t.numel() * t.element_size() for t in parts[0])
        record_collective("all-reduce", n * len(parts), n, len(parts), slot)
    return combine_partials(parts)


def _attn_decode_pieces(q, k, v, pos, cache, cfg, meta: AttnMeta,
                        slot=None):
    """Decode against a cache split along its ring (`SeqShards`): write
    the new k/v into the piece owning slot ``pos % W``, attend each
    piece on its device (its slot issuing the work), merge on q's
    device."""
    from ..distributed.placement import issuing

    b, sq, h, d = q.shape
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    w = ck.length
    hkv = ck.parts[0][2].shape[1]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    kvc = _decode_chunk(w, meta.kv_chunk)
    parts = []
    for (lo, hi, tk, dev), (_, _, tv, _), (_, _, tp, _), tag in zip(
            ck.parts, cv.parts, cp.parts, ck.slots):
        with issuing(tag):
            parts.append(_attend_piece(qg, k, v, pos, (lo, hi), (tk, tv, tp),
                                       dev, w, kvc, cfg, meta))
    out = merge_pieces(parts, q.device, slot)  # (B, Hkv, G, Sq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1).to(q.dtype)


def _attend_piece(qg, k, v, pos, span, piece, dev, w, kvc, cfg, meta):
    """One ring piece ``(k, v, pos)`` holding slots ``span``: the new
    k/v written where their slot falls, the piece's online-softmax
    partial on its device."""
    (lo, hi), (tk, tv, tp) = span, piece
    b, sq, hkv, g, _ = qg.shape
    bidx = torch.arange(b, device=dev)
    hidx = torch.arange(hkv, device=dev)
    p_d = pos.to(dev)
    slot = p_d[:, 0].long() % w
    write_ring_piece(tk, bidx, slot, lo, hi, k[:, 0].to(dev), (hidx,))
    write_ring_piece(tv, bidx, slot, lo, hi, v[:, 0].to(dev), (hidx,))
    write_ring_piece(tp, bidx, slot, lo, hi, p_d[:, 0])
    n = hi - lo
    c = min(kvc, n) if n % min(kvc, n) == 0 else n
    carry = _init_carry(b, hkv, g, sq, tv.shape[-1], dev)
    qd = qg.to(dev)
    for i in range(n // c):
        carry = _combine(carry, qd, p_d, tk.narrow(2, i * c, c),
                         tv.narrow(2, i * c, c), tp[:, i * c:(i + 1) * c],
                         _scale(cfg), cfg.attn_softcap, meta.window,
                         "bhsd")
    return carry


def attn_decode(p, x, cache: dict, ctx: ShardCtx, cfg, meta: AttnMeta):
    """Single-token decode: x (B, 1, d); cache slots addressed pos % W,
    written in place."""
    pos = ctx.positions  # (B, 1) current absolute position
    if ctx.tp:
        q, k, v = (ctx.whole(t) for t in _qkv_tp(p, x, ctx, cfg, pos))
    else:
        q, k, v = _qkv(p, x, cfg, pos)
    if not torch.is_tensor(cache["k"]):  # split over cache_seq on a mesh
        out = _attn_decode_pieces(q, k, v, pos, cache, cfg, meta,
                                  ctx.data_slot)
    else:
        out = _attn_decode_whole(q, k, v, pos, cache, cfg, meta)
    if ctx.tp:
        return ctx.whole(tp_product(out, p["wo"], ctx, n_in=2)), cache
    return matmul(out, cast(p["wo"], x.dtype), 2), cache


def _attn_decode_whole(q, k, v, pos, cache: dict, cfg, meta: AttnMeta):
    """Decode against a cache held whole on q's device."""
    b = q.shape[0]
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    hkv, w = ck.shape[1], ck.shape[2]
    slot = pos[:, 0].long() % w
    dev = q.device
    bidx = torch.arange(b, device=dev)
    ck[bidx[:, None], torch.arange(hkv, device=dev)[None, :],
       slot[:, None]] = k[:, 0]
    cv[bidx[:, None], torch.arange(hkv, device=dev)[None, :],
       slot[:, None]] = v[:, 0]
    cp[bidx, slot] = pos[:, 0].to(cp.dtype)
    kvc = _decode_chunk(w, meta.kv_chunk)
    return chunked_attention(
        q, ck, cv, pos, cp,
        scale=_scale(cfg), window=meta.window, softcap=cfg.attn_softcap,
        kv_chunk=kvc, triangular=False, kv_layout="bhsd",
    )
