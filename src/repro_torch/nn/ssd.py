"""Mamba-2 mixer: State Space Duality (SSD), chunked algorithm.

The port of `repro.nn.ssd`.  The paper's recurrence
    h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t,   y_t = C_t·h_t + D·x_t
evaluated chunk-wise (quadratic within a Q-token chunk via the decay
matrix L, linear across chunks through the carried state).  Includes the
depthwise causal conv1d (width 4) over the xBC stream — a literal FIR
filter bank — and its BLMAC bit-layer evaluation (`blmac_conv1d`) for
quantized weights.

On a tensor-parallel mesh the mixer splits over its heads.  ``in_proj``
is column-parallel over its stored blocks of z | x | B | C | dt, which
do not line up with the heads, so its output is re-cut by
point-to-point moves (`ShardCtx.regroup`): each model slot receives its
heads' z and dt and the conv channels of its ``conv_w`` block, runs the
conv there (with its piece of the decode conv tail, in place), and a
second re-cut hands it its heads' x and B and C whole.  Each slot scans
its heads (``a_log``, ``dt_bias``, ``d_skip`` and its piece of the
decode state by heads); the gated norm's sum of squares is all-reduced
over ``model``; ``out_proj`` is row-parallel over ``heads_flat``.  A
mixer whose weights keep ``heads_flat`` whole runs on the data slot's
device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (ParamDecl, ShardCtx, Split, cast, slot_block, tp_layout,
                     tp_product)


def ssd_decls(cfg) -> dict:
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    n, g = cfg.ssm_state, 1  # single B/C group
    conv_ch = d_in + 2 * g * n
    f32 = torch.float32
    return {
        "in_proj": ParamDecl(
            (cfg.d_model, 2 * d_in + 2 * g * n + cfg.ssm_heads), f32,
            ("d_model", "heads_flat"), "fan_in"),
        "conv_w": ParamDecl((cfg.conv_width, conv_ch), f32,
                            (None, "heads_flat"), "fan_in"),
        "conv_b": ParamDecl((conv_ch,), f32, ("heads_flat",), "zeros"),
        "a_log": ParamDecl((cfg.ssm_heads,), f32, ("heads",), "zeros"),
        "dt_bias": ParamDecl((cfg.ssm_heads,), f32, ("heads",), "zeros"),
        "d_skip": ParamDecl((cfg.ssm_heads,), f32, ("heads",), "ones"),
        "norm_scale": ParamDecl((d_in,), f32, ("heads_flat",), "ones"),
        "out_proj": ParamDecl((d_in, cfg.d_model), f32,
                              ("heads_flat", "d_model"), "fan_in"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv1d(x, w, b, tail=None):
    """Depthwise causal conv.  x: (B, S, Ch), w: (W, Ch).  ``tail`` is the
    (B, W-1, Ch) history for decode continuity; zeros when None."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * cast(w[0], x.dtype)
    for i in range(1, width):
        y = y + xp[:, i : i + s] * cast(w[i], x.dtype)
    return F.silu(y + cast(b, x.dtype)), xp[:, -(width - 1):]


def blmac_conv1d(x, trits, exponent, b, tail=None):
    """BLMAC bit-layer evaluation of the same conv: weights are CSD trit
    planes (L, W, Ch) in {-1,0,+1}; one masked add per plane·tap — no
    weight multiplies (serving path for quantized checkpoints)."""
    n_layers, width, ch = trits.shape
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for layer in range(n_layers - 1, -1, -1):  # MSB → LSB (Eq. 2)
        acc = acc * 2.0
        for i in range(width):
            t = trits[layer, i]  # (Ch,) in {-1,0,1}
            sign = torch.where(t == 0, 0.0, torch.where(t > 0, 1.0, -1.0))
            acc = acc + sign * xp[:, i : i + s].float()
    y = acc * (2.0 ** float(-exponent)) + cast(b, torch.float32)
    return F.silu(y).to(x.dtype), xp[:, -(width - 1):]


def _split(p, x, cfg):
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    n = cfg.ssm_state
    zxbcdt = x @ cast(p["in_proj"], x.dtype)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : 2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n :]
    return z, xbc, dt


def _gated_norm(p, y, z, eps=1e-6):
    g = y * F.silu(z)
    gf = g.float()
    var = (gf * gf).mean(dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * p["norm_scale"]).to(y.dtype)


def _chunked(xs, bmat, cmat, dt, dt_bias, a_log, chunk: int):
    """The chunked scan from a zero state: xs (B, S, H, P), B and C
    (B, S, N), dt (B, S, H) before its bias → (y (B, S, H, P), the final
    state (B, H, N, P))."""
    bsz, s, h, pdim = xs.shape
    n = bmat.shape[-1]
    dt = softplus(dt.float() + dt_bias)  # (B,S,H)
    a = -torch.exp(a_log)  # (H,)
    da = dt * a  # (B,S,H) ≤ 0

    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    # the pairs j > i, whose exp(cs_i − cs_j) overflows on a long chunk:
    # masked before the exp, so that their gradient is 0, not 0·inf
    later = torch.triu(torch.ones((q, q), dtype=torch.bool,
                                  device=xs.device), 1)[None, :, :, None]
    state = torch.zeros((bsz, h, n, pdim), dtype=xs.dtype, device=xs.device)
    ys = []
    for i in range(nc):
        sl = slice(i * q, (i + 1) * q)
        xc, dtc, dac, bc, cc = xs[:, sl], dt[:, sl], da[:, sl], bmat[:, sl], \
            cmat[:, sl]
        cs = torch.cumsum(dac, dim=1)  # (B,Q,H) f32, ≤ 0
        # intra-chunk: L[i,j] = exp(cs_i − cs_j) for i ≥ j
        li = cs[:, :, None, :] - cs[:, None, :, :]  # (B,Qi,Qj,H)
        decay = torch.exp(li.masked_fill(later, -torch.inf)).to(xc.dtype)
        cb = torch.einsum("bin,bjn->bij", cc, bc)[..., None]
        w_ij = cb * decay * dtc.to(xc.dtype)[:, None, :, :]
        y_diag = torch.einsum("bijh,bjhp->bihp", w_ij, xc)
        # contribution of the state entering the chunk
        y_off = torch.einsum("bqn,bqh,bhnp->bqhp",
                             cc, torch.exp(cs).to(xc.dtype), state)
        # chunk-final state
        decay_end = torch.exp(cs[:, -1:, :] - cs)  # (B,Q,H)
        sb = torch.einsum("bqh,bqn,bqhp->bhnp",
                          (dtc * decay_end).to(xc.dtype), bc, xc)
        chunk_decay = torch.exp(cs[:, -1, :]).to(state.dtype)  # (B,H)
        state = state * chunk_decay[:, :, None, None] + sb
        ys.append(y_diag + y_off)  # (B,Q,H,P)
    return torch.cat(ys, dim=1), state


def _step(xs, bvec, cvec, dt, dt_bias, a_log, prev):
    """One recurrence step: xs (B, H, P), B and C (B, N), dt (B, H)
    before its bias, the state ``prev`` (B, H, N, P) → (y (B, H, P), the
    new state)."""
    dt = softplus(dt.float() + dt_bias)  # (B,H)
    a = -torch.exp(a_log)
    decay = torch.exp(dt * a).to(xs.dtype)  # (B,H)
    state = prev * decay[:, :, None, None]
    state = state + torch.einsum(
        "bh,bn,bhp->bhnp", dt.to(xs.dtype), bvec, xs
    )
    return torch.einsum("bn,bhnp->bhp", cvec, state), state


def ssd_apply(p, x, ctx: ShardCtx, cfg, meta, chunk: int | None = None):
    """Full-sequence SSD.  Returns (y, cache|None) where cache carries the
    final SSM state and conv tail for decode continuation."""
    if chunk is None:
        chunk = cfg.ssm_chunk
    if ctx.tp:
        out = _ssd_tp(p, x, ctx, cfg, chunk)
        if out is not None:
            y, state, tail = out
            cache = {"state": state, "conv_tail": tail} \
                if ctx.make_cache else None
            return y, cache
        p = ctx.replicated(p)
    bsz, s, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * pdim
    z, xbc, dt = _split(p, x, cfg)
    xbc, conv_tail = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in].reshape(bsz, s, h, pdim)
    bmat = xbc[..., d_in : d_in + n]  # (B,S,N): one B/C group
    cmat = xbc[..., d_in + n :]
    y, state = _chunked(xs, bmat, cmat, dt, p["dt_bias"], p["a_log"], chunk)
    y = y + xs * p["d_skip"][None, None, :, None].to(x.dtype)
    y = _gated_norm(p, y.reshape(bsz, s, d_in), z)
    out = y @ cast(p["out_proj"], x.dtype)
    cache = None
    if ctx.make_cache:
        cache = {"state": state, "conv_tail": conv_tail}
    return out, cache


def ssd_decode(p, x, cache, ctx: ShardCtx, cfg, meta):
    """Single-step recurrence.  x: (B, 1, d).  The state and conv tail
    are written into ``cache``'s tensors in place."""
    if ctx.tp:
        out = _ssd_tp(p, x, ctx, cfg, 1, cache)
        if out is not None:
            y, state, tail = out
            for key, new in (("state", state), ("conv_tail", tail)):
                ctx.per_slot(lambda s, c, t: c.copy_(t), cache[key], new)
            return y, cache
        p = ctx.replicated(p)
    bsz = x.shape[0]
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * pdim
    z, xbc, dt = _split(p, x, cfg)
    xbc, conv_tail = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                   tail=cache["conv_tail"])
    xs = xbc[:, 0, :d_in].reshape(bsz, h, pdim)
    bvec = xbc[:, 0, d_in : d_in + n]
    cvec = xbc[:, 0, d_in + n :]
    y, state = _step(xs, bvec, cvec, dt[:, 0], p["dt_bias"], p["a_log"],
                     cache["state"])
    y = y + xs * p["d_skip"][None, :, None].to(x.dtype)
    y = _gated_norm(p, y.reshape(bsz, 1, d_in), z)
    out = y @ cast(p["out_proj"], x.dtype)
    cache["state"].copy_(state)
    cache["conv_tail"].copy_(conv_tail)
    return out, cache


def _ssd_tp(p, x, ctx: ShardCtx, cfg, chunk: int, cache=None):
    """The mixer on a tensor-parallel mesh: (y, the final state `Split`
    over heads, the conv tail `Split` over ``conv_w``'s blocks), or None
    where ``in_proj`` keeps ``heads_flat`` whole.  ``cache``: decode's
    (state, conv tail) views cut over ``model``, or None for the full
    sequence (the state starts at zero)."""
    splits = [isinstance(c, Split) for c in (cache or {}).values()]
    if tp_layout(p["in_proj"], (0,))[0] == "replicated":
        if any(splits):
            raise ValueError("an SSD cache cut over model where in_proj "
                             "keeps heads_flat whole")
        return None
    if cache is not None and not all(splits):
        raise ValueError("an SSD cache not cut over model with its heads")
    bsz, s, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * pdim
    dt_ = x.dtype
    zx = tp_product(ctx.fan_out(x), p["in_proj"], ctx)
    if not (isinstance(zx, Split) and zx.dim == 2):
        raise ValueError(f"in_proj {p['in_proj'].spec}: no product takes it")
    slots = ctx.model_slots
    heads = []
    for sl in slots:  # each slot's heads: the rows of its out_proj block
        r0, r1 = p["out_proj"].model_range(sl.m)[0]
        if (r0, r1) == (0, d_in) or r0 % pdim or r1 % pdim:
            raise ValueError(f"out_proj {p['out_proj'].spec} does not cut "
                             f"the heads over model")
        heads.append((r0 // pdim, r1 // pdim))
    conv = [p["conv_w"].model_range(sl.m)[1] for sl in slots]
    # z | conv channels of the slot's conv_w block | dt, from in_proj's
    # blocks
    dt0 = 2 * d_in + 2 * n
    got = ctx.regroup(zx, [p["in_proj"].model_range(sl.m)[1] for sl in slots],
                      [[(h0 * pdim, h1 * pdim), (d_in + c0, d_in + c1),
                        (dt0 + h0, dt0 + h1)]
                       for (h0, h1), (c0, c1) in zip(heads, conv)])

    def conv1d(sl, xbc):
        rng = conv[sl.m]
        tail = None if cache is None else cache["conv_tail"].parts[sl.m]
        return causal_conv1d(xbc, slot_block(p["conv_w"], sl, ctx, 1, rng),
                             slot_block(p["conv_b"], sl, ctx, 0, rng), tail)

    cv = ctx.per_slot(conv1d, Split([g[1] for g in got], 2))
    # the slot's heads of x, and B and C whole
    xbc = ctx.regroup(Split([c[0] for c in cv], 2), conv,
                      [[(h0 * pdim, h1 * pdim), (d_in, d_in + 2 * n)]
                       for h0, h1 in heads])

    def scan(sl, zm, xm, bcm, dtm):
        hm = heads[sl.m]
        dt_bias, a_log, d_skip = (slot_block(p[k], sl, ctx, 0, hm)
                                  for k in ("dt_bias", "a_log", "d_skip"))
        xs = xm.reshape(bsz, s, -1, pdim)
        bmat, cmat = bcm[..., :n], bcm[..., n:]
        if cache is None:
            y, state = _chunked(xs, bmat, cmat, dtm, dt_bias, a_log, chunk)
            y = y + xs * d_skip[None, None, :, None].to(dt_)
        else:
            y, state = _step(xs[:, 0], bmat[:, 0], cmat[:, 0], dtm[:, 0],
                             dt_bias, a_log, cache["state"].parts[sl.m])
            y = (y + xs[:, 0] * d_skip[None, :, None].to(dt_))[:, None]
        g = (y.reshape(bsz, s, -1) * F.silu(zm)).float()
        return g, (g * g).sum(dim=-1, keepdim=True), state

    sc = ctx.per_slot(scan, Split([g[0] for g in got], 2),
                      Split([t[0] for t in xbc], 2),
                      Split([t[1] for t in xbc], 2),
                      Split([g[2] for g in got], 2))
    # the gated norm's mean square over the whole d_in (an all-reduce)
    var = ctx.fan_out(ctx.whole(Split([t[1] for t in sc], "sum")) / d_in)

    def normed(sl, g, vm):
        h0, h1 = heads[sl.m]
        scale = slot_block(p["norm_scale"], sl, ctx, 0,
                           (h0 * pdim, h1 * pdim))
        return (g * torch.rsqrt(vm + 1e-6) * scale).to(dt_)

    yn = Split(ctx.per_slot(normed, Split([t[0] for t in sc], 2), var), 2)
    out = ctx.whole(tp_product(yn, p["out_proj"], ctx))
    return out, Split([t[2] for t in sc], 1), Split([c[1] for c in cv], 2)
