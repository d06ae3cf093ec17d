"""Mamba-2 mixer: State Space Duality (SSD), chunked algorithm.

The port of `repro.nn.ssd`.  The paper's recurrence
    h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t,   y_t = C_t·h_t + D·x_t
evaluated chunk-wise (quadratic within a Q-token chunk via the decay
matrix L, linear across chunks through the carried state).  Includes the
depthwise causal conv1d (width 4) over the xBC stream — a literal FIR
filter bank — and its BLMAC bit-layer evaluation (`blmac_conv1d`) for
quantized weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamDecl, ShardCtx, cast


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


def ssd_apply(p, x, ctx: ShardCtx, cfg, meta, chunk: int | None = None):
    """Full-sequence SSD.  Returns (y, cache|None) where cache carries the
    final SSM state and conv tail for decode continuation."""
    bsz, s, _ = x.shape
    if chunk is None:
        chunk = cfg.ssm_chunk
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * pdim
    z, xbc, dt = _split(p, x, cfg)
    xbc, conv_tail = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in].reshape(bsz, s, h, pdim)
    bmat = xbc[..., d_in : d_in + n]  # (B,S,N): one B/C group
    cmat = xbc[..., d_in + n :]
    dt = softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,)
    da = dt * a  # (B,S,H) ≤ 0

    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = torch.zeros((bsz, h, n, pdim), dtype=x.dtype, device=x.device)
    ys = []
    for i in range(nc):
        sl = slice(i * q, (i + 1) * q)
        xc, dtc, dac, bc, cc = xs[:, sl], dt[:, sl], da[:, sl], bmat[:, sl], \
            cmat[:, sl]
        cs = torch.cumsum(dac, dim=1)  # (B,Q,H) f32, ≤ 0
        # intra-chunk: L[i,j] = exp(cs_i − cs_j) for i ≥ j
        li = cs[:, :, None, :] - cs[:, None, :, :]  # (B,Qi,Qj,H)
        decay = torch.where(causal, torch.exp(li), 0.0).to(xc.dtype)
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
    y = torch.cat(ys, dim=1)
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
    bsz = x.shape[0]
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * pdim
    z, xbc, dt = _split(p, x, cfg)
    xbc, conv_tail = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                   tail=cache["conv_tail"])
    xs = xbc[:, 0, :d_in].reshape(bsz, h, pdim)
    bvec = xbc[:, 0, d_in : d_in + n]
    cvec = xbc[:, 0, d_in + n :]
    dt = softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a).to(x.dtype)  # (B,H)
    state = cache["state"] * decay[:, :, None, None]
    state = state + torch.einsum(
        "bh,bn,bhp->bhnp", dt.to(x.dtype), bvec, xs
    )
    y = torch.einsum("bn,bhnp->bhp", cvec, state)
    y = y + xs * p["d_skip"][None, :, None].to(x.dtype)
    y = _gated_norm(p, y.reshape(bsz, 1, d_in), z)
    out = y @ cast(p["out_proj"], x.dtype)
    cache["state"].copy_(state)
    cache["conv_tail"].copy_(conv_tail)
    return out, cache
