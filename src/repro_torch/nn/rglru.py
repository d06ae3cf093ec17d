"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of `repro.nn.rglru`:

    r_t = σ(W_a x_t + b_a)          recurrence gate
    i_t = σ(W_x x_t + b_x)          input gate
    a_t = exp(−c · softplus(Λ) · r_t),   c = 8
    h_t = a_t h_{t−1} + sqrt(1 − a_t²) · (i_t ⊙ x_t)

plus the surrounding temporal block: linear → causal conv1d(4) → RG-LRU,
gated by a GeLU branch.  The reference evaluates the linear recurrence
with ``lax.associative_scan``; here it is the same recurrence walked
step by step in float32 (`linear_scan`), equal up to the order of
rounding.

On a tensor-parallel mesh the block splits over its channels (``ff``),
as the reference's constraint on ``u`` splits it: ``gate_proj`` and
``rec_proj`` column-parallel, each model slot's conv on its block of
``conv_w``, the gates' ``w_a``/``w_x`` row-parallel with their partial
sums reduce-scattered back onto the channels (`ShardCtx.scatter`), the
scan on each slot's channels, ``out_proj`` row-parallel.  The decode
state and conv tail, cut over ``ff``, are read and written in place in
each slot's piece.  A block whose weights keep ``ff`` whole runs on the
data slot's device.
"""
from __future__ import annotations

import torch

from .common import (ParamDecl, ShardCtx, Split, cast, slot_block, tp_layout,
                     tp_product)
from .layers import gelu
from .ssd import causal_conv1d, softplus

_C = 8.0


def rglru_decls(cfg) -> dict:
    d, dr = cfg.d_model, cfg.rglru_width
    f32 = torch.float32
    return {
        "gate_proj": ParamDecl((d, dr), f32, ("d_model", "ff"), "fan_in"),
        "rec_proj": ParamDecl((d, dr), f32, ("d_model", "ff"), "fan_in"),
        "conv_w": ParamDecl((cfg.conv_width, dr), f32, (None, "ff"), "fan_in"),
        "conv_b": ParamDecl((dr,), f32, ("ff",), "zeros"),
        "w_a": ParamDecl((dr, dr), f32, ("ff", None), "fan_in"),
        "b_a": ParamDecl((dr,), f32, (None,), "zeros"),
        "w_x": ParamDecl((dr, dr), f32, ("ff", None), "fan_in"),
        "b_x": ParamDecl((dr,), f32, (None,), "zeros"),
        "lambda_p": ParamDecl((dr,), f32, (None,), "ones"),
        "out_proj": ParamDecl((dr, d), f32, ("ff", "d_model"), "fan_in"),
    }


def _gates(p, x):
    """x: (..., dr) → (a, gated_in) in f32."""
    return _gate_values(x @ p["w_a"].to(x.dtype), x @ p["w_x"].to(x.dtype),
                        p["b_a"], p["b_x"], p["lambda_p"], x)


def _gate_values(ra, rx, b_a, b_x, lam, x):
    """The gates from the projections ``ra``/``rx`` of ``x``."""
    r = torch.sigmoid(ra.float() + b_a)
    i = torch.sigmoid(rx.float() + b_x)
    log_a = -_C * softplus(lam) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * x.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t along axis 1 from h = 0, in float32: the
    second component of the reference's associative scan of (a, b).
    Its backward walks the recurrence back (the gradient autograd takes
    of the forward's steps: the same products and sums)."""
    return _LinearScan.apply(a, b)


def _steps(n: int, like: torch.Tensor):
    """The steps ``1 .. n − 1`` of a walk, or, on ``meta`` tensors (which
    carry no values), step 1 standing for all of them."""
    from ..distributed.placement import repeated

    if not like.is_meta or n <= 2:
        yield from range(1, n)
        return
    with repeated(n - 1):
        yield 1


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = torch.empty_like(b)
        prev = b[:, 0]
        h[:, 0] = prev
        for t in _steps(b.shape[1], b):
            prev = a[:, t] * prev + b[:, t]
            h[:, t] = prev
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        n = h.shape[1]
        da = torch.zeros_like(a)
        db = torch.empty_like(dh)
        g = dh[:, n - 1]
        db[:, n - 1] = g
        for t in _steps(n, h):
            t = n - t  # n − 1 down to 1
            da[:, t] = g * h[:, t - 1]
            g = dh[:, t - 1] + g * a[:, t]
            db[:, t - 1] = g
        return da, db


def _rglru_tp(p, x, ctx: ShardCtx, cache=None):
    """The block on a tensor-parallel mesh: (y, the new (h, conv tail)
    as `Split`s over channels, or None where ``ff`` stays whole).
    ``cache``: decode's (h, conv tail) views cut over ``model``, or
    None for the full sequence."""
    if tp_layout(p["rec_proj"], (0,))[0] == "replicated":
        if any(isinstance(c, Split) for c in (cache or {}).values()):
            raise ValueError("an RG-LRU cache cut over model where "
                             "rec_proj keeps ff whole")
        return None  # ff whole: the block on the data slot
    xs = ctx.fan_out(x)
    gate = tp_product(xs, p["gate_proj"], ctx)
    u = tp_product(xs, p["rec_proj"], ctx)
    if not all(isinstance(t, Split) and t.dim == 2 for t in (gate, u)):
        raise ValueError(f"gate_proj {p['gate_proj'].spec} and rec_proj "
                         f"{p['rec_proj'].spec}: no product takes them")
    if cache is not None and not all(
            isinstance(c, Split) for c in cache.values()):
        raise ValueError("an RG-LRU cache not cut over model with its "
                         "channels")

    def rng(s):
        return p["rec_proj"].model_range(s.m)[1]

    def conv(s, um):
        r = rng(s)
        tail = None if cache is None else cache["conv_tail"].parts[s.m]
        return causal_conv1d(um, slot_block(p["conv_w"], s, ctx, 1, r),
                             slot_block(p["conv_b"], s, ctx, 0, r), tail)

    uc = ctx.per_slot(conv, u)
    u = Split([t[0] for t in uc], 2)

    def on_channels(y):  # the gate's projection, each slot its channels
        if isinstance(y, Split):
            return ctx.scatter(y, 2) if y.dim == "sum" else y

        def own(s, ym):  # replicated: the slot's slice
            a, b = rng(s)
            return ym.narrow(2, a, b - a)

        return Split(ctx.per_slot(own, ctx.fan_out(y)), 2)

    ra, rx = (on_channels(tp_product(u, p[k], ctx)) for k in ("w_a", "w_x"))

    def scan(s, um, gm, ram, rxm):
        r = rng(s)
        a, b = _gate_values(ram, rxm, *(slot_block(p[k], s, ctx, 0, r)
                                        for k in ("b_a", "b_x", "lambda_p")),
                            um)
        if cache is None:
            h = linear_scan(a, b).to(x.dtype)
            return h * gelu(gm), h[:, -1].float()
        h = a[:, 0] * cache["h"].parts[s.m] + b[:, 0]
        return h[:, None].to(x.dtype) * gelu(gm), h

    hs = ctx.per_slot(scan, u, gate, ra, rx)
    y = ctx.whole(tp_product(Split([t[0] for t in hs], 2), p["out_proj"],
                             ctx))
    return y, Split([t[1] for t in hs], 1), Split([t[1] for t in uc], 2)


def rglru_apply(p, x, ctx: ShardCtx, cfg, meta):
    """x: (B, S, d) → (y, cache|None)."""
    if ctx.tp:
        out = _rglru_tp(p, x, ctx)
        if out is not None:
            y, h, tail = out
            cache = {"h": h, "conv_tail": tail} if ctx.make_cache else None
            return y, cache
        p = ctx.replicated(p)
    gate = gelu(x @ cast(p["gate_proj"], x.dtype))
    u = x @ cast(p["rec_proj"], x.dtype)
    u, conv_tail = causal_conv1d(u, p["conv_w"], p["conv_b"])
    a, b = _gates(p, u)
    h = linear_scan(a, b).to(x.dtype)
    y = (h * gate) @ cast(p["out_proj"], x.dtype)
    cache = None
    if ctx.make_cache:
        cache = {"h": h[:, -1].float(), "conv_tail": conv_tail}
    return y, cache


def rglru_decode(p, x, cache, ctx: ShardCtx, cfg, meta):
    """Single step: x (B, 1, d); the state and conv tail are written into
    ``cache``'s tensors in place."""
    if ctx.tp:
        out = _rglru_tp(p, x, ctx, cache)
        if out is not None:
            y, h, tail = out
            for key, new in (("h", h), ("conv_tail", tail)):
                ctx.per_slot(lambda s, c, n: c.copy_(n), cache[key], new)
            return y, cache
        p = ctx.replicated(p)
    gate = gelu(x @ cast(p["gate_proj"], x.dtype))
    u = x @ cast(p["rec_proj"], x.dtype)
    u, conv_tail = causal_conv1d(u, p["conv_w"], p["conv_b"],
                                 tail=cache["conv_tail"])
    a, b = _gates(p, u)  # (B,1,dr)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ cast(p["out_proj"], x.dtype)
    cache["h"].copy_(h)
    cache["conv_tail"].copy_(conv_tail)
    return y, cache
