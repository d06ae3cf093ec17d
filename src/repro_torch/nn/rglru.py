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
"""
from __future__ import annotations

import torch

from .common import ParamDecl, ShardCtx, cast
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
    r = torch.sigmoid((x @ p["w_a"].to(x.dtype)).float() + p["b_a"])
    i = torch.sigmoid((x @ p["w_x"].to(x.dtype)).float() + p["b_x"])
    log_a = -_C * softplus(p["lambda_p"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * x.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t along axis 1 from h = 0, in float32: the
    second component of the reference's associative scan of (a, b)."""
    h = torch.empty_like(b)
    prev = b[:, 0]
    h[:, 0] = prev
    for t in range(1, b.shape[1]):
        prev = a[:, t] * prev + b[:, t]
        h[:, t] = prev
    return h


def rglru_apply(p, x, ctx: ShardCtx, cfg, meta):
    """x: (B, S, d) → (y, cache|None)."""
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
