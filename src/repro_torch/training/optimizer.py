"""Optimizers of the port: AdamW with float32 moments, and factored
Adafactor for the huge MoE archs whose full second moments do not fit
(deepseek-v3 uses it) — `repro.training.optimizer` in PyTorch.

The states are trees mirroring the params, under the reference's names:
``{"m", "v"}`` for AdamW, ``{"f": {…{"vr", "vc"} | {"v"}}}`` for
Adafactor.  Unlike the reference, an update works in place: it writes the
new moments into the state's tensors and the new parameters into the
params' tensors, leaf by leaf, with the reference's operations in its
order (float32 arithmetic, each parameter cast back to its own dtype).
At qwen2.5-3b's full width params, grads, m and v are 12.3 GB each; an
out-of-place update would hold a second copy of each next to them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..nn.common import flatten_tree, map_tree

__all__ = ["OptHParams", "adafactor_init", "adafactor_update", "adamw_init",
           "adamw_update", "clip_by_global_norm", "global_norm",
           "make_optimizer", "schedule"]


@dataclasses.dataclass(frozen=True)
class OptHParams:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    min_lr_ratio: float = 0.1


def schedule(hp: OptHParams, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, a float32 0-d
    tensor on ``step``'s device (the reference's float32 arithmetic)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = hp.min_lr_ratio + (1 - hp.min_lr_ratio) * cos
    return hp.learning_rate * warm * decay


def _leaves(tree) -> list:
    return list(flatten_tree(tree).values())


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32."""
    total = None
    for x in _leaves(tree):
        s = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf of ``tree`` in place by min(1, max_norm / ‖tree‖);
    returns (tree, ‖tree‖)."""
    g = global_norm(tree)
    factor = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    for x in _leaves(tree):
        if x.dtype == torch.float32:
            x.mul_(factor)
        else:  # the product in float32, rounded once to the leaf's dtype
            x.copy_(x.float().mul_(factor))
    return tree, g


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _apply(p: torch.Tensor, u: torch.Tensor, lr: torch.Tensor,
           weight_decay: float) -> None:
    """p ← p − lr·(u + wd·p), in float32, rounded to p's dtype; ``u`` is
    overwritten."""
    p32 = _as_f32(p)
    u.add_(weight_decay * p32)
    if p32 is p:
        p.sub_(u.mul_(lr))
    else:
        p.copy_(p32.sub_(u.mul_(lr)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def adamw_update(grads, state, params, step, hp: OptHParams):
    """One AdamW step in place; returns (params, state), the same trees."""
    lr = schedule(hp, step)
    t = torch.as_tensor(step).to(torch.float32) + 1.0
    bc1 = 1 - hp.b1 ** t
    bc2 = 1 - hp.b2 ** t
    flat_g, flat_m, flat_v = (flatten_tree(x) for x in
                              (grads, state["m"], state["v"]))
    for name, p in flatten_tree(params).items():
        g, m, v = _as_f32(flat_g[name]), flat_m[name], flat_v[name]
        m.mul_(hp.b1).add_((1 - hp.b1) * g)
        v.mul_(hp.b2).add_((1 - hp.b2) * g * g)
        u = m / bc1
        u.div_(torch.sqrt(v / bc2).add_(hp.eps))
        _apply(p, u, lr, hp.weight_decay)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment) — memory ~0 extra
# ---------------------------------------------------------------------------


def adafactor_init(params):
    def fac(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    return {"f": map_tree(fac, params)}


def adafactor_update(grads, state, params, step, hp: OptHParams):
    """One Adafactor step in place; returns (params, state), the same
    trees."""
    lr = schedule(hp, step)
    decay = 1.0 - (torch.as_tensor(step).to(torch.float32) + 1.0) ** -0.8
    flat_g = flatten_tree(grads)
    flat_f = state["f"]
    for name, p in flatten_tree(params).items():
        g = _as_f32(flat_g[name])
        f = _subtree(flat_f, name)
        g2 = g * g + 1e-30
        if p.ndim >= 2:
            vr, vc = f["vr"], f["vc"]
            vr.mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
            vc.mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
            del g2
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                   min=1e-30))
            u = g / torch.sqrt(denom.add_(1e-30))
            del denom
        else:
            v = f["v"]
            v.mul_(decay).add_((1 - decay) * g2)
            u = g / torch.sqrt(v + 1e-30)
        # update clipping (RMS ≤ 1), as in the Adafactor paper
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms, min=1.0))
        _apply(p, u, lr, hp.weight_decay)
    return params, state


def _subtree(tree, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def make_optimizer(name: str) -> tuple[Callable, Callable]:
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
