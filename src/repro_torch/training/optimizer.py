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

On a mesh the leaves are `ShardedTensor`s: the element-wise work runs
piece by piece on each piece's device (replicas included, so they stay
equal), and what reduces over a leaf reads each distinct block once —
the clip's norm over canonical pieces, Adafactor's row and column means
added across the pieces of a sharded axis, its update RMS over the whole
leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..distributed.placement import ShardedTensor, all_reduce_sum
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


def _blocks(x) -> list:
    """A leaf's distinct blocks: its canonical pieces on a mesh."""
    if isinstance(x, ShardedTensor):
        return [x.pieces[i] for i in x.canonical()]
    return [x]


def _pieces(x) -> list:
    """(tensor, device) of every piece of a leaf (the leaf itself when it
    is not sharded)."""
    if isinstance(x, ShardedTensor):
        return list(zip(x.pieces, x.devices))
    return [(x, x.device)]


class _PerDevice:
    """A 0-d tensor's copies on the devices that ask for it, made once."""

    def __init__(self, t: torch.Tensor):
        self.t, self.on = t, {}

    def __call__(self, dev) -> torch.Tensor:
        if dev not in self.on:
            self.on[dev] = self.t.to(dev)
        return self.on[dev]


def _scalar(x) -> torch.Tensor:
    """A 0-d leaf (the step), from its first piece on a mesh."""
    return x.pieces[0] if isinstance(x, ShardedTensor) else x


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32; each distinct block of a
    sharded leaf counted once, on the first leaf's device."""
    total, dev = None, None
    for x in _leaves(tree):
        for b in _blocks(x):
            s = torch.linalg.vector_norm(b, dtype=torch.float32).square()
            dev = s.device if dev is None else dev
            total = s if total is None else total + s.to(dev)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf of ``tree`` in place by min(1, max_norm / ‖tree‖);
    returns (tree, ‖tree‖)."""
    g = global_norm(tree)
    factor = _PerDevice(torch.clamp(max_norm / (g + 1e-9), max=1.0))
    for leaf in _leaves(tree):
        for x, dev in _pieces(leaf):
            if x.dtype == torch.float32:
                x.mul_(factor(x.device))
            else:  # the product in float32, rounded once to the leaf's dtype
                x.copy_(x.float().mul_(factor(x.device)))
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


def _zeros32(p):
    """float32 zeros of ``p``'s shape and placement."""
    if isinstance(p, ShardedTensor):
        return p.map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params):
    return {"m": map_tree(_zeros32, params), "v": map_tree(_zeros32, params)}


def adamw_update(grads, state, params, step, hp: OptHParams):
    """One AdamW step in place; returns (params, state), the same trees.
    A sharded leaf is updated piece by piece, each piece once."""
    step = _scalar(step)
    lr = _PerDevice(schedule(hp, step))
    t = torch.as_tensor(step).to(torch.float32) + 1.0
    bc1 = _PerDevice(1 - hp.b1 ** t)
    bc2 = _PerDevice(1 - hp.b2 ** t)
    flat_g, flat_m, flat_v = (flatten_tree(x) for x in
                              (grads, state["m"], state["v"]))
    for name, leaf in flatten_tree(params).items():
        for (p, _), (g, _), (m, _), (v, _) in zip(
                _pieces(leaf), _pieces(flat_g[name]), _pieces(flat_m[name]),
                _pieces(flat_v[name])):
            dev = p.device
            g = _as_f32(g)
            m.mul_(hp.b1).add_((1 - hp.b1) * g)
            v.mul_(hp.b2).add_((1 - hp.b2) * g * g)
            u = m / bc1(dev)
            u.div_(torch.sqrt(v / bc2(dev)).add_(hp.eps))
            _apply(p, u, lr(dev), hp.weight_decay)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment) — memory ~0 extra
# ---------------------------------------------------------------------------


def adafactor_init(params):
    def fac(p):
        if isinstance(p, ShardedTensor):
            return _factored_placement(p)
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
    step = _scalar(step)
    lr = schedule(hp, step)
    decay = 1.0 - (torch.as_tensor(step).to(torch.float32) + 1.0) ** -0.8
    flat_g = flatten_tree(grads)
    flat_f = state["f"]
    for name, p in flatten_tree(params).items():
        if isinstance(p, ShardedTensor):
            _adafactor_sharded(flat_g[name], _subtree(flat_f, name), p,
                               _PerDevice(lr), _PerDevice(decay), hp)
            continue
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


def _factored_placement(p: ShardedTensor) -> dict:
    """Adafactor's float32 moments of a sharded leaf, placed as
    `train_state_pspecs` places them: ``vr`` by the leaf's spec without
    its last entry, ``vc`` without its second last; ``v`` as the leaf."""
    from ..distributed.placement import zeros_placed
    from ..distributed.sharding import (NamedSharding, PartitionSpec,
                                        sanitize_spec)

    def zeros(shape, entries):
        spec = sanitize_spec(p.mesh, PartitionSpec(*entries), shape)
        return zeros_placed(NamedSharding(p.mesh, spec), shape,
                            torch.float32)

    e = list(p.spec) + [None] * (p.ndim - len(p.spec))
    if p.ndim >= 2:
        return {"vr": zeros(p.shape[:-1], e[:-1]),
                "vc": zeros(p.shape[:-2] + p.shape[-1:], e[:-2] + e[-1:])}
    return {"v": _zeros32(p)}


def _adafactor_sharded(g: ShardedTensor, f: dict, p: ShardedTensor,
                       lr, decay, hp: OptHParams) -> None:
    """`adafactor_update`'s step for one sharded leaf, in place: the row
    and column means are sums over the leaf's distinct blocks, added on
    each moment piece's device; every piece of the leaf then takes its
    own update from the moment pieces on its slot."""
    g2 = [_as_f32(t) * _as_f32(t) + 1e-30 for t in g.pieces]
    by_slot = {}  # (device, block) → piece, for each moment leaf

    def piece(x, dev, idx):
        key = id(x)
        if key not in by_slot:
            by_slot[key] = dict(zip(zip(x.devices, x.index), x.pieces))
        return by_slot[key][(dev, idx)]

    if p.ndim >= 2:
        vr, vc = f["vr"], f["vc"]
        rows, cols = {}, {}
        for i in p.canonical():
            idx = p.index[i]
            rows.setdefault(idx[:-1], []).append(g2[i].sum(dim=-1))
            cols.setdefault(idx[:-2] + idx[-1:], []).append(g2[i].sum(dim=-2))
        for x, sums, n in ((vr, rows, p.shape[-1]), (vc, cols, p.shape[-2])):
            for t, dev, idx in zip(x.pieces, x.devices, x.index):
                dd = decay(t.device)
                t.mul_(dd).add_((1 - dd) * (all_reduce_sum(sums[idx], t.device)
                                            / n))
        vr_rows = {}
        for i in vr.canonical():
            vr_rows.setdefault(vr.index[i][:-1], []).append(
                vr.pieces[i].sum(dim=-1))
        us = []
        for i, (t, dev, idx) in enumerate(zip(g.pieces, p.devices, p.index)):
            r = piece(vr, dev, idx[:-1])
            c = piece(vc, dev, idx[:-2] + idx[-1:])
            mean = all_reduce_sum(vr_rows[idx[:-2]], t.device) / p.shape[-2]
            denom = (r[..., None] * c[..., None, :]
                     / torch.clamp(mean[..., None, None], min=1e-30))
            us.append(_as_f32(t) / torch.sqrt(denom.add_(1e-30)))
    else:
        v = f["v"]
        us = []
        for i, (t, dev, idx) in enumerate(zip(g.pieces, p.devices, p.index)):
            vi = piece(v, dev, idx)
            dd = decay(t.device)
            vi.mul_(dd).add_((1 - dd) * g2[i])
            us.append(_as_f32(t) / torch.sqrt(vi + 1e-30))
    # update clipping (RMS ≤ 1) over the whole leaf
    sq = all_reduce_sum([(us[i] * us[i]).sum() for i in p.canonical()],
                        p.pieces[0].device)
    rms = _PerDevice(torch.clamp(torch.sqrt(sq / math.prod(p.shape) + 1e-30),
                                 min=1.0))
    for t, u in zip(p.pieces, us):
        _apply(t, u.div_(rms(t.device)), lr(t.device), hp.weight_decay)


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
