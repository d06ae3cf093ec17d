"""Parameter declarations, the parameter tree and the step context.

The port of `repro.nn.common`.  A model is declared once as a tree
(nested dicts) of :class:`ParamDecl` (shape, dtype, logical axes,
initializer); from the declarations come, without duplication:

  * ``init_params``      — parameters drawn from an explicit
                           `torch.Generator`, on a device,
  * ``abstract_params``  — ``meta`` tensors (no storage),
  * ``count_params`` / ``count_active_params`` — exact integers, no
                           allocation.

A tree's leaves are named by their ``"/"``-joined key path (for example
``stage0/slot0/ffn/down``), the reference's names: `flatten_tree` and
`unflatten_tree` convert between the nested and the flat form, and
`quantize_param_tree` and `params_from_arrays` take the flat one.

The logical axes feed ``param_pspecs``: through the rules of
`repro_torch.distributed.sharding` they say where a mesh stores each
leaf (`repro_torch.distributed.placement`).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch

from ..kernels.runtime import resolve_device

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    dtype: Any = torch.float32
    axes: tuple[str | None, ...] = ()
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed
    scale: float = 1.0
    fan_axis: int = 0  # which axis is fan-in for "fan_in" init

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a `torch.dtype`."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def flatten_tree(tree: Tree, prefix: str = "") -> dict[str, Any]:
    """Nested dicts → ``{"a/b/c": leaf}``, keys in sorted order at every
    level (the order in which the reference flattens a tree)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten_tree(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> dict:
    """``{"a/b/c": leaf}`` → nested dicts."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def map_tree(fn, tree: Tree) -> Tree:
    """``fn`` applied to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def map_trees(fn, tree: Tree, *others: Tree) -> Tree:
    """``fn(leaf, *other leaves)`` over ``tree``'s structure, the other
    trees walked in step with it (they may hold leaves where ``tree``
    does)."""
    if isinstance(tree, Mapping):
        return {k: map_trees(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_trees(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_leaves(tree: Tree) -> list:
    """The leaves of ``tree`` in the order `map_tree` visits them."""
    out: list = []
    map_tree(out.append, tree)
    return out


def _draw(d: ParamDecl, generator: torch.Generator, dev) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init in ("normal", "embed"):
        scale = d.scale
    elif d.init == "fan_in":
        fan = d.shape[d.fan_axis] if d.shape else 1
        scale = d.scale / math.sqrt(fan)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    v = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                    device=generator.device)
    return v.mul_(scale).to(dev)


def init_params(decls: Tree, generator: torch.Generator,
                device=None) -> Tree:
    """Materialize parameters from declarations: the reference's
    distributions (standard normal × ``scale``, over √fan-in for
    ``"fan_in"``; zeros; ones), drawn from ``generator`` leaf by leaf in
    key-path order, on ``device`` (``None``: the GPU).  Draws happen on
    the generator's device and are moved: a CUDA generator keeps a
    full-width model off the host."""
    dev = resolve_device(device)
    return unflatten_tree({k: _draw(d, generator, dev)
                           for k, d in flatten_tree(decls).items()})


def abstract_params(decls: Tree) -> Tree:
    """``meta`` tensors of the declared shapes — no allocation."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls)


def param_pspecs(decls: Tree, rules: dict[str, Any]) -> Tree:
    """PartitionSpec tree from the logical→mesh axis rules."""
    from ..distributed.sharding import PartitionSpec

    def spec(d: ParamDecl) -> PartitionSpec:
        axes = d.axes or (None,) * len(d.shape)
        return PartitionSpec(*(rules.get(a) if a else None for a in axes))

    return map_tree(spec, decls)


def count_params(decls: Tree) -> int:
    return sum(math.prod(d.shape) for d in flatten_tree(decls).values())


def count_active_params(decls: Tree, experts_per_token: int = 0,
                        n_experts: int = 0) -> int:
    """Active parameters per token: expert-stacked weights (logical axis
    'experts') count at k/E — the MoE MODEL_FLOPS convention (6·N_active·D)."""
    total = 0.0
    for d in flatten_tree(decls).values():
        n = math.prod(d.shape)
        if n_experts and d.axes and "experts" in d.axes:
            n = n * experts_per_token / n_experts
        total += n
    return int(total)


@dataclasses.dataclass
class ShardCtx:
    """Threaded through every apply(): the step's absolute positions,
    compute dtype and cache request; on a mesh, the rules, the mesh and
    the data slot this call computes (``rules`` is None unsharded).

    On a mesh one call runs one data slot: its rows ``rows`` of the
    global batch, on its device ``device``, with every weight gathered
    there by `gather` just before use.  The context is read only where
    compute depends on it: the gathers, the MoE groups (`data_size`) and
    the decode caches sharded over ``cache_seq``."""

    positions: torch.Tensor | None = None  # (B, S) int32 absolute positions
    compute_dtype: torch.dtype = torch.bfloat16
    make_cache: bool = False
    cache_len: int = 0
    rules: dict[str, Any] | None = None
    mesh: Any = None  # distributed.sharding.Mesh when sharded
    data_slot: int = 0  # row-major over the rules' batch axes
    device: torch.device | None = None  # the data slot's device
    rows: tuple[int, int] | None = None  # its rows of the global batch

    @property
    def data_size(self) -> int:
        """How many data slots split the batch (1 unsharded)."""
        if self.mesh is None:
            return 1
        from ..distributed.sharding import batch_axes

        return math.prod(self.mesh.shape[a] for a in batch_axes(self.rules))

    def gather(self, tree: Tree) -> Tree:
        """``tree`` with every sharded leaf all-gathered onto this data
        slot's device (autograd carries the gradient back into the
        pieces); the tree itself unsharded."""
        if self.mesh is None:
            return tree
        from ..distributed.placement import ShardedTensor

        return map_tree(lambda t: t.full(self.device, self.data_slot)
                        if isinstance(t, ShardedTensor) else t, tree)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x
