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

On a mesh with a ``model`` axis every product of a block is
tensor-parallel (`tp_product`): each follows its weight's ``model``
axis, as XLA's partitioner follows the reference's input shardings —

  * on an output dimension: column-parallel, the output stays cut over
    the data slot's model slots (a `Split`);
  * on the contraction dimension: row-parallel, each model slot's
    partial sum, reduced over ``model`` (`ShardCtx.whole`), or reduced
    and cut (`ShardCtx.scatter`);
  * on a dimension the operand and the output share (an einsum's batch
    dimension: the MoE's experts, MLA's heads in decode): each model
    slot computes its block of it;
  * nowhere (`sanitize_spec` dropped it): replicated, computed once on
    the data slot's device with the weight gathered there.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class ModelSlot:
    """One of a data slot's slots along ``model``: its index ``m`` on the
    axis, its device, and ``tag``, the flat mesh index that issues its
    work (`distributed.placement.issuing`)."""

    m: int
    device: Any
    tag: int


@dataclasses.dataclass
class Split:
    """An activation over a data slot's model slots, ``parts[m]`` on
    model slot ``m``'s device: ``dim`` an int — each part its slot's
    block of that dimension; ``"sum"`` — partial sums; ``"copy"`` — each
    part the whole tensor ``whole``."""

    parts: list
    dim: Any
    whole: Any = None


@dataclasses.dataclass
class ShardCtx:
    """Threaded through every apply(): the step's absolute positions,
    compute dtype and cache request; on a mesh, the rules, the mesh and
    the data slot this call computes (``rules`` is None unsharded).

    On a mesh one call runs one data slot: its rows ``rows`` of the
    global batch, on its device ``device``.  Where the mesh has a
    ``model`` axis (`tp`), every mixer's and FFN's products, the
    embedding and the head are split over the slot's model slots
    (`model_slots`, `tp_product`): each computes with its own block of
    the weights, gathered over the data axes only, and the residual
    stream stays on the data slot's device.  Only the norms are gathered
    whole onto that device by `gather` just before use.  Unsharded every
    such branch is skipped."""

    positions: torch.Tensor | None = None  # (B, S) int32 absolute positions
    compute_dtype: torch.dtype = torch.bfloat16
    make_cache: bool = False
    cache_len: int = 0
    rules: dict[str, Any] | None = None
    mesh: Any = None  # distributed.sharding.Mesh when sharded
    data_slot: int = 0  # row-major over the rules' batch axes
    device: torch.device | None = None  # the data slot's device
    rows: tuple[int, int] | None = None  # its rows of the global batch
    _slots: list | None = dataclasses.field(default=None, repr=False)

    @property
    def data_size(self) -> int:
        """How many data slots split the batch (1 unsharded)."""
        if self.mesh is None:
            return 1
        from ..distributed.sharding import batch_axes

        return math.prod(self.mesh.shape[a] for a in batch_axes(self.rules))

    @property
    def tp(self) -> bool:
        """Whether the dense products split over a ``model`` axis."""
        return self.mesh is not None and self.mesh.shape.get("model", 1) > 1

    @property
    def model_slots(self) -> list[ModelSlot]:
        """The data slot's slots along ``model``, its own first (the batch
        axes at the slot's coordinates, other axes at 0)."""
        if self._slots is None:
            from ..distributed.sharding import batch_axes

            mesh = self.mesh
            axes = batch_axes(self.rules)
            sizes = [mesh.shape[a] for a in axes]
            coord = dict(zip(axes, (int(c) for c in np.unravel_index(
                self.data_slot, sizes)))) if axes else {}
            self._slots = []
            for m in range(mesh.shape["model"]):
                c = dict(coord, model=m)
                pos = tuple(c.get(a, 0) for a in mesh.axis_names)
                self._slots.append(ModelSlot(m, mesh.devices[pos], int(
                    np.ravel_multi_index(pos, mesh.devices.shape))))
        return self._slots

    def gather(self, tree: Tree) -> Tree:
        """``tree`` with every sharded leaf all-gathered onto this data
        slot's device (autograd carries the gradient back into the
        pieces); the tree itself unsharded."""
        if self.mesh is None:
            return tree
        from ..distributed.placement import ShardedTensor

        return map_tree(lambda t: t.full(self.device, self.data_slot)
                        if isinstance(t, ShardedTensor) else t, tree)

    def per_slot(self, fn, *args) -> list:
        """``fn(model slot, *args)`` on each model slot, a `Split`'s
        argument as its part, the slot issuing the work."""
        from ..distributed.placement import issuing, tag_graph

        out = []
        for s in self.model_slots:
            with issuing(s.tag):
                y = fn(s, *(a.parts[s.m] if isinstance(a, Split) else a
                            for a in args))
            tag_graph([t for t in (y if isinstance(y, tuple) else (y,))
                       if torch.is_tensor(t)], s.tag)
            out.append(y)
        return out

    def fan_out(self, x: torch.Tensor) -> Split:
        """``x`` (on this data slot's device) copied to its model slots."""
        from ..distributed.placement import to_model_slots

        return Split(to_model_slots(x, [s.device for s in self.model_slots],
                                    self.device, self.data_slot), "copy", x)

    def whole(self, x) -> torch.Tensor:
        """A `Split` made whole on the data slot's device: partial sums
        reduced (all-reduce), parts joined (all-gather)."""
        if not isinstance(x, Split):
            return x
        if x.dim == "copy":
            return x.whole
        from ..distributed.placement import (from_model_slots,
                                             gather_model_parts)

        devs = [s.device for s in self.model_slots]
        if x.dim == "sum":
            return from_model_slots(x.parts, self.device, devs,
                                    self.data_slot)
        return gather_model_parts(x.parts, x.dim, self.device, devs,
                                  self.data_slot)

    def scatter(self, x: Split, dim: int) -> Split:
        """Partial sums reduced over the model slots, each keeping its
        block of ``dim`` (a reduce-scatter)."""
        from ..distributed.placement import reduce_scatter_model

        return Split(reduce_scatter_model(
            x.parts, dim, [s.device for s in self.model_slots],
            self.data_slot), dim)

    def regroup(self, x: Split, have, need) -> list:
        """``x`` cut along ``x.dim`` (part ``m`` the global range
        ``have[m]``) re-cut: slot ``m`` gets one tensor a range of
        ``need[m]`` (point-to-point moves, recorded)."""
        from ..distributed.placement import regroup_model

        return regroup_model(x.parts, x.dim, have, need,
                             [s.device for s in self.model_slots],
                             [s.tag for s in self.model_slots],
                             self.data_slot)

    def replicated(self, tree: Tree) -> Tree:
        """``tree``'s sharded leaves whole on the data slot's device, each
        of them replicated over ``model`` (a block computed once there,
        as `tp_product`'s replicated rule); a leaf cut over ``model``
        raises: the block's products take it."""
        def one(w):
            if tp_layout(w, ())[0] != "replicated":
                raise ValueError(f"a {w.shape} weight cut over model "
                                 f"({w.spec}) where its block is computed "
                                 f"whole")
            return w.full(self.device, self.data_slot)

        from ..distributed.placement import ShardedTensor

        return map_tree(lambda t: one(t) if isinstance(t, ShardedTensor)
                        else t, tree)


def slot_block(w, s: ModelSlot, ctx: ShardCtx, dim: int,
               rng: tuple[int, int]) -> torch.Tensor:
    """Model slot ``s``'s block ``rng`` of ``w``'s dim ``dim`` (a
    `ShardedTensor`, every other dim whole) on its device: its block
    where ``w`` is cut over ``model`` just so, its slice where ``w`` is
    replicated over ``model``; another cut raises."""
    kind, at = tp_layout(w, ())
    got = w.model_range(s.m)[dim]
    if kind == "replicated" or (at == dim and got == tuple(rng)):
        blk = w.block(s.m, s.device, ctx.data_slot)
        return blk if got == tuple(rng) else blk.narrow(
            dim, rng[0], rng[1] - rng[0])
    raise ValueError(f"a {w.shape} weight cut {w.spec}: model slot {s.m} "
                     f"needs {rng} of its dim {dim}, it holds {got}")


def tp_layout(w, contract: tuple,
              shared: tuple = ()) -> tuple[str, int | None]:
    """Where ``w``'s ``model`` axis lies, for a product contracting its
    dims ``contract`` and sharing its dims ``shared`` with the operand
    and the output: ``("row", i)`` on ``contract[i]``, ``("shared", i)``
    on ``shared[i]``, ``("column", j)`` on its ``j``-th other dim,
    ``("replicated", None)`` nowhere.  A ``model`` axis on two dims, or
    with another axis on one, raises."""
    entries = list(w.spec) + [None] * (w.ndim - len(w.spec))
    dims = [d for d, e in enumerate(entries)
            if e is not None and "model" in (e if isinstance(e, tuple)
                                             else (e,))]
    if not dims:
        return "replicated", None
    if len(dims) > 1 or entries[dims[0]] != "model":
        raise ValueError(f"no tensor-parallel product takes the spec "
                         f"{w.spec} of a {w.shape} weight")
    d = dims[0]
    if d in contract:
        return "row", contract.index(d)
    if d in shared:
        return "shared", shared.index(d)
    return "column", [k for k in range(w.ndim)
                      if k not in contract and k not in shared].index(d)


def matmul(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """x (…, in…) × w (in…, out…), ``n_in`` contraction dims, in x's
    dtype."""
    w = cast(w, x.dtype)
    if w.ndim == 2 and n_in == 1:
        return x @ w
    k = math.prod(w.shape[:n_in])
    return (x.flatten(-n_in) @ w.reshape(k, -1)).unflatten(-1, w.shape[n_in:])


def tp_product(x, w, ctx: ShardCtx, n_in: int = 1, fn=None,
               contract: tuple | None = None, shared: tuple = ()):
    """``fn(x, w)`` (default `matmul` over ``n_in`` leading dims of w)
    by the rule of ``w``'s ``model`` axis (a `ShardedTensor`):
    replicated — a tensor on the data slot's device; column — a `Split`
    cut along the output; row — a `Split` of partial sums; shared — a
    `Split` cut along the shared dim.  ``x``: a tensor on the data
    slot's device or a `Split` (its copies, or cut along the
    contraction dim of a row product or the shared dim of a shared
    one); ``contract``: w's contraction dims when ``fn`` is not
    `matmul`'s (x's last dims, in that order); ``shared``: ``(w's dim,
    x's dim, the output's dim)`` of each dim w shares with x and the
    output (an einsum's batch dims; the output ends with w's other
    dims)."""
    contract = tuple(range(n_in)) if contract is None else contract
    fn = fn or (lambda a, b: matmul(a, b, n_in))
    kind, at = tp_layout(w, contract, tuple(d[0] for d in shared))
    nc = len(contract)
    if kind == "replicated":
        return fn(ctx.whole(x), w.full(ctx.device, ctx.data_slot))
    xp = x.parts[0] if isinstance(x, Split) else x
    if kind == "shared":
        wdim, xdim, odim = shared[at]
    else:  # the cut dim of x (row); the output's is counted from its end
        wdim, xdim = contract[at] if kind == "row" else None, \
            xp.ndim - nc + at
        odim = at - (w.ndim - nc - len(shared)) if kind == "column" \
            else "sum"

    def blk(s):
        return w.block(s.m, s.device, ctx.data_slot)

    if kind != "column" and isinstance(x, Split) and x.dim == xdim:
        return Split(ctx.per_slot(lambda s, xm: fn(xm, blk(s)), x), odim)
    xs = x if isinstance(x, Split) and x.dim == "copy" \
        else ctx.fan_out(ctx.whole(x))

    def one(s, xm):
        if kind != "column":  # the slot's slice of x's cut dim
            a, b = w.model_range(s.m)[wdim]
            xm = xm.narrow(xdim, a, b - a)
        return fn(xm, blk(s))

    parts = ctx.per_slot(one, xs)
    if kind == "column":
        odim += parts[0].ndim
    return Split(parts, odim)


def tp_bias(y, b, ctx: ShardCtx):
    """``y`` (a `tp_product` result) plus the bias ``b`` (a
    `ShardedTensor` of ``y``'s last dims): a part cut along a dim takes
    its block of ``b``; partial sums take a bias cut over ``model`` in
    blocks, each block once, and a replicated one after the reduction;
    a replicated product adds it whole."""
    off = (y.parts[0] if isinstance(y, Split) else y).ndim - b.ndim
    kind, _ = tp_layout(b, ())
    if not isinstance(y, Split) or (y.dim == "sum" and kind == "replicated"):
        y = ctx.whole(y)
        return y + cast(b.full(ctx.device, ctx.data_slot), y.dtype)
    if y.dim == "sum":
        def add_block(s, part):
            rng = b.model_range(s.m)
            z = torch.zeros(part.shape[off:], dtype=part.dtype,
                            device=part.device)
            z[tuple(slice(a, c) for a, c in rng)] = cast(
                b.block(s.m, s.device, ctx.data_slot), part.dtype)
            return part + z

        return Split(ctx.per_slot(add_block, y), "sum")
    k = y.dim - off
    if k < 0:
        raise ValueError(f"a {b.shape} bias on a part cut along dim {y.dim}")

    def add_cut(s, part):
        n = part.shape[y.dim]
        rng = b.model_range(s.m)
        bm = b.block(s.m, s.device, ctx.data_slot)
        if any(r != (0, d) for i, (r, d) in enumerate(zip(rng, b.shape))
               if i != k) or rng[k] not in ((0, b.shape[k]),
                                            (s.m * n, (s.m + 1) * n)):
            raise ValueError(f"a bias {b.spec} does not follow its "
                             f"product's cut along dim {y.dim}")
        if rng[k] == (0, b.shape[k]):  # replicated: the slot's slice
            bm = bm.narrow(k, s.m * n, n)
        return part + cast(bm, part.dtype)

    return Split(ctx.per_slot(add_cut, y), y.dim)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x
