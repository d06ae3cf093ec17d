"""Operator-level roofline inputs of one traced call.

The reference (`repro.roofline.hlo_analysis`) reads its roofline inputs
from the partitioned HLO text of a compiled step.  The port has no HLO:
an eager step is the sequence of aten operations it dispatches.
`analyze_step(fn, *args)` runs ``fn`` under one `TorchDispatchMode` —
on ``meta`` tensors it computes shapes only, so a 671B-parameter step
traces on a host without a card — and reads from every operation:

  * ``flops`` — 2·|result|·|contraction| of every matmul-family op (mm,
    bmm, addmm, baddbmm, the convolutions; ``matmul`` and ``einsum``
    lower to them), by `torch.utils.flop_counter`'s formulas, so the
    count equals `FlopCounterMode`'s on the same call;
  * ``hbm_bytes`` — the reference's per-op rules without its fusions:
    Σ operand + result bytes of every op except the element-wise ops the
    reference's ``_FUSED_ON_TPU`` set names (mapped to their aten
    counterparts); fills and ``arange`` are free (XLA's broadcast and
    iota); a write into part of a tensor counts 2× the part
    (dynamic-update-slice), a gather 2× its result, a scatter 3× its
    updates plus the indices; each collective its operand and result
    bytes.  The reference also charges each XLA fusion (a chain of
    element-wise ops, a reduction with its producers) one round trip,
    which an eager trace has no counterpart of: here those element-wise
    ops are free and a reduction counts alone.  So this is a lower
    bound on the reference's model, not the same number
    (`tests/test_torch_dryrun.py` holds the gap on ten cells);
  * ``coll_bytes`` / ``coll_counts`` — ring-model link bytes a kind and
    the calls, from the placement layer's counts
    (`distributed.placement.COLLECTIVES`): between slots of one device
    (or ``meta`` slots) ``.to()`` dispatches nothing.

and what the eager port itself does, with no fusion:

  * ``ops`` — the ops that launch a kernel on the card: views, metadata
    queries, uninitialized allocations and profiler marks excluded;
  * ``kernel_bytes`` — those ops' operand and result bytes (a write into
    part of a tensor counts the part, a scatter as above);
  * ``peak_live_bytes`` — the largest sum of the storages that ops
    allocated during the call and that were still alive: what the call
    adds to the memory held before it (weak references to each
    storage; views and in-place results allocate nothing).

Every number is of the call as traced: on a mesh it is whatever the
traced data slots computed (`repro_torch.launch.dryrun` traces one and
charges it to each).  On a tensor-parallel mesh each op and collective
is also counted under its issuer (`distributed.placement.issuing`: the
device slot of the data slot's model group that computes it), so that
`OpCounter.device_cost` reads what the busiest device of the group
computes and holds: the untagged work, which the reference repeats on
every device of the group, and the busiest issuer's own.  An op
inside `distributed.placement.repeated` (n) stands for n identical ops
(a loop walked once on ``meta`` tensors) and is counted n times.  HLO
text parsing has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..distributed import placement

__all__ = ["COLLECTIVE_KINDS", "CompCost", "OpCounter", "analyze_step",
           "collective_link_bytes"]

COLLECTIVE_KINDS = placement.COLLECTIVE_KINDS

# the reference's set of element-wise HLO ops a TPU build fuses into
# their neighbours (`repro.roofline.hlo_analysis._FUSED_ON_TPU`)
_FUSED_ON_TPU = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "exponential-minus-one", "log", "log-plus-one",
    "tanh", "logistic", "rsqrt", "sqrt", "power", "select", "compare",
    "and", "or", "not", "xor", "convert", "clamp", "floor", "ceil",
    "round-nearest-even", "round-nearest-afz", "sign", "is-finite", "copy",
    "reverse", "slice", "concatenate", "pad", "transpose", "cosine", "sine",
    "shift-left", "shift-right-logical", "shift-right-arithmetic", "expm1",
    "remainder", "atan2", "cbrt", "erf", "real", "imag", "stochastic-convert",
}

# aten op (its name without the in-place ``_``) → the HLO op it lowers to
_HLO_OF = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "reciprocal": "divide", "square": "multiply",
    "maximum": "maximum", "minimum": "minimum", "clamp_min": "maximum",
    "clamp_max": "minimum", "abs": "abs", "neg": "negate",
    "exp": "exponential", "expm1": "exponential-minus-one", "log": "log",
    "log1p": "log-plus-one", "tanh": "tanh", "sigmoid": "logistic",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "pow": "power", "where": "select",
    "masked_fill": "select", "eq": "compare", "ne": "compare",
    "lt": "compare", "le": "compare", "gt": "compare", "ge": "compare",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_not": "not", "bitwise_not": "not",
    "logical_xor": "xor", "bitwise_xor": "xor", "_to_copy": "convert",
    "clamp": "clamp", "floor": "floor", "ceil": "ceil",
    "round": "round-nearest-even", "sign": "sign", "isfinite": "is-finite",
    "clone": "copy", "copy": "copy", "flip": "reverse",
    "cat": "concatenate", "constant_pad_nd": "pad", "cos": "cosine",
    "sin": "sine", "bitwise_left_shift": "shift-left",
    "bitwise_right_shift": "shift-right-arithmetic",
    "remainder": "remainder", "atan2": "atan2", "erf": "erf",
    # x·σ(x), its derivative, and the other activations' derivatives:
    # multiplies and logistics, all fused
    "silu": "logistic", "silu_backward": "multiply", "gelu": "tanh",
    "gelu_backward": "multiply", "tanh_backward": "multiply",
    "sigmoid_backward": "multiply", "threshold_backward": "select",
    "softplus": "log-plus-one", "softplus_backward": "multiply",
    "addcmul": "multiply", "addcdiv": "divide", "lerp": "add",
}
# constant fills (XLA's broadcast) and iota: no HBM round trip
_FREE_IN_HBM = {"zeros", "ones", "full", "fill", "zero", "scalar_tensor",
                "zeros_like", "ones_like", "full_like", "new_zeros",
                "new_ones", "new_full", "arange"}
_GATHERS = {"index", "gather", "index_select", "embedding"}
# scatter ops: (position of the updates, position of the indices)
_SCATTERS = {"index_put": (2, 1), "index_add": (3, 2), "scatter_add": (3, 2),
             "scatter": (3, 2), "scatter_reduce": (3, 2),
             "index_copy": (3, 2), "embedding_dense_backward": (0, 1)}
# ops that launch no kernel (besides views, which `is_view` marks;
# ``_unsafe_view`` is a view the schema does not mark)
_NO_KERNEL = {"_unsafe_view", "empty", "empty_strided", "empty_like",
              "new_empty", "new_empty_strided", "lift_fresh", "set",
              "resize", "resize_as", "_local_scalar_dense", "size",
              "stride", "numel", "dim", "sym_size", "sym_stride",
              "sym_numel", "sym_storage_offset", "storage_offset",
              "is_contiguous", "sym_is_contiguous", "is_strides_like_format",
              "is_non_overlapping_and_dense", "is_same_size",
              "_has_compatible_shallow_copy_type", "device", "layout",
              "_record_function_enter", "_record_function_enter_new",
              "_record_function_exit"}


def collective_link_bytes(kind: str, result_bytes: float,
                          operand_bytes: float, n: int) -> float:
    """Ring-model bytes crossing a link a device (the reference's
    factors, `repro.roofline.hlo_analysis._collective_link_bytes`)."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * frac
    if kind == "reduce-scatter":
        return operand_bytes * frac
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


@dataclasses.dataclass
class CompCost:
    """The reference's fields (``flops``, ``hbm_bytes``, ``coll_bytes``,
    ``coll_counts``, ``hbm_by_op``, ``total_coll_bytes``) and the eager
    port's (``ops``, ``kernel_bytes``, ``peak_live_bytes``); see the
    module notes.  ``ops_by_name`` counts the ops by aten name,
    ``coll_raw`` a kind's operand and result bytes and calls as the
    placement layer counted them, ``coll_by_slot`` the link bytes a data
    slot asked for (None: no data slot, as in the optimizer's
    reductions)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    hbm_by_op: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    kernel_bytes: float = 0.0
    peak_live_bytes: int = 0
    ops_by_name: Counter = dataclasses.field(default_factory=Counter)
    coll_raw: dict = dataclasses.field(default_factory=dict)
    coll_by_slot: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "CompCost", mult: float = 1.0) -> None:
        """Add ``mult`` × ``other``'s counts (the peak is the larger)."""
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.ops += int(round(other.ops * mult))
        self.kernel_bytes += other.kernel_bytes * mult
        for mine, theirs in ((self.coll_bytes, other.coll_bytes),
                             (self.coll_counts, other.coll_counts),
                             (self.hbm_by_op, other.hbm_by_op),
                             (self.coll_by_slot, other.coll_by_slot)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * mult
        for k, v in other.ops_by_name.items():
            self.ops_by_name[k] += int(round(v * mult))
        for k, raw in other.coll_raw.items():
            mine = self.coll_raw.setdefault(k, dict.fromkeys(raw, 0))
            for f, v in raw.items():
                mine[f] += v * mult
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)

    def _hbm(self, op: str, nbytes: float) -> None:
        self.hbm_bytes += nbytes
        self.hbm_by_op[op] = self.hbm_by_op.get(op, 0.0) + nbytes

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _tensors(x):
    """The tensors in an op's arguments or result (lists flattened)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base(func) -> str:
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _whole(t: torch.Tensor) -> bool:
    """Whether ``t`` covers all of its storage."""
    return (t.is_contiguous()
            and _nbytes(t) == t.untyped_storage().nbytes())


def _collectives(before: dict, after: dict, cost: CompCost,
                 tagged: dict | None = None) -> None:
    """Add the collectives counted between two snapshots of
    `placement.COLLECTIVES` to ``cost``, and those recorded under an
    issuer (a ``(slot, issuer)`` key) to ``tagged[issuer]`` too."""
    for key, rec in after.items():
        kind, slot, n = key
        old = before.get(key, {})
        calls = rec["calls"] - old.get("calls", 0)
        if not calls:
            continue
        ob = rec["operand_bytes"] - old.get("operand_bytes", 0)
        rb = rec["result_bytes"] - old.get("result_bytes", 0)
        targets = [cost]
        if tagged is not None and isinstance(slot, tuple):
            targets.append(tagged.setdefault(slot[1], CompCost()))
        for c in targets:
            _add_collective(c, kind, slot, n, calls, ob, rb)


def _add_collective(cost: CompCost, kind, slot, n, calls, ob, rb) -> None:
    link = collective_link_bytes(kind, rb, ob, n)
    cost.coll_bytes[kind] = cost.coll_bytes.get(kind, 0.0) + link
    cost.coll_counts[kind] = cost.coll_counts.get(kind, 0) + calls
    cost.coll_by_slot[slot] = cost.coll_by_slot.get(slot, 0.0) + link
    raw = cost.coll_raw.setdefault(
        kind, {"calls": 0, "operand_bytes": 0, "result_bytes": 0})
    raw["calls"] += calls
    raw["operand_bytes"] += ob
    raw["result_bytes"] += rb
    cost._hbm(kind, ob + rb)


def _snapshot() -> dict:
    return {k: dict(v) for k, v in placement.COLLECTIVES.items()}


class OpCounter(TorchDispatchMode):
    """The dispatch mode of `analyze_step`, in named phases: ``with
    OpCounter() as oc:`` … ``oc.phase("update")`` …; ``oc.costs`` maps
    each phase to its `CompCost` (its ``peak_live_bytes`` measured from
    the live bytes at the phase's start), ``oc.total()`` adds them (the
    peak over the whole trace).  ``oc.tagged[phase][issuer]`` is the
    part of a phase each issuer computed, and `device_cost` the busiest
    device's share."""

    def __init__(self, phase: str = "step"):
        super().__init__()
        self.costs: dict[str, CompCost] = {}
        self.tagged: dict[str, dict] = {}
        self.dev_peak: dict[str, int] = {}
        # id(storage) → (bytes, finalizer, issuer)
        self._live: dict[int, tuple] = {}
        self._cur = 0
        self._cur_by: dict = {None: 0}  # live bytes by issuer
        self._peak = 0
        self._phase_base = 0
        self._dev_base = 0
        self._name = phase
        self._coll = {}
        self._tagging = False

    # -- phases -------------------------------------------------------------
    def __enter__(self):
        self._coll = _snapshot()
        self._tagging = placement.TAGGING["on"]
        placement.TAGGING["on"] = True
        self._start(self._name)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._close()
        placement.TAGGING["on"] = self._tagging
        for _, fin, _ in self._live.values():
            fin.detach()
        self._live.clear()
        return out

    def _start(self, name: str) -> None:
        self._name = name
        self._cost = self.costs.setdefault(name, CompCost())
        self._tags = self.tagged.setdefault(name, {})
        self._phase_base = self._cur
        self._dev_base = self._device_now()
        self.dev_peak.setdefault(name, 0)

    def _close(self) -> None:
        now = _snapshot()
        _collectives(self._coll, now, self._cost, self._tags)
        self._coll = now

    def device_cost(self, phase: str) -> CompCost:
        """The busiest device of the traced data slots' model group in
        ``phase``: the untagged part (every device of the group repeats
        it) and the busiest issuer's part (by FLOPs, then kernel bytes);
        its peak the largest rise of the untagged and one issuer's live
        bytes together."""
        out = CompCost()
        out.add(self.costs[phase])
        tags = self.tagged.get(phase, {})
        for c in tags.values():
            out.add(c, -1.0)
        if tags:
            out.add(max(tags.values(),
                        key=lambda c: (c.flops, c.kernel_bytes)))
        out.peak_live_bytes = self.dev_peak.get(phase, 0)
        return out

    def phase(self, name: str) -> None:
        """End the current phase and count what follows as ``name``."""
        self._close()
        self._start(name)

    def total(self) -> CompCost:
        out = CompCost()
        for c in self.costs.values():
            out.add(c)
        out.peak_live_bytes = self._peak
        return out

    # -- the storages -------------------------------------------------------
    def _device_now(self) -> int:
        tags = [v for k, v in self._cur_by.items() if k is not None]
        return self._cur_by[None] + max(tags, default=0)

    def _free(self, key: int) -> None:
        nb, _, tag = self._live.pop(key)
        self._cur -= nb
        self._cur_by[tag] -= nb

    def _allocated(self, out, args, tag) -> None:
        inputs = {id(t.untyped_storage()) for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._live:
                continue
            nb = st.nbytes()
            self._live[key] = (nb, weakref.finalize(st, self._free, key), tag)
            self._cur += nb
            self._cur_by[tag] = self._cur_by.get(tag, 0) + nb
            if self._cur > self._peak:
                self._peak = self._cur
            rise = self._cur - self._phase_base
            if rise > self._cost.peak_live_bytes:
                self._cost.peak_live_bytes = rise
            dev = self._device_now() - self._dev_base
            if dev > self.dev_peak[self._name]:
                self.dev_peak[self._name] = dev

    # -- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        base = _base(func)
        if func.is_view or base in _NO_KERNEL:
            return out
        if func.namespace == "profiler":
            return out
        tag = placement.current_issuer()
        costs = [self._cost] if tag is None else [
            self._cost, self._tags.setdefault(tag, CompCost())]
        n = placement.repeat_factor()
        for c in costs:
            if n == 1:
                self._count(c, func, base, args, kwargs, out)
            else:  # one op standing for n (`placement.repeated`)
                one = CompCost()
                self._count(one, func, base, args, kwargs, out)
                c.add(one, n)
        self._allocated(out, args, tag)
        return out

    def _count(self, c: CompCost, func, base, args, kwargs, out) -> None:
        c.ops += 1
        c.ops_by_name[base] += 1
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if base in _SCATTERS:
            ui, ii = _SCATTERS[base]
            upd = args[ui] if ui < len(args) else None
            idx = args[ii] if ii < len(args) else None
            ub = sum(map(_nbytes, _tensors(upd)))
            ib = sum(map(_nbytes, _tensors(idx)))
            moved = 3 * ub + ib
            if not func._schema.is_mutable and base != "embedding_dense_backward":
                moved += 2 * _nbytes(args[0])  # out of place: a copy first
            c.kernel_bytes += moved
            c._hbm("scatter", 3 * ub + ib)
            return
        if base == "copy" and not _whole(args[0]):
            part = _nbytes(args[0])
            c.kernel_bytes += 2 * part
            c._hbm("dynamic-update-slice", 2 * part)
            return
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c.kernel_bytes += moved
        if base in _GATHERS:
            c._hbm("gather", 2 * sum(map(_nbytes, outs)))
        elif base in _FREE_IN_HBM or _HLO_OF.get(base) in _FUSED_ON_TPU:
            pass
        else:
            c._hbm(base, moved)


def analyze_step(fn, *args, **kwargs) -> CompCost:
    """``fn(*args, **kwargs)`` traced by one `OpCounter`: its cost."""
    with OpCounter() as oc:
        fn(*args, **kwargs)
    return oc.total()
