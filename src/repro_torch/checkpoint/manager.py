"""Atomic, keep-k checkpoints in the reference's on-disk format.

The port's `repro.checkpoint.manager`.  One directory per step:

    <root>/step_000000042.tmp/...   (written, fsynced)
    <root>/step_000000042/          (atomic rename = commit)
        manifest.json               {step, sharded, leaves}
        <leaf>.npy                  (gathered layout), or
        <leaf>.shard<k>.npy         (per-shard layout)

A leaf's file is named by its key path joined with ``"__"``
(``params__stage0__slot0__ffn__down.npy``, ``step.npy``), so a checkpoint
either package writes restores in the other.  A bfloat16 leaf is written
as the reference writes an ml_dtypes array — its raw 2-byte words under
the descr ``'<V2'`` — and read back as bfloat16 when the leaf it restores
into is bfloat16.

The per-shard layout (``sharded=True``) is written from a placed leaf
(`ShardedTensor`): one file a mesh slot in mesh order, with its block's
index ranges, as the reference writes an array's addressable shards.
Restore assembles a leaf on the host from its shards and places it on a
mesh — the leaf's own in ``tree_like``, or ``shardings`` — so a state
saved on one mesh restores on another (elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..core.io import fsync_dir, fsync_file
from ..kernels.runtime import resolve_device
from ..nn.common import flatten_tree, unflatten_tree

__all__ = ["all_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d{9})$")
_BF16_DESCR = "<V2"  # what `np.save` writes for an ml_dtypes bfloat16 array


def _file_key(path: str) -> str:
    """A leaf's file name: its key path (``flatten_tree``'s, keys sorted
    as the reference flattens them) joined with ``"__"``."""
    return path.replace("/", "__")


def _save_leaf(path: str, leaf) -> None:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            words = t.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": _BF16_DESCR, "fortran_order": False,
                        "shape": tuple(words.shape)})
                words.tofile(f)
            return
        leaf = t.numpy()
    np.save(path, np.asarray(leaf))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_checkpoint(root: str, step: int, tree: Any, keep: int = 3,
                    sharded: bool = False) -> str:
    """Write ``tree`` (nested dicts of tensors, arrays or `ShardedTensor`s)
    atomically as step ``step``; keep the newest ``keep`` steps.  With
    ``sharded``, a leaf placed on a mesh of several slots is written one
    file a slot; every other leaf is gathered.  Returns the committed
    directory."""
    from ..distributed.placement import ShardedTensor, gather

    os.makedirs(root, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "sharded": sharded, "leaves": {}}
    for path, leaf in flatten_tree(tree).items():
        key = _file_key(path)
        meta: dict[str, Any] = {}
        if sharded and isinstance(leaf, ShardedTensor) and leaf.mesh.size > 1:
            for i, (index, piece) in enumerate(leaf.slot_pieces()):
                _save_leaf(os.path.join(tmp, f"{key}.shard{i}.npy"), piece)
                meta.setdefault("shards", []).append(
                    {"i": i, "index": [list(r) for r in index]})
            meta["shape"] = list(leaf.shape)
            meta["dtype"] = _dtype_name(leaf.dtype)
        else:
            if isinstance(leaf, ShardedTensor):
                leaf = gather(leaf, "cpu")
            _save_leaf(os.path.join(tmp, f"{key}.npy"), leaf)
        manifest["leaves"][key] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        fsync_file(f)
    os.rename(tmp, final)  # atomic commit
    fsync_dir(root)
    _gc(root, keep)
    return final


def _gc(root: str, keep: int) -> None:
    steps = sorted(all_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for n in os.listdir(root):
        m = _STEP_RE.match(n)
        if m and os.path.exists(os.path.join(root, n, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def _is_bf16_words(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _read_leaf(d: str, key: str, meta: dict) -> np.ndarray:
    """The leaf's array, assembled from its shards in the per-shard
    layout; bfloat16 stays as raw 2-byte words (``|V2``)."""
    if not meta.get("shards"):
        return np.load(os.path.join(d, f"{key}.npy"))
    bf16 = meta["dtype"] == "bfloat16"  # no numpy dtype without ml_dtypes
    arr = np.zeros(meta["shape"], dtype=np.uint16 if bf16 else meta["dtype"])
    for shard in meta["shards"]:
        piece = np.load(os.path.join(d, f"{key}.shard{shard['i']}.npy"))
        idx = tuple(slice(a, b) for a, b in shard["index"])
        arr[idx] = piece.view(np.uint16) if bf16 else piece
    return arr.view(np.dtype("V2")) if bf16 else arr


def _tensor(arr: np.ndarray, like, key: str) -> torch.Tensor:
    if _is_bf16_words(arr):
        if like.dtype != torch.bfloat16:
            raise ValueError(f"{key}: a bfloat16 leaf in the checkpoint, "
                             f"{like.dtype} in the tree to restore into")
        t = torch.from_numpy(arr.view(np.int16)).clone().view(torch.bfloat16)
    else:  # a copy in torch's own (aligned) memory
        t = torch.from_numpy(arr).clone()
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} in the checkpoint, "
                         f"{tuple(like.shape)} in the tree to restore into")
    return t


def restore_checkpoint(root: str, tree_like: Any, step: int | None = None,
                       device=None, shardings: Any = None) -> tuple[Any, int]:
    """Restore step ``step`` (default: the latest) into the structure of
    ``tree_like``; each leaf goes to the device of ``tree_like``'s leaf,
    or to ``device`` when given (``meta`` leaves need one).  A leaf is
    placed on a mesh by ``shardings`` (a tree of `NamedSharding` like
    ``tree_like``) when given, else as ``tree_like``'s leaf is placed
    when that is a `ShardedTensor` — the elastic re-mesh path.  Leaves
    keep the checkpoint's dtypes; a bfloat16 leaf's raw words need a
    bfloat16 leaf in ``tree_like``."""
    from ..distributed.placement import ShardedTensor, device_put

    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    dev = None if device is None else resolve_device(device)
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_sh = (flatten_tree(shardings) if shardings is not None else {})
    leaves = {}
    for path, like in flatten_tree(tree_like).items():
        key = _file_key(path)
        t = _tensor(_read_leaf(d, key, manifest["leaves"][key]), like, key)
        sh = flat_sh.get(path)
        if sh is None and isinstance(like, ShardedTensor):
            sh = like.sharding
        if sh is not None:
            leaves[path] = device_put(t, sh)
            continue
        target = dev if dev is not None else like.device
        if target.type == "meta":
            raise ValueError(f"{key}: restoring into a meta tensor needs "
                             f"device=")
        leaves[path] = t.to(target)
    return unflatten_tree(leaves), step
