"""The reference's parameters as the port's.

`params_from_arrays` takes `repro`'s parameter tree flattened to numpy
arrays under its ``"/"``-joined key paths (``stage0/slot0/ffn/down``, as
``jax.tree_util.tree_flatten_with_path`` names them) and returns the
port's tree on a device, checked leaf for leaf against the config's
declarations: the same names, the same shapes, the dtypes kept.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..kernels.runtime import resolve_device
from .common import flatten_tree, unflatten_tree
from .model import model_decls

__all__ = ["params_from_arrays"]


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy kind torch reads
        return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a), device=dev)


def params_from_arrays(cfg, arrays: Mapping[str, np.ndarray],
                       device=None) -> dict:
    """``{key path: numpy array}`` → the port's nested parameter tree on
    ``device`` (``None``: the GPU).  Raises when a name or a shape does
    not match ``model_decls(cfg)``."""
    dev = resolve_device(device)
    want = flatten_tree(model_decls(cfg))
    if set(arrays) != set(want):
        raise ValueError(f"arrays do not match {cfg.name}'s declarations: "
                         f"missing {sorted(set(want) - set(arrays))[:4]}, "
                         f"extra {sorted(set(arrays) - set(want))[:4]}")
    out = {}
    for name, d in want.items():
        a = np.asarray(arrays[name])
        if a.shape != d.shape:
            raise ValueError(f"{name}: shape {a.shape}, declared {d.shape}")
        out[name] = _tensor(a, dev)
    return unflatten_tree(out)
