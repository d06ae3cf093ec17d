"""Checkpoint-level BLMAC quantization for serving, on torch state dicts.

The port of `repro.core.serve_quant`.  Every eligible weight of a flat
``{name: tensor}`` state dict is replaced by its CSD-P pulse-code
reconstruction (`kernels.blmac_matmul.pulse_quantize`, then decode), on
the device: the model downstream sees exactly the serving numerics.

The reference's choices are kept as they are, so both packages quantize
the same leaves of the same checkpoint:

  * eligible: ≥ 2 dims, ≥ ``min_size`` elements, a float16/32/64 dtype
    (numpy's kind ``"f"``: the reference reads leaves as numpy arrays, in
    which bfloat16 is not of that kind) and no ``"norm"`` in the
    lower-cased name;
  * quantized along axis −2 (the contraction axis of ``x @ W``), as
    ``reshape(-1, K, N)`` slices, and left alone when K is not a multiple
    of 32 — at the reference's attention layout ``(L, d, heads, hd)`` that
    is the head axis, so ``wq``/``wk``/``wv`` stay float and ``wo``
    (``(L, heads, hd, d)``) is quantized along ``head_dim``.

`tensors_from_arrays` carries the reference's parameters across: numpy
arrays keyed by the reference's ``"/"``-joined key path (for example
``stage0/slot0/ffn/down``) become tensors on the device; the same call
moves the reference's ``codes``/``group_exp`` arrays to the card for the
pulse matmul.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..kernels.blmac_matmul import GROUP, pulse_dequantize, pulse_quantize
from ..kernels.runtime import resolve_device

__all__ = ["quantize_param_tree", "tensors_from_arrays"]

_FLOAT = (torch.float16, torch.float32, torch.float64)


def tensors_from_arrays(arrays: Mapping[str, np.ndarray],
                        device=None) -> dict[str, torch.Tensor]:
    """``{name: numpy array}`` → ``{name: tensor}`` on ``device`` (``None``:
    the GPU), dtypes kept."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.ascontiguousarray(a), device=dev)
            for name, a in arrays.items()}


def _quantize_leaf(x: torch.Tensor, planes: int):
    """Quantize along the last-but-one axis (contraction axis of x @ W);
    None when that axis is not a multiple of the group."""
    w = x.to(torch.float64)
    k = w.shape[-2]
    if k % GROUP:
        return None
    w2 = w.reshape(-1, k, w.shape[-1])
    outs, rel_errs = [], []
    for wi in w2:
        codes, ge = pulse_quantize(wi, planes, device=wi.device)
        deq = pulse_dequantize(codes, ge)
        denom = float(wi.abs().mean()) + 1e-12
        rel_errs.append(float((deq - wi).abs().mean()) / denom)
        outs.append(deq)
    return (torch.stack(outs).reshape(x.shape).to(x.dtype),
            float(np.mean(rel_errs)))


def quantize_param_tree(state_dict: Mapping[str, torch.Tensor], planes: int,
                        min_size: int = 4096,
                        device=None) -> tuple[dict[str, torch.Tensor], dict]:
    """Returns (quantized state dict on ``device``, stats), the stats under
    the reference's keys.  Quantizes float leaves with ≥ 2 dims and ≥
    ``min_size`` elements (see the module notes)."""
    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    n_q = 0
    errs = []
    for name, leaf in state_dict.items():
        t = torch.as_tensor(leaf).to(dev)
        eligible = (t.ndim >= 2 and t.numel() >= min_size
                    and t.dtype in _FLOAT and "norm" not in name.lower())
        if eligible:
            res = _quantize_leaf(t, planes)
            if res is not None:
                out[name], err = res
                n_q += 1
                errs.append(err)
                continue
        out[name] = t
    stats = {
        "n_quantized": n_q,
        "mean_rel_err": float(np.mean(errs)) if errs else 0.0,
        # implemented packing: 8 bits/pulse + group exponent overhead;
        # 6 bits/pulse achievable with bit packing
        "bits_per_weight": 8.0 * planes + 8.0 / GROUP,
        "bits_per_weight_achievable": 6.0 * planes + 8.0 / GROUP,
    }
    return out, stats
