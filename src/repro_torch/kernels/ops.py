"""Public entry points of the port's BLMAC kernels.

All run on the GPU unless the caller passes ``device="cpu"``
(`resolve_device`): the input is moved to the device, and the device
then chooses between the CUDA kernels and their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compiler import compile_bank
from ..core.csd import require_type1
from .blmac_fir import (FAST_PATH_MAX, MERGE_DEFAULT, blmac_fir_specialized,
                        blmac_fir_bank as _bank_kernel)
from .blmac_matmul import GROUP, pulse_matmul
from .runtime import as_device_tensor, resolve_device

__all__ = ["blmac_fir", "blmac_fir_bank", "as_device_tensor",
           "pulse_matmul_op"]


def blmac_fir(
    x,
    qcoeffs: np.ndarray,
    specialize: bool = True,
    tile: int = 1024,
    device=None,
) -> torch.Tensor:
    """Apply a quantized symmetric type-I FIR filter with the BLMAC
    kernels: the pulse-specialized kernel (``specialize=True``, one cached
    pulse table per distinct filter) or a one-filter bank launch with the
    packed trits as operand.  Returns int32 (len(x) − taps + 1,) on the
    device."""
    qcoeffs = np.asarray(qcoeffs, np.int64)
    taps = require_type1(qcoeffs, "blmac_fir")
    x = as_device_tensor(x, resolve_device(device))
    prog = compile_bank(qcoeffs[None, :])
    if specialize:
        return blmac_fir_specialized(x, prog.pulse_schedules()[0], taps, tile)
    return _bank_kernel(
        x, prog.packed, taps, tile, fast_path=False,
        schedule=prog.schedule(bank_tile=1),
    )[0]


def blmac_fir_bank(
    x,
    qbank: np.ndarray,
    tile: int = 1024,
    bank_tile: int | None = None,
    merge: int | None = None,
    device=None,
) -> torch.Tensor:
    """Apply a whole (B, taps) filter bank to a (C, T) or (T,) signal with
    the sparsity-scheduled bank kernel; B = 1 takes the pulse-specialized
    kernel.  The bank is compiled once (content-addressed) and its
    memoized schedule reused.  Returns int32 (B, C, T − taps + 1), or
    (B, T − taps + 1) for 1-D ``x``, on the device."""
    x = as_device_tensor(x, resolve_device(device))
    prog = compile_bank(qbank)
    if prog.n_filters <= FAST_PATH_MAX:
        return _bank_kernel(
            x, prog.packed, prog.taps, tile, bank_tile,
            merge=MERGE_DEFAULT if merge is None else merge,
        )
    return _bank_kernel(
        x, prog.packed, prog.taps, tile, fast_path=False,
        schedule=prog.schedule(bank_tile, merge),
    )


def pulse_matmul_op(
    x,
    codes,
    group_exp,
    planes: int,
    group: int = GROUP,
    device=None,
) -> torch.Tensor:
    """CSD-P pulse-code matmul (see `blmac_matmul.py`): float32 (M, N) =
    x (M, K) @ W, W rebuilt from uint8 ``codes`` (P, K, N) and int8
    ``group_exp`` (K / group, N).  The operands (tensors or numpy arrays)
    are moved to the device; the tile sizes are the kernel's own."""
    dev = resolve_device(device)
    return pulse_matmul(as_device_tensor(x, dev), as_device_tensor(codes, dev),
                        as_device_tensor(group_exp, dev), planes, group)
