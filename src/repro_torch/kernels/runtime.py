"""Device selection for the port's entry points.

`repro`'s ``interpret=``/``lane=``/``compiled=`` arguments have no
counterpart here: the tensor's device chooses.  A CPU tensor runs a
kernel's plain PyTorch version; a CUDA tensor launches the kernel.  The
public entry points take ``device=None`` meaning *the GPU*: with no CUDA
device present that is a loud error, never a quiet run on the host —
pass ``device="cpu"`` to ask for the plain versions.

The reference's cost-model autotuner (`autotune_bank_dispatch`) is not
ported yet; `FilterBankEngine(mode="auto")` uses the fixed rule
documented there.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DEFAULT_TILE", "as_device_tensor", "resolve_device"]

# output samples per signal tile of the streaming engine (the reference's
# default, kept so both engines frame a stream identically)
DEFAULT_TILE = 512


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device, raising when there is none;
    otherwise ``torch.device(device)``, which must be CPU or an existing
    CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but CUDA is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array, tensor or sequence) as a tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)
