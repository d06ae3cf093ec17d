"""Plain PyTorch oracles for the FIR kernels (the reference's `ref.py`
contract), on whatever device their input lies on."""
from __future__ import annotations

import numpy as np
import torch


def blmac_fir_ref(x: torch.Tensor, qcoeffs: np.ndarray) -> torch.Tensor:
    """Exact type-I FIR via CSD bit layers (Eq. 2 + Eq. 3) in int32.

    ``x``: (T,) integer samples; ``qcoeffs``: (taps,) quantized symmetric
    coefficients.  Returns (T − taps + 1,) int32.  The digits are read
    off the compiled program; only the Horner recursion here is
    independent of the kernels."""
    from ..compiler import compile_bank

    taps = qcoeffs.shape[0]
    half = taps // 2
    x = x.to(torch.int32)
    n_out = x.shape[0] - taps + 1
    folded = [
        x[j: j + n_out] + x[taps - 1 - j: taps - 1 - j + n_out]
        for j in range(half)
    ]
    folded.append(x[half: half + n_out])
    digits = compile_bank(np.asarray(qcoeffs, np.int64)[None, :]) \
        .half_digits()[0]  # (M, L)
    acc = torch.zeros((n_out,), dtype=torch.int32, device=x.device)
    for layer in range(digits.shape[1] - 1, -1, -1):
        acc = acc << 1
        for j in np.nonzero(digits[:, layer])[0]:
            acc = acc + folded[j] if digits[j, layer] > 0 else acc - folded[j]
    return acc


def fir_direct_ref(x: torch.Tensor, qcoeffs: np.ndarray) -> torch.Tensor:
    """Classical dot-product FIR, the independent oracle: int64 products
    and sums (torch has no integer matmul on CUDA), cast to int32 — the
    same residue modulo 2**32."""
    taps = qcoeffs.shape[0]
    w = torch.as_tensor(np.asarray(qcoeffs, np.int64), device=x.device)
    windows = x.to(torch.int64).unfold(0, taps, 1)  # (n_out, taps)
    return (windows * w).sum(-1).to(torch.int32)
