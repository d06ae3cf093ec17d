"""Plain PyTorch oracles for the kernels (the reference's `ref.py`
contract), on whatever device their input lies on: the FIR oracles and
the pulse-code matmul's plain version."""
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


def exp2_int(n: torch.Tensor) -> torch.Tensor:
    """2.0**n in float64, exactly, for integer ``n`` in [-1022, 1023]: the
    exponent field written directly (no libm call whose last bit could
    differ between host and card)."""
    return ((n.to(torch.int64) + 1023) << 52).view(torch.float64)


def pulse_decode_ref(codes: torch.Tensor, group_exp: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode pulse codes (P, K, N) uint8 [bit 7 valid, bit 6 sign, bits
    3..0 pos] and group exponents (K // group, N) int8 to the (K, N)
    weight matrix ``Σ_p ±2**(e_g − 14 + pos)`` in ``dtype``.

    Exact, on any device: the pulses are powers of two built from their
    exponent field and summed in float64, and the ≤ 16 pulses of a weight
    span ≤ 16 bits, so the cast to float32 rounds nothing.  An empty slot
    is selected away, never multiplied by 0 (in float32 its 2**128 would be
    inf, and 0 · inf is NaN)."""
    group = codes.shape[1] // group_exp.shape[0]
    c = codes.to(torch.int32)
    e = group_exp.to(torch.int32).repeat_interleave(group, dim=0)
    mag = exp2_int(e[None] - 14 + (c & 0x0F))
    val = torch.where((c & 0x40) != 0, -mag, mag)
    return torch.where((c & 0x80) != 0, val, 0.0).sum(dim=0).to(dtype)


def pulse_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                     group_exp: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The pulse-code matmul's plain version: decode the float32 weight
    matrix, then one float32 matmul (full float32 unless the caller
    enabled TF32)."""
    w = pulse_decode_ref(codes, group_exp)
    return (x.to(torch.float32) @ w).to(out_dtype)
