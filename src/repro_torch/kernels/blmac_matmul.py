"""The CSD-P pulse-code quantized matmul on the GPU, with its quantizer.

The port of `repro.kernels.blmac_matmul`.  Each weight is stored as its P
most-significant CSD pulses, ``w ≈ Σ_p s_p·2^(e_g − 14 + r_p)``, with one
exponent ``e_g`` per group of 32 rows along K:

  * `pulse_quantize` / `pulse_dequantize` — float (K, N) weights to uint8
    codes (P, K, N) [bit 7 valid, bit 6 sign, bits 3..0 position;
    ``NULL_POS`` in empty slots] and int8 ``group_exp`` (K / 32, N), and
    back to float64.  Tensor code on the device of the input, bit for bit
    the reference's numpy quantizer.
  * `pulse_matmul` (kernel ``csrc/blmac_pulse_matmul.cu``) — float32
    ``x @ W`` with W rebuilt from the codes inside the kernel.  Replaces the
    TPU kernel `_pulse_matmul_kernel`.  A CPU tensor runs the plain version
    `ref.pulse_matmul_ref`; a CUDA tensor launches the kernel or raises.
    Launches are counted in ``pulse_matmul.launches``.

What the quantizer copies from the reference on purpose, quirks included:

  * the group exponent is ``ceil(log2(max|w|))`` as numpy computes it in
    float64, not `frexp`'s: numpy's log2 rounds ``nextafter(2**k, inf)`` to
    ``k`` for some k (k = 5, −7, 20) and not for others (k = 2).  The
    exponents are therefore taken with numpy on the host, from the group
    maxima alone (1/32 of the weights); everything else runs on the device;
  * rounding is half-to-even (`torch.round`, as `np.rint`);
  * an all-zero group gets ``e = −128`` and all-null codes;
  * the exponent is clipped to int8 *after* the pulses were taken with the
    unclipped one, so a group whose maximum is below 2**-127 decodes to
    the wrong scale (``w = 2**-130`` decodes to ``2**-127``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.csd import csd_digits_tensor, csd_truncate_tensor
from .blmac_fir import _raise_on, _stream
from .ref import exp2_int, pulse_decode_ref, pulse_matmul_ref
from .runtime import as_device_tensor, resolve_device

__all__ = [
    "GROUP",
    "NULL_POS",
    "launch_plan",
    "pulse_dequantize",
    "pulse_matmul",
    "pulse_quantize",
]

GROUP = 32
NULL_POS = 15
N_DIGITS = 16

# weights quantized at once: bounds the (K, columns, 16) int8 digit array
# and its int32 temporaries (columns of W are independent)
QUANT_CHUNK = 1 << 23

# the kernel's tile: BN output columns, BK rows of K per step
BN, BK = 128, 32
# a split of K covers at least this many steps
MIN_SPLIT_STEPS = 4


def _group_exponents(gmax: torch.Tensor) -> torch.Tensor:
    """The reference's ``ceil(log2(gmax))`` (−128 for an all-zero group),
    int64 on ``gmax``'s device.  Evaluated with numpy on the host so that
    every device gets numpy's rounding of log2 (see the module notes)."""
    g = gmax.cpu().numpy()
    safe = np.where(g == 0.0, 1.0, g)
    e = np.ceil(np.log2(safe)).astype(np.int64)
    e = np.where(g == 0.0, -128, e)
    if (e < -1008).any():
        raise ValueError("group maxima below 2**-1008 are not supported")
    return torch.from_numpy(e).to(gmax.device)


def _codes_from_digits(digits: torch.Tensor, planes: int) -> torch.Tensor:
    """(K, N, 16) int8 NAF digits with ≤ ``planes`` pulses each → uint8
    codes (P, K, N), pulses assigned MSB first to slots 0, 1, …"""
    shape = digits.shape[:-1]
    codes = torch.zeros((planes,) + shape, dtype=torch.uint8,
                        device=digits.device)
    slot = torch.zeros(shape, dtype=torch.uint8, device=digits.device)
    for pos in range(N_DIGITS - 1, -1, -1):
        d = digits[..., pos]
        sel = d != 0
        code = torch.where(d < 0, 0x80 | 0x40 | pos, 0x80 | pos).to(torch.uint8)
        for p in range(planes):
            codes[p] = torch.where(sel & (slot == p), code, codes[p])
        slot += sel
    codes[codes == 0] = NULL_POS
    return codes


def _quantize_columns(w: torch.Tensor, e: torch.Tensor, planes: int,
                      group: int) -> torch.Tensor:
    """Codes of float64 columns ``w`` (K, n) under their unclipped group
    exponents ``e`` (K / group, n)."""
    zero = e == -128
    scale = exp2_int(e - 14).repeat_interleave(group, dim=0)  # q ≤ 2**14
    q = torch.round(w / scale)
    q = torch.where(zero.repeat_interleave(group, dim=0), 0.0, q)
    q = csd_truncate_tensor(q.to(torch.int16), planes, n_digits=N_DIGITS)
    return _codes_from_digits(csd_digits_tensor(q, n_digits=N_DIGITS), planes)


def pulse_quantize(w, planes: int, group: int = GROUP,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize float (K, N) weights to P pulse codes + group exponents.

    Returns ``codes`` uint8 (P, K, N) [bit 7 valid, bit 6 sign, bits 3..0
    pos] and ``group_exp`` int8 (K // group, N), on ``device`` (``None``:
    the GPU), equal bit for bit to the reference's numpy quantizer."""
    dev = resolve_device(device)
    w = as_device_tensor(w, dev).to(torch.float64)
    if w.ndim != 2:
        raise ValueError(f"weights must be (K, N), got {tuple(w.shape)}")
    k_dim, n_dim = w.shape
    if k_dim % group:
        raise ValueError(f"K={k_dim} not a multiple of group={group}")
    gmax = w.abs().reshape(k_dim // group, group, n_dim).amax(dim=1)
    e = _group_exponents(gmax)
    codes = torch.empty((planes, k_dim, n_dim), dtype=torch.uint8, device=dev)
    step = max(1, QUANT_CHUNK // max(k_dim, 1))
    for c0 in range(0, n_dim, step):
        cols = slice(c0, c0 + step)
        codes[:, :, cols] = _quantize_columns(w[:, cols], e[:, cols], planes,
                                              group)
    return codes, e.clamp(-127, 127).to(torch.int8)


def pulse_dequantize(codes: torch.Tensor, group_exp: torch.Tensor,
                     group: int = GROUP) -> torch.Tensor:
    """Decode pulse codes (P, K, N) and group exponents (K / group, N) to
    float64 (K, N) weights on their device (the reference's host oracle;
    exact, see `ref.pulse_decode_ref`)."""
    codes = torch.as_tensor(codes)
    group_exp = torch.as_tensor(group_exp, device=codes.device)
    if group_exp.shape[0] * group != codes.shape[1]:
        raise ValueError(f"group_exp {tuple(group_exp.shape)} does not match "
                         f"K={codes.shape[1]} at group={group}")
    return pulse_decode_ref(codes, group_exp, torch.float64)


def launch_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """The kernel's block rows ``bm``, steps of K per block and number of
    K splits for an (m, k) @ (k, n) product on a card with ``sms`` SMs.

    ``bm`` is the least of 16, 64, 128 that holds M (the decoded tile is
    reused by every row of the block).  K is split until the grid holds
    about four blocks per SM at bm = 16 (decode: the codes' bytes bound it,
    so many loads must be in flight) or two at the larger tiles, and no
    split is shorter than `MIN_SPLIT_STEPS` steps."""
    bm = 16 if m <= 16 else 64 if m <= 64 else 128
    tiles = -(-n // BN) * -(-m // bm)
    steps = -(-k // BK)
    target = (4 if bm == 16 else 2) * sms
    splits = max(1, min(-(-target // tiles), steps // MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    return bm, per, -(-steps // per)


def _check_operands(x, codes, group_exp, planes: int, group: int) -> None:
    if x.ndim != 2 or codes.ndim != 3 or group_exp.ndim != 2:
        raise ValueError("need x (M, K), codes (P, K, N), group_exp "
                         f"(K / group, N); got {tuple(x.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(group_exp.shape)}")
    m, k_dim = x.shape
    p_all, kc, n_dim = codes.shape
    if kc != k_dim:
        raise ValueError(f"x has K={k_dim}, codes K={kc}")
    if k_dim % group:
        raise ValueError(f"K={k_dim} not a multiple of group={group}")
    if tuple(group_exp.shape) != (k_dim // group, n_dim):
        raise ValueError(f"group_exp must be {(k_dim // group, n_dim)}, got "
                         f"{tuple(group_exp.shape)}")
    if not 1 <= planes <= min(p_all, 16):
        raise ValueError(f"planes={planes} outside 1..{min(p_all, 16)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be float32, bfloat16 or float16, got {x.dtype}")
    if codes.dtype != torch.uint8 or group_exp.dtype != torch.int8:
        raise TypeError(f"codes must be uint8 and group_exp int8, got "
                        f"{codes.dtype} and {group_exp.dtype}")
    if not (x.device == codes.device == group_exp.device):
        raise ValueError(f"operands on {x.device}, {codes.device} and "
                         f"{group_exp.device}")


def pulse_matmul(x: torch.Tensor, codes: torch.Tensor,
                 group_exp: torch.Tensor, planes: int,
                 group: int = GROUP) -> torch.Tensor:
    """float32 (M, N) = x (M, K) @ W, W decoded from the first ``planes``
    planes of ``codes`` and from ``group_exp``.  The plain version for CPU
    operands, the CUDA kernel for CUDA operands (no fallback)."""
    _check_operands(x, codes, group_exp, planes, group)
    if x.device.type == "cpu":
        return pulse_matmul_ref(x, codes[:planes], group_exp)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from .build import library

    x = x.to(torch.float32).contiguous()
    codes = codes.contiguous()
    group_exp = group_exp.contiguous()
    m, k_dim = x.shape
    n_dim = codes.shape[2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm, per, splits = launch_plan(m, n_dim, k_dim, sms)
    out = torch.empty((m, n_dim), dtype=torch.float32, device=x.device)
    work = out if splits == 1 else torch.empty(
        (splits, m, n_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library("blmac_pulse_matmul").blmac_pulse_matmul_launch(
            x.data_ptr(), codes.data_ptr(), group_exp.data_ptr(),
            work.data_ptr(), out.data_ptr(), m, n_dim, k_dim, planes, group,
            bm, per, _stream(x.device),
        )
    _raise_on(err, "blmac_pulse_matmul_kernel")
    pulse_matmul.launches += 1
    return out


pulse_matmul.launches = 0
