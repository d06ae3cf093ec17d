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
    ``x @ W`` with W rebuilt from the codes inside the kernel, on the
    tensor cores (a 3×TF32 split), one launch a call whose tile, ring and
    splits of K `launch_plan` picks.  Replaces the TPU kernel
    `_pulse_matmul_kernel`.  A CPU tensor runs the plain version
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

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..core.csd import csd_digits_tensor, csd_truncate_tensor
from .blmac_fir import _raise_on
from .ref import exp2_int, pulse_decode_ref, pulse_matmul_ref
from .runtime import as_device_tensor, resolve_device

__all__ = [
    "GROUP",
    "LaunchPlan",
    "NULL_POS",
    "cuda_launch_plan",
    "launch_plan",
    "pulse_dequantize",
    "pulse_matmul",
    "pulse_quantize",
    "release_split_buffers",
]

GROUP = 32
NULL_POS = 15
N_DIGITS = 16

# weights quantized at once: bounds the (K, columns, 16) int8 digit array
# and its int32 temporaries (columns of W are independent)
QUANT_CHUNK = 1 << 23

# the kernel's step: BK rows of K (one ring stage); BN output columns a
# block; its x tiles' row stride in floats
BK, BN, X_STRIDE = 32, 128, 36
# a step (at M <= 16 a warp's 8-row chunk of it) that sees a group exponent
# below this takes the CUDA cores: TF32 holds no bit below 2**-136, so
# w_hi + w_lo would not be exact
MIN_TENSOR_EXP = -112
# a split of K walks at least this many steps; at most this many splits
MIN_SPLIT_STEPS, MAX_SPLITS = 2, 64
# stages of the kernel's ring of shared-memory tiles
MIN_STAGES, MAX_STAGES = 3, 8
# a wgmma tile splits K only while splits × its rows stay within this many
# times the steps each split walks: the tile's last block adds the splits'
# partial tiles alone, and that sum must stay short beside the walk
SUM_ROWS_PER_STEP = 256
# swapped 8- and 16-row blocks an SM runs to capacity: a third adds no
# throughput (the decode's instructions bound it), so a wave is two of
# them an SM; a wgmma block has an SM to itself
SWAPPED_WAVE_BLOCKS = 2


def smem_limit(blocks_per_sm: int) -> int:
    """The dynamic shared memory a block may take on Hopper with
    ``blocks_per_sm`` blocks an SM (228 KB an SM, 1 KB of it reserved per
    block, 227 KB at most per block; less the kernel's static words)."""
    return min(232448, 233472 // blocks_per_sm - 1024) - 256


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


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of the kernel: the block's tile (``bm`` rows of M by `BN`
    columns of N) and blocks an SM, the ring's stages, the steps of K a
    block walks (``per``) and the splits of K (grid z); ``blocks`` in
    all."""

    bm: int
    blocks_per_sm: int
    stages: int
    per: int
    splits: int
    blocks: int


def _stage_bytes(bm: int, planes: int, group: int) -> int:
    exp_rows = min(BK, (BK - 1) // group + 2)
    return planes * BK * BN + exp_rows * BN + bm * X_STRIDE * 4


def smem_bytes(bm: int, planes: int, group: int, stages: int) -> int:
    """Dynamic shared memory of one block (the C function
    ``blmac_pulse_matmul_smem_bytes`` computes the same): at bm > 16 two
    buffers of the decoded weight tiles (hi and lo) and 1 KB to align them
    for wgmma; the pulse and 2^e tables; and the ring of (codes, exponent
    rows, x) stages."""
    return ((0 if bm <= 16 else 1024 + 4 * BK * BN * 4) + (64 + 256) * 4
            + stages * _stage_bytes(bm, planes, group))


def _ring(bm: int, planes: int, group: int) -> tuple[int, int] | None:
    """(blocks an SM, stages) of tile ``bm``: the most blocks an SM (four
    for the swapped tiles, whose warps hide the decode's latency; one for
    the wgmma tiles) at which a ring of `MIN_STAGES` fits in shared
    memory, and as many stages as then fit, up to `MAX_STAGES`; None when
    none fits."""
    for per_sm in ((4, 3, 2, 1) if bm <= 16 else (1,)):
        stages = min(MAX_STAGES,
                     (smem_limit(per_sm) - smem_bytes(bm, planes, group, 0))
                     // _stage_bytes(bm, planes, group))
        if stages >= MIN_STAGES:
            return per_sm, stages
    return None


def _splits(steps: int, bm: int, rows: int):
    """Every (splits, steps a split walks) of K's ``steps`` for tile ``bm``
    over ``rows`` rows of M: no split empty, each at least
    `MIN_SPLIT_STEPS` long, at most `MAX_SPLITS`, and at the wgmma tiles
    within `SUM_ROWS_PER_STEP`."""
    for s in range(1, min(MAX_SPLITS, steps) + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:
            continue
        if s > 1 and (per < MIN_SPLIT_STEPS
                      or bm > 16 and s * rows > SUM_ROWS_PER_STEP * per):
            continue
        yield s, per


def launch_plan(m: int, n: int, k: int, sms: int, planes: int = 4,
                group: int = GROUP) -> LaunchPlan:
    """The kernel's launch for an (m, k) @ (k, n) product at ``planes`` on a
    card with ``sms`` SMs.

    The tile is the least that holds M: 8 or 16 rows (the swapped
    ``mma.sync`` tiles), 64 or 128 (``wgmma``).  Above 64 rows the 64-row
    tile takes over where the 128-row tile, split as far as allowed, would
    leave SMs without a block while the 64-row tiles still fit one wave (a
    small N at prefill: ``wk``/``wv``).  Where no such tile's ring fits
    (many planes), the swapped 16-row tile serves any M.  K is split into
    the count that fills the card in the fewest block-steps: waves (blocks
    over `SWAPPED_WAVE_BLOCKS` or one a wgmma block per SM) times the
    steps a block walks plus one for filling its ring; the fewest splits
    of equals, for the shortest sum."""
    steps = -(-k // BK)

    def tiles(bm: int) -> int:
        return -(-n // BN) * -(-m // bm)

    wanted = ((8,) if m <= 8 else (16,) if m <= 16 else (64,) if m <= 64
              else (128, 64))
    fits = [bm for bm in wanted if _ring(bm, planes, group) is not None]
    if not fits:
        if _ring(16, planes, group) is None:
            raise ValueError(f"planes={planes}, group={group}: no tile of "
                             f"the pulse matmul fits in shared memory")
        fits = [16]
    bm = fits[0]
    if bm == 128 and 64 in fits and tiles(64) <= sms and tiles(128) * max(
            s for s, _ in _splits(steps, 128, min(128, m))) < sms:
        bm = 64
    per_sm, stages = _ring(bm, planes, group)
    wave = (min(SWAPPED_WAVE_BLOCKS, per_sm) if bm <= 16 else 1) * sms
    splits, per = min(
        _splits(steps, bm, min(bm, m)),
        key=lambda sp: (-(-tiles(bm) * sp[0] // wave) * (sp[1] + 1), sp[0]))
    return LaunchPlan(bm, per_sm, stages, per, splits, tiles(bm) * splits)


@functools.lru_cache(maxsize=1024)
def cuda_launch_plan(m: int, n: int, k: int, planes: int, group: int,
                     device: torch.device) -> LaunchPlan:
    """`launch_plan` for the CUDA device ``device`` and its SM count (cached
    per shape: the host's time per call counts at decode)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return launch_plan(m, n, k, sms, planes, group)


# Split-K buffers, per (device, stream): the float32 workspace of partial
# tiles and the int32 tickets of its sum, zero between launches (a tile's
# counter wraps back to 0 as its last ticket is drawn).  A stream's
# launches are ordered, so they may share both; two streams may not.  A
# stream is known by CUDA's ID for it, which, unlike the handle's value,
# no later stream of the process takes, so a new stream never meets the
# tickets of a destroyed one's launches still running.  Each entry grows
# to the largest launch seen on its stream (the smaller buffers go back
# to PyTorch's allocator) and lives until `release_split_buffers` or the
# process's end.  Kept, not allocated per call, for the host's time per
# call, which bounds the small projections at decode.
_SPLIT_BUFFERS: dict = {}


def release_split_buffers() -> None:
    """Drop every stream's split-K buffers (to PyTorch's allocator, which
    reuses their memory only after the launches queued on them)."""
    _SPLIT_BUFFERS.clear()


def _split_buffers(device: torch.device, stream: int, floats: int,
                   tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream != 0, _stream_id(stream))
    work, counters = _SPLIT_BUFFERS.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                               device=device)
    _SPLIT_BUFFERS[key] = (work, counters)
    return work, counters


def _stream_id(stream: int) -> int:
    """CUDA's ID of the stream of handle ``stream`` (0, the legacy default
    stream of the device, keeps 0)."""
    if stream == 0:
        return 0
    sid = ctypes.c_ulonglong()
    _raise_on(_library().blmac_stream_id(stream, ctypes.byref(sid)),
              "cudaStreamGetId")
    return sid.value


@functools.lru_cache(maxsize=1024)
def _launch_args(x_shape, codes_shape, ge_shape, x_dtype, codes_dtype,
                 ge_dtype, planes: int, group: int, device: torch.device):
    """The checked launch of one operand signature on ``device``: its plan
    and the C call's (m, n, k, planes, group).  Runs the operand checks
    once per signature (they raise, and nothing is cached, on a bad
    one)."""
    _check_shapes(x_shape, codes_shape, ge_shape, x_dtype, codes_dtype,
                  ge_dtype, planes, group)
    m, k_dim = x_shape
    n_dim = codes_shape[2]
    plan = cuda_launch_plan(m, n_dim, k_dim, planes, group, device)
    return plan, (m, n_dim, k_dim, planes, group)


def _check_shapes(x_shape, codes_shape, ge_shape, x_dtype, codes_dtype,
                  ge_dtype, planes: int, group: int) -> None:
    if len(x_shape) != 2 or len(codes_shape) != 3 or len(ge_shape) != 2:
        raise ValueError("need x (M, K), codes (P, K, N), group_exp "
                         f"(K / group, N); got {tuple(x_shape)}, "
                         f"{tuple(codes_shape)}, {tuple(ge_shape)}")
    m, k_dim = x_shape
    p_all, kc, n_dim = codes_shape
    if kc != k_dim:
        raise ValueError(f"x has K={k_dim}, codes K={kc}")
    if k_dim % group:
        raise ValueError(f"K={k_dim} not a multiple of group={group}")
    if tuple(ge_shape) != (k_dim // group, n_dim):
        raise ValueError(f"group_exp must be {(k_dim // group, n_dim)}, got "
                         f"{tuple(ge_shape)}")
    if not 1 <= planes <= min(p_all, 16):
        raise ValueError(f"planes={planes} outside 1..{min(p_all, 16)}")
    if x_dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be float32, bfloat16 or float16, got {x_dtype}")
    if codes_dtype != torch.uint8 or ge_dtype != torch.int8:
        raise TypeError(f"codes must be uint8 and group_exp int8, got "
                        f"{codes_dtype} and {ge_dtype}")


def _check_operands(x, codes, group_exp, planes: int, group: int) -> None:
    _check_shapes(x.shape, codes.shape, group_exp.shape, x.dtype, codes.dtype,
                  group_exp.dtype, planes, group)
    if not (x.device == codes.device == group_exp.device):
        raise ValueError(f"operands on {x.device}, {codes.device} and "
                         f"{group_exp.device}")


def pulse_matmul(x: torch.Tensor, codes: torch.Tensor,
                 group_exp: torch.Tensor, planes: int,
                 group: int = GROUP) -> torch.Tensor:
    """float32 (M, N) = x (M, K) @ W, W decoded from the first ``planes``
    planes of ``codes`` and from ``group_exp``.  The plain version for CPU
    operands, the CUDA kernel for CUDA operands (no fallback).

    On the GPU the checks, the plan and the constant arguments are looked
    up per operand signature, and the stream is read raw: at decode the
    host's time per call is what the small projections cost."""
    dev = x.device
    if dev.type != "cuda":
        _check_operands(x, codes, group_exp, planes, group)
        if dev.type == "cpu":
            return pulse_matmul_ref(x, codes[:planes], group_exp)
        raise ValueError(f"unsupported device {dev}")
    plan, dims = _launch_args(x.shape, codes.shape, group_exp.shape,
                              x.dtype, codes.dtype, group_exp.dtype,
                              planes, group, dev)
    if codes.get_device() != dev.index or group_exp.get_device() != dev.index:
        raise ValueError(f"operands on {dev}, {codes.device} and "
                         f"{group_exp.device}")
    if x.dtype != torch.float32:
        x = x.float()
    if not x.is_contiguous():
        x = x.contiguous()
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if not group_exp.is_contiguous():
        group_exp = group_exp.contiguous()
    m, n_dim = dims[0], dims[1]
    out = torch.empty((m, n_dim), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = counters = None
    if plan.splits > 1:
        work, counters = _split_buffers(dev, stream, plan.splits * m * n_dim,
                                        plan.blocks // plan.splits)
    err = _library().blmac_pulse_matmul_launch(
        x.data_ptr(), codes.data_ptr(), group_exp.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(),
        *dims, plan.bm, plan.per, plan.stages, stream, dev.index)
    _raise_on(err, "blmac_pulse_matmul_kernel")
    pulse_matmul.launches += 1
    return out


@functools.lru_cache(maxsize=1)
def _library():
    """The kernel's C library, built and loaded at the first call."""
    from .build import library

    return library("blmac_pulse_matmul")


pulse_matmul.launches = 0
