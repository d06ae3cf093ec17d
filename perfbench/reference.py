"""The plain reference that judges the timed outputs (PyTorch only).

``y[b, c, t] = Σ_j q[b, j] · x[c, t + j]`` for j in 0 .. taps − 1, summed
exactly in int64 (8-bit samples and 16-bit coefficients over at most a
few hundred taps stay far below 2**63), at the output positions the judge
sampled.  It takes the benchmark's own samples and coefficients and
nothing the program derived from them.

`control_block` is the reference put in the program's place and computed
one precision lower, in float32 with TF32 off: every output of a block
through ``conv1d``.  Its results are exact only while the partial sums
stay below 2**24, so the exact comparison must fail it.
"""
from __future__ import annotations

import torch

__all__ = ["unravel", "fir_at", "control_block"]


def unravel(flat: torch.Tensor, shape: tuple) -> tuple:
    """Flat indices into a (B, C, n_out) block → (b, c, t)."""
    _, n_chan, n_out = shape
    b = torch.div(flat, n_chan * n_out, rounding_mode="floor")
    r = flat - b * (n_chan * n_out)
    c = torch.div(r, n_out, rounding_mode="floor")
    return b, c, r - c * n_out


def fir_at(x: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, t: torch.Tensor, rows: int = 1 << 16
           ) -> torch.Tensor:
    """The exact outputs of bank ``q`` (B, taps) over samples ``x`` (C, T)
    at positions (b, c, t) → int64, in blocks of ``rows`` positions."""
    taps = q.shape[-1]
    x64 = x.to(torch.int64)
    q64 = q.to(device=x.device, dtype=torch.int64)
    j = torch.arange(taps, device=x.device)
    out = torch.empty(b.shape, dtype=torch.int64, device=x.device)
    for s in range(0, b.numel(), rows):
        e = slice(s, s + rows)
        win = x64[c[e, None], t[e, None] + j]  # (n, taps)
        out[e] = (win * q64[b[e]]).sum(dim=-1)
    return out


def control_block(x: torch.Tensor, q: torch.Tensor,
                  rows: int = 512) -> torch.Tensor:
    """Every output of the bank over one block, summed in float32 →
    int32 (B, C, n_out), ``rows`` filters at a time."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        xf = x.to(torch.float32)[:, None, :]  # (C, 1, T)
        qf = q.to(device=x.device, dtype=torch.float32)
        n_filters, taps = qf.shape
        n_chan, n_out = x.shape[0], x.shape[1] - taps + 1
        y = torch.empty((n_filters, n_chan, n_out), dtype=torch.int32,
                        device=x.device)
        for s in range(0, n_filters, rows):
            part = torch.nn.functional.conv1d(xf, qf[s:s + rows, None, :])
            y[s:s + rows] = part.round().to(torch.int32).transpose(0, 1)
        return y
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
