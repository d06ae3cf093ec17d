"""The port's BLMAC kernels for the H100, with their plain versions.

  blmac_fir       — one quantized type-I filter: the pulse-specialized
                    CUDA kernel (``csrc/blmac_specialized.cu``) or a
                    one-filter bank launch
  blmac_fir_bank  — a whole bank: the scheduled CUDA bank kernel
                    (``csrc/blmac_bank.cu``), one launch per occupancy tile
                    group; B = 1 takes the specialized kernel
  resolve_device  — ``None`` means the GPU (a loud error without one);
                    ``device="cpu"`` runs the plain versions

The CSD-P pulse-code matmul of the reference (`blmac_matmul`) is not
ported yet.
"""
from .ops import blmac_fir, blmac_fir_bank
from .runtime import DEFAULT_TILE, resolve_device
from . import ref

__all__ = ["DEFAULT_TILE", "blmac_fir", "blmac_fir_bank", "ref",
           "resolve_device"]
