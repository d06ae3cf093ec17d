"""The port's BLMAC kernels for the H100, with their plain versions.

  blmac_fir       — one quantized type-I filter: the pulse-specialized
                    CUDA kernel (``csrc/blmac_specialized.cu``) or a
                    one-filter bank launch
  blmac_fir_bank  — a whole bank: the scheduled CUDA bank kernel
                    (``csrc/blmac_bank.cu``, int8 tensor cores), one launch
                    for every tile group; B = 1 takes the specialized kernel;
                    a CSE-optimized bank adds the combine fold
                    (``csrc/blmac_combine.cu``)
  autotune_bank_dispatch — the cost-model dispatch planner (constants
                    fitted on the card, the reference's on the CPU)
  pulse_quantize  — float weights to CSD-P pulse codes + group exponents,
  pulse_dequantize  on the device, bit for bit the reference's quantizer
  pulse_matmul_op — float32 x @ W with W rebuilt from the codes inside the
                    CUDA kernel ``csrc/blmac_pulse_matmul.cu``
  resolve_device  — ``None`` means the GPU (a loud error without one);
                    ``device="cpu"`` runs the plain versions
"""
from .blmac_matmul import pulse_dequantize, pulse_quantize
from .ops import blmac_fir, blmac_fir_bank, pulse_matmul_op
from .runtime import (DEFAULT_TILE, SPECIALIZE_BANK_MAX,
                      autotune_bank_dispatch, resolve_device)
from ..core.costmodel import BankDispatchPlan
from . import ref

__all__ = ["BankDispatchPlan", "DEFAULT_TILE", "SPECIALIZE_BANK_MAX",
           "autotune_bank_dispatch", "blmac_fir", "blmac_fir_bank",
           "pulse_dequantize", "pulse_matmul_op", "pulse_quantize", "ref",
           "resolve_device"]
