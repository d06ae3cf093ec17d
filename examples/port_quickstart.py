"""Quickstart of the PyTorch/CUDA port: the paper in 40 lines.

Design a 127-tap FIR filter, quantize to int16 the paper's way, count the
BLMAC additions, then apply it three ways — classical dot product, the
cycle-accurate FPGA machine simulator, and the port's pulse-specialized
CUDA kernel — and check all three agree bit-for-bit.

    PYTHONPATH=src python examples/port_quickstart.py               # the GPU
    PYTHONPATH=src python examples/port_quickstart.py --device cpu  # plain
"""
import argparse

import numpy as np

from repro_torch.core import (FirBlmacMachine, classical_equivalent_adds,
                              fir_blmac_additions, po2_quantize)
from repro_torch.filters import design_bank, fir_direct
from repro_torch.kernels import blmac_fir

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the kernel runs: the GPU by default; 'cpu' runs "
                     "its plain PyTorch version")
args = ap.parse_args()

# 1. design + quantize (§3.1-§3.2)
h = design_bank(127, [("bandpass", (0.2, 0.5))])[0]
q, k = po2_quantize(h, bits=16)
print(f"quantized 127-tap bandpass, scale 2^{k}, max|coeff|={np.abs(q).max()}")

# 2. the paper's cost metric (§3.3)
adds = fir_blmac_additions(q)
classical = classical_equivalent_adds(127)
print(f"BLMAC additions per output: {adds}  "
      f"(classical equivalent: {classical}, {classical/adds:.2f}x better)")

# 3. apply it three ways
x = np.random.default_rng(0).integers(-128, 128, 127 + 100)
y_classical = fir_direct(x, q)

machine = FirBlmacMachine()
machine.program(q)
res = machine.run(x)
print(f"machine: {res.mean_cycles:.0f} cycles/output "
      f"(@400 MHz: {400/res.mean_cycles:.2f} Msample/s)")

y_kernel = blmac_fir(x, q, device=args.device)
print(f"kernel ran on {y_kernel.device}")

assert np.array_equal(y_classical, res.outputs), "machine mismatch!"
assert np.array_equal(y_classical, y_kernel.cpu().numpy()), "kernel mismatch!"
print("classical == machine == the port's kernel, bit-exact  OK")
