"""The paper's full FIR study in miniature (§3 + §4), on the port.

Sweeps a slice of the filter space and reports the Fig. 3/4 addition
statistics (§3.3), then compiles the 127-tap bank once and reports the §4
machine's cycle counts, its weight-memory verdicts and the Tab. 4
throughput model, and runs the bank through `lower()`'s kernel backends
(the bank kernel and the pulse-specialized kernel) against the vectorized
machine, bit for bit.

    PYTHONPATH=src python examples/port_fir_filtering.py [--n-div 40]
    PYTHONPATH=src python examples/port_fir_filtering.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.compiler import compile_bank, lower
from repro_torch.core import (MachineSpec, adds_per_coeff, adds_per_tap,
                              fir_blmac_additions_batch, po2_quantize_batch)
from repro_torch.filters import sweep_bank

ap = argparse.ArgumentParser()
ap.add_argument("--n-div", type=int, default=40)
ap.add_argument("--device", default=None,
                help="where the kernels run: the GPU by default; 'cpu' runs "
                     "their plain PyTorch versions")
args = ap.parse_args()

for taps in (55, 127, 255):
    bank = sweep_bank(taps, args.n_div, "hamming")
    q, _ = po2_quantize_batch(bank, 16)
    adds = fir_blmac_additions_batch(q)
    print(f"N={taps:3d}: {len(bank)} filters  "
          f"B_N={adds.mean():6.1f}±{adds.std():5.1f}  "
          f"adds/coeff={adds_per_coeff(adds, taps).mean():.2f}  "
          f"adds/tap={adds_per_tap(adds, taps).mean():.2f}")

# §4: machine cycle statistics + Tab. 4 throughput model for 127 taps
q, _ = po2_quantize_batch(sweep_bank(127, args.n_div, "hamming"), 16)
program = compile_bank(q)
cycles = program.machine_cycles()
fused = program.machine_cycles(MachineSpec(fused_last_add=True))
vm = lower(program, "vmachine")
print(f"\n127-tap machine: mean {cycles.mean():.1f} cycles/output "
      f"(paper ~231.6), {fused.mean():.1f} with the last add fused; "
      f"{100*(~vm.fits).mean():.1f}% exceed the 256-code weight memory "
      f"(paper ~18%)")
for fam, mhz in [("Artix 7", 316.8), ("Kintex 7", 407.3),
                 ("Ultrascale+", 800.0)]:
    print(f"  {fam:12s} @{mhz:6.1f} MHz -> {mhz/cycles.mean():.2f} Msample/s")

# the same compiled bank through the port's kernels, against the machine
x = np.random.default_rng(0).integers(-128, 128, 127 - 1 + 256)
y_machine = vm(x)
for backend in ("scheduled", "specialized"):
    y = lower(program, backend, device=args.device)(x)
    assert np.array_equal(y, y_machine), f"{backend} mismatch!"
print(f"vmachine == bank kernel == specialized kernel on {len(q)} filters, "
      f"bit-exact  OK")
