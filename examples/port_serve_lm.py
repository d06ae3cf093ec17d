"""Batched serving with BLMAC CSD-P quantized weights, on the port.

The counterpart of ``examples/serve_lm.py``: initializes a reduced model
from a seed, quantizes every eligible linear weight to its P
most-significant CSD pulses (`quantize_param_tree`, the paper's
variable-precision dot product as a deployment feature), and compares
the quantized engine's greedy generations and weight-storage cost with
the bf16 baseline's.  Runs on the GPU; ``--device cpu`` runs on the host.

    PYTHONPATH=src python examples/port_serve_lm.py --planes 4 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.serve_quant import quantize_param_tree
from repro_torch.kernels import resolve_device
from repro_torch.nn import flatten_tree, init_params, model_decls
from repro_torch.serving import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen2.5-3b")
ap.add_argument("--planes", type=int, default=4)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--new-tokens", type=int, default=12)
ap.add_argument("--device", default=None,
                help="'cuda' (default) or 'cpu'")
args = ap.parse_args()

dev = resolve_device(args.device)
cfg = get_config(args.arch).reduced()
params = init_params(model_decls(cfg),
                     torch.Generator(device=dev).manual_seed(0), device=dev)
prompts = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (args.batch, 16)).astype(np.int32)

base = ServeEngine(cfg, params, cache_len=128, device=dev)
t0 = time.time()
out_base = base.generate(prompts, args.new_tokens).cpu().numpy()
print(f"bf16 baseline: {time.time()-t0:.2f}s  tokens:\n{out_base[:2]}")

qparams, stats = quantize_param_tree(flatten_tree(params), args.planes,
                                     device=dev)
print(f"CSD-{args.planes}: {stats['n_quantized']} matrices quantized, "
      f"mean rel err {stats['mean_rel_err']:.4f}, "
      f"{stats['bits_per_weight']:.1f} bits/weight stored "
      f"({stats['bits_per_weight_achievable']:.1f} achievable) vs 16 bf16")
quant = ServeEngine(cfg, qparams, cache_len=128, device=dev)
out_q = quant.generate(prompts, args.new_tokens).cpu().numpy()
agree = (out_base == out_q).mean()
print(f"greedy-token agreement vs bf16: {100*agree:.1f}%")
