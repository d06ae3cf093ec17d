"""End-to-end training on the port: a ~100M-param LM trained for a few
hundred steps on synthetic structured data, with fault-tolerant
checkpointing — the counterpart of ``examples/train_lm.py``.  Runs on
the GPU; ``--device cpu`` runs on the host.

    PYTHONPATH=src python examples/port_train_lm.py --steps 50       # quick
    PYTHONPATH=src python examples/port_train_lm.py --steps 300 --size 100m
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed.fault import TrainLoop
from repro_torch.nn import count_params, model_decls
from repro_torch.training import OptHParams, TrainHParams

SIZES = {
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                head_dim=64, d_ff=768, vocab_size=4096),
    "25m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                head_dim=64, d_ff=1152, vocab_size=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2304, vocab_size=16384),
}

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=50)
ap.add_argument("--size", choices=list(SIZES), default="10m")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_example"))
ap.add_argument("--device", default=None,
                help="'cuda' (default) or 'cpu'")
args = ap.parse_args()

cfg = get_config("qwen2.5-3b").reduced(**SIZES[args.size])
print(f"model: {count_params(model_decls(cfg))/1e6:.1f}M params")
pipe = TokenPipeline(DataConfig(cfg.vocab_size, args.batch, args.seq,
                                seed=0, kind="markov"))
hp = TrainHParams(opt=OptHParams(learning_rate=1e-3, warmup_steps=20,
                                 total_steps=args.steps))
loop = TrainLoop(cfg, hp, pipe, args.ckpt_dir, ckpt_every=25,
                 device=args.device)
hist = loop.run(args.steps)
first, last = hist[0], hist[-1]
print(f"step {first['step']}: loss {first['loss']:.3f}  ->  "
      f"step {last['step']}: loss {last['loss']:.3f}")
print(f"checkpoints in {args.ckpt_dir}; stragglers flagged: "
      f"{loop.stragglers.slow_steps}")
