"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 200 --batch 32 --seq 512 --ckpt-dir run1

The counterpart of ``python -m repro.launch.train``, with its flags and
defaults: a config (reduced unless ``--full-config``; an ``embeds``
backbone switched to tokens), the synthetic pipeline (``--data``), and
the fault-tolerant `TrainLoop` — keep-k checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir``, auto-resume from the latest,
the straggler watchdog — for ``--steps`` steps.  Runs on the GPU;
``--device cpu`` runs on the host.  Prints the reference's summary line.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train a language model with checkpoints and "
                    "auto-resume, on the GPU.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-scale config (the default)")
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--data", choices=("markov", "uniform"), default="markov")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from ..configs import get_config
    from ..data import DataConfig, TokenPipeline
    from ..distributed.fault import TrainLoop
    from ..training import OptHParams, TrainHParams

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.input_kind == "embeds":
        cfg = dataclasses.replace(cfg, input_kind="tokens")  # text-only demo

    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq, kind=args.data))
    hp = TrainHParams(
        opt=OptHParams(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps),
        grad_accum=args.grad_accum)
    loop = TrainLoop(cfg, hp, pipe, args.ckpt_dir,
                     ckpt_every=args.ckpt_every, device=args.device)
    hist = loop.run(args.steps)
    if not hist:
        print(f"[train] {args.arch}: already at step {loop.step} in "
              f"{args.ckpt_dir}; nothing to run")
        return
    print(f"[train] {args.arch}: step {hist[0]['step']} loss "
          f"{hist[0]['loss']:.3f} -> step {hist[-1]['step']} loss "
          f"{hist[-1]['loss']:.3f}; stragglers={loop.stragglers.slow_steps}")


if __name__ == "__main__":
    main()
