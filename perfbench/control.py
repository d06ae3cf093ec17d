"""The control of `correct`, on the GPU: the plain reference put in the
program's place and computed one precision lower (float32 with TF32 off,
`reference.control_block`), run through the whole harness at the cell's
own size, on several seeds in one process.  The benchmark's own runs
never run this; the program's readings come from `perfbench/run.py`.

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one JSON line a seed: the seed, ``correct`` and the numbers
compared with their limits.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.run import prepare  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    prepare()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.design import design_bank
    from perfbench.harness import load_cell, run_cell
    from perfbench.reference import control_block

    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    q = torch.as_tensor(design_bank(cell.config["design"]), device=dev)

    def control(entry):
        return lambda x: control_block(x, q)

    for seed in args.seeds:
        r = run_cell(cell, seed, args.seconds, False, dev,
                     time.perf_counter(), entry_wrap=control)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": r["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
