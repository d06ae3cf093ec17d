"""Run one cell of `BENCHMARK.json` once on the GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up (design, samples from the seed, kernels built or loaded, bank
compiled, warm-up), measures for ``--seconds``, judges the window's
outputs against the plain reference, and prints the numbers compared
with their limits as the last lines of standard error and the result as
one JSON object, the last line of standard output.  Without a CUDA
device, with fewer devices than the cell asks for, or with `jax`,
`jaxlib`, `flax` or `repro` loaded, it exits non-zero and prints no
result.  Build and kernel caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "perfbench" / "out"


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def prepare() -> None:
    """Point every build and kernel cache at a fixed directory inside
    the checkout, Python's bytecode included (an environment that asks
    for none would have every run compile torch's sources again), and
    put the checkout and its ``src`` on the path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("REPRO_TORCH_CACHE_DIR", "repro_torch")):
        os.environ[var] = str(OUT / "cache" / sub)
    sys.pycache_prefix = str(OUT / "cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare()
    t_python = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark runs only on the GPU")
        return 2
    from perfbench.harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} devices, "
             f"{torch.cuda.device_count()} found")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    _log(f"imports: python and arguments {t_python - T_START:.3f} s, torch "
         f"{t_torch - t_python:.3f} s, the card and the harness "
         f"{time.perf_counter() - t_torch:.3f} s")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                      T_START, log=_log)
    if args.trace:
        peaks = result.get("peaks") or {}
        _log(f"peaks: {peaks.get('int8_ops_per_s')} int8 ops/s, "
             f"{peaks.get('hbm_bytes_per_s')} B/s at "
             f"{peaks.get('power_w')} W (data sheet); this card: "
             f"{_power_limit()}")
    bad = forbidden_modules(sys.modules)
    if bad:
        _log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name} = {c['value']} (limit {c['limit']})")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
