"""Serving launcher of the port: a sharded BLMAC filter-bank stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --fir-bank 256 \\
        --taps 63 --channels 1 --chunk 4096 --chunks 32

The counterpart of ``python -m repro.launch.serve --fir-bank``: the bank
(`spread_lowpass_qbank`) runs through a `ShardedFilterBankEngine` over
every visible card (a 1×1 mesh on one card), double-buffered by
`AsyncBankServer`, and the tail chunk is checked against the numpy
oracle.  ``--device cpu`` runs the kernels' plain versions on one CPU
slot; without it and without a card the launcher refuses.
``--program-path bank.npz`` round-trips the compiled program through
disk: the first run compiles and saves, later runs load it (a file
either package saved loads in the other under the same key).

``--sessions`` (multi-tenant session serving) and ``--arch`` (language
models) are not ported yet and exit with the ROADMAP item that takes
them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

__all__ = ["FirBankRun", "main", "serve_fir_bank"]


@dataclasses.dataclass
class FirBankRun:
    """What one `serve_fir_bank` run served: the engine and server, the
    input stream (C, samples), the output samples a filter and channel,
    and the host seconds of the serving loop."""

    engine: object
    server: object
    stream: np.ndarray
    samples: int
    seconds: float


def _mesh_for(device):
    """Every visible card for ``None``/``"cuda"``; one slot of any other
    device (``"cpu"``, ``"cuda:1"``)."""
    from ..distributed import bank_mesh

    if device is None or str(device) == "cuda":
        return bank_mesh()
    return bank_mesh(1, 1, devices=[device])


def serve_fir_bank(args, consume=None) -> FirBankRun:
    """The ``--fir-bank`` path: compile (or warm-start) the bank, stream
    ``args.chunks`` chunks of ``args.chunk`` seeded 8-bit samples through
    the server, print the throughput and check the tail chunk against the
    numpy oracle (a mismatch raises).  ``consume`` is called with every
    resolved (B, C, n_out) output in stream order; the loop keeps none of
    them, as the reference's does."""
    from ..compiler import BlmacProgram, ProgramFormatError, compile_bank
    from ..filters import (ShardedFilterBankEngine, fir_bit_layers_batch,
                           spread_lowpass_qbank)
    from ..serving import AsyncBankServer

    n = args.fir_bank
    qbank = spread_lowpass_qbank(n, args.taps)
    # warm-start: load the compiled program if a previous serving process
    # saved one for this bank; otherwise compile once and save it
    program = None
    if args.program_path and os.path.exists(args.program_path):
        try:
            cand = BlmacProgram.load(args.program_path)
            if np.array_equal(cand.qbank, qbank):
                program = cand
                print(f"[serve] warm-start: loaded compiled program "
                      f"{program.key[:12]}… from {args.program_path}")
            else:
                print(f"[serve] {args.program_path} is for a different "
                      f"bank; recompiling")
        except ProgramFormatError as e:
            print(f"[serve] ignoring stale program file: {e}")
    if program is None:
        program = compile_bank(qbank)
        if args.program_path:
            program.save(args.program_path)
            print(f"[serve] saved compiled program to {args.program_path}")
    engine = ShardedFilterBankEngine(
        program, channels=args.channels, mesh=_mesh_for(args.device),
        chunk_hint=args.chunk,
    )
    print(f"[serve] {engine.describe()}")
    server = AsyncBankServer(engine, depth=args.depth)
    rng = np.random.default_rng(0)
    stream = rng.integers(
        -128, 128, (args.channels, args.chunk * args.chunks)
    ).astype(np.int32)
    consume = consume or (lambda out: None)
    done = 0
    t0 = time.perf_counter()
    for k in range(args.chunks):
        for out in server.submit(stream[:, k * args.chunk:
                                        (k + 1) * args.chunk]):
            done += out.shape[2]
            consume(out)
    outs = server.drain()
    for out in outs:
        done += out.shape[2]
        consume(out)
    dt = time.perf_counter() - t0
    print(f"[serve] fir-bank: {done} samples/filter/channel in {dt:.2f}s "
          f"({done / dt:.0f} samples/s/filter, "
          f"{done * n * args.channels / dt:.3e} filter-samples/s aggregate)")
    # spot-check the tail chunk against the exact oracle
    if outs and outs[-1].shape[2]:
        tail_in = stream[:, -(outs[-1].shape[2] + args.taps - 1):]
        if not np.array_equal(outs[-1], fir_bit_layers_batch(tail_in, qbank)):
            raise RuntimeError("sharded serve output mismatch vs the numpy "
                               "oracle")
        print("[serve] tail chunk bit-exact vs numpy oracle")
    return FirBankRun(engine, server, stream, done, dt)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a sharded BLMAC filter bank on the GPU.")
    ap.add_argument("--fir-bank", type=int, default=0, metavar="B",
                    help="serve a B-filter BLMAC bank")
    ap.add_argument("--taps", type=int, default=63)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=4096,
                    help="samples per request chunk")
    ap.add_argument("--chunks", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2,
                    help="async double-buffer depth")
    ap.add_argument("--program-path", default="",
                    help="compiled-program file: load it to warm-start, "
                         "write it after compiling")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: every visible card) or 'cpu' "
                         "(the kernels' plain versions on one CPU slot)")
    ap.add_argument("--sessions", type=int, default=0, metavar="N",
                    help="multi-tenant session serving (not ported yet)")
    ap.add_argument("--arch", help="language-model serving (not ported yet)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.sessions:
        ap.error("--sessions (BankSessionServer) is not ported yet: "
                 "ROADMAP.md, queue 1, item 6")
    if args.arch:
        ap.error("--arch (language-model serving) is not ported yet: "
                 "ROADMAP.md, queue 1, item 8")
    if not args.fir_bank:
        ap.error("--fir-bank is required")
    serve_fir_bank(args)


if __name__ == "__main__":
    main()
