"""Serving launcher of the port: a language model, a sharded BLMAC
filter-bank stream, or many tenant streams over one bank.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b

The counterpart of the reference's ``--arch`` path: the config (reduced
unless ``--no-reduced``; an ``embeds`` backbone switched to tokens),
parameters drawn from seed 0, optionally CSD-P fake-quantized
(``--quant-planes``), and a `ServeEngine` generating ``--new-tokens``
greedy tokens for ``--batch`` random prompts of ``--prompt-len``, with
the reference's defaults and printout.  ``--no-reduced`` reaches the
published widths (the reference's ``--reduced`` cannot be turned off).
``--fir-bank`` wins over ``--arch``, as in the reference.

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

Multi-tenant session serving, the counterpart of the reference's
``--sessions``: N tenant streams, each on its own slice of the bank,
continuously batched into the ``--slots`` shared lanes of one
`BankSessionServer`::

    PYTHONPATH=src python -m repro_torch.launch.serve --fir-bank 256 \\
        --taps 63 --sessions 64 --slots 8 --chunk 512 --chunks 16

It hot-swaps tenant 1's selection a third of the way in, pauses tenant 2
half way and resumes it at once, checks tenant 0's whole stream against
the numpy oracle and prints `serve_stats()`.  ``--journal-path wal/``
writes the server's state ahead to a journal that
`BankSessionServer.recover` rebuilds after a crash (see
``examples/port_session_recovery.py``); ``--bank-shards K`` runs the
lanes on a K-shard `ShardedFilterBankEngine` over the launcher's mesh
(one slot a card: on one card the shard count is clamped to 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

__all__ = ["FirBankRun", "LmRun", "SessionsRun", "main", "serve_fir_bank",
           "serve_lm", "serve_sessions"]


@dataclasses.dataclass
class LmRun:
    """What one `serve_lm` run made and served: the config, the engine
    (its parameters on the device), the prompts (B, S), the generated
    tokens (B, n) on the host, the host seconds of ``generate`` (a copy
    back included), and the quantizer's stats and seconds when
    ``--quant-planes`` was given."""

    cfg: object
    engine: object
    prompts: np.ndarray
    tokens: np.ndarray
    seconds: float
    quant_stats: dict | None = None
    quant_seconds: float = 0.0


def serve_lm(args) -> LmRun:
    """The reference's ``--arch`` serving path on ``args.device``."""
    import torch

    from ..configs import get_config
    from ..core.serve_quant import quantize_param_tree
    from ..kernels.runtime import resolve_device
    from ..nn import flatten_tree, init_params, model_decls
    from ..serving import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.input_kind == "embeds":
        cfg = dataclasses.replace(cfg, input_kind="tokens")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_decls(cfg), gen, device=dev)
    stats, quant_s = None, 0.0
    if args.quant_planes:
        t0 = time.perf_counter()
        params, stats = quantize_param_tree(flatten_tree(params),
                                            args.quant_planes, device=dev)
        quant_s = time.perf_counter() - t0
        print(f"[serve] CSD-{args.quant_planes} quantized "
              f"{stats['n_quantized']} matrices, mean rel err "
              f"{stats['mean_rel_err']:.4f}, stored bits/weight "
              f"{stats['bits_per_weight']:.1f}")
    eng = ServeEngine(cfg, params, cache_len=args.cache_len, device=dev)
    del params
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts, max_new_tokens=args.new_tokens).cpu().numpy()
    dt = time.time() - t0
    print(f"[serve] {args.arch}: generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print(out[:2])
    return LmRun(cfg, eng, prompts, out, dt, stats, quant_s)


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


@dataclasses.dataclass
class SessionsRun:
    """What one `serve_sessions` run served: the program and server, each
    tenant's filter rows and input stream (n,), each tenant's outputs in
    pull order (each (len(rows), n_i)), the host seconds of every
    ``server.step()`` and of the whole serving loop, and the server's
    `serve_stats()` at the loop's end (its journal's counters included:
    the server is closed after it)."""

    program: object
    server: object
    selections: list
    streams: list
    outputs: list
    step_seconds: list
    seconds: float
    stats: dict

    def tenant_output(self, i: int) -> np.ndarray:
        """Tenant ``i``'s whole output stream, (len(rows), n)."""
        return np.concatenate(self.outputs[i], axis=1)


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


def serve_sessions(args, mesh=None, journal_fsync: bool = True) -> SessionsRun:
    """The ``--sessions`` path: ``args.sessions`` tenant streams of
    ``args.chunks`` seeded 8-bit chunks over one compiled bank, the
    reference's schedule (one `swap_filters`, one pause and resume),
    tenant 0 checked against the numpy oracle (a mismatch raises).
    ``mesh`` is the `BankMesh` of ``--bank-shards`` (default: the
    launcher's, one slot a card or ``--device``); ``journal_fsync=False``
    keeps a journal's SIGKILL durability without its fsyncs."""
    from ..compiler import compile_bank
    from ..filters import fir_bit_layers_batch, spread_lowpass_qbank
    from ..serving import BankSessionServer

    n, n_sessions = args.fir_bank, args.sessions
    program = compile_bank(spread_lowpass_qbank(n, args.taps))
    engine = None
    if args.bank_shards:
        from ..filters import ShardedFilterBankEngine

        engine = ShardedFilterBankEngine(
            program, channels=args.slots,
            mesh=mesh if mesh is not None else _mesh_for(args.device),
            n_bank_shards=args.bank_shards, chunk_hint=args.chunk,
        )
        print(f"[serve] sessions × shards: {engine.describe()}")
    server = BankSessionServer(
        program, n_slots=args.slots, chunk_hint=args.chunk, auto_step=False,
        engine=engine, device=args.device,
        journal=args.journal_path or None, journal_fsync=journal_fsync,
    )
    if args.journal_path:
        print(f"[serve] journaling session state to {args.journal_path}")
    rng = np.random.default_rng(0)
    # each session selects a distinct contiguous row slice of the bank
    per = max(1, n // n_sessions)
    selections = [np.arange((i * per) % n, (i * per) % n + per)
                  for i in range(n_sessions)]
    sessions = [server.open_session(sel) for sel in selections]
    streams = [rng.integers(-128, 128, args.chunk * args.chunks)
               .astype(np.int32) for _ in range(n_sessions)]
    outs = [[] for _ in range(n_sessions)]
    step_s = []

    def step():
        t = time.perf_counter()
        server.step()
        step_s.append(time.perf_counter() - t)

    def pull_all():
        for i, s in enumerate(sessions):
            out = s.pull()
            if out.shape[1]:
                outs[i].append(out)

    paused = None
    t0 = time.perf_counter()
    for k in range(args.chunks):
        if k == args.chunks // 3 and n_sessions > 1:
            # mid-run zero-downtime selection hot-swap on session 1
            outs[1].append(sessions[1].swap_filters(selections[1]))
        if k == args.chunks // 2 and n_sessions > 2:
            # park tenant 2 mid-stream (nothing is queued: the pause
            # flushes nothing, and its handle's outbox stays empty)
            paused = (2, sessions[2].pause())
        for i, s in enumerate(sessions):
            if paused and i == paused[0]:
                continue
            s.push(streams[i][k * args.chunk:(k + 1) * args.chunk])
        step()
        if paused and k == args.chunks // 2:
            # ...and resume it at once: a bit-exact continuation
            sessions[paused[0]] = server.resume_session(
                paused[1], selections[paused[0]])
        pull_all()
    # feed the paused session the chunks it missed, then drain everyone
    if paused:
        i = paused[0]
        sessions[i].push(streams[i][(args.chunks // 2) * args.chunk:])
    step()
    pull_all()
    dt = time.perf_counter() - t0
    stats = server.serve_stats()
    agg = stats["samples_out"]
    print(f"[serve] sessions: {n_sessions} tenants × {per} filters over a "
          f"{n}-filter bank, {args.slots} shared lanes")
    print(f"[serve] {agg} output samples in {dt:.2f}s "
          f"({agg / dt:.0f} samples/s aggregate), "
          f"occupancy {stats['occupancy']:.2f}, "
          f"rounds {stats['rounds']}, "
          f"p50 {stats['latency_p50_ms']:.1f}ms / "
          f"p99 {stats['latency_p99_ms']:.1f}ms")
    # check one whole session stream against the exact numpy oracle
    check = 0
    got = np.concatenate(outs[check], axis=1)
    ref = fir_bit_layers_batch(streams[check][None, :],
                               program.qbank[selections[check]])[:, 0]
    if not np.array_equal(got, ref):
        raise RuntimeError(f"session {check} stream mismatch vs the numpy "
                           f"oracle")
    print(f"[serve] session {check} bit-exact vs numpy oracle "
          f"({got.shape[1]} samples × {got.shape[0]} filters)")
    if stats.get("journal"):
        j = stats["journal"]
        print(f"[serve] journal: {j['appends']} appends, {j['syncs']} "
              f"fsyncs, {j['rotations']} rotations, live segment "
              f"{j['segment_bytes']} bytes at {j['path']}")
    server.close()
    return SessionsRun(program, server, selections, streams, outs, step_s, dt,
                       stats)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a language model, a sharded BLMAC filter bank, "
                    "or many tenant streams over one, on the GPU.")
    ap.add_argument("--arch", help="LM architecture (omit with --fir-bank)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--quant-planes", type=int, default=0,
                    help="CSD-P pulse-code weight quantization (0 = off)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the config's reduced widths (default); "
                         "--no-reduced serves the published widths")
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
                    help="serve N multi-tenant session streams over the "
                         "bank instead of one sharded stream")
    ap.add_argument("--slots", type=int, default=8,
                    help="shared batching lanes of the session server")
    ap.add_argument("--journal-path", default="",
                    help="write-ahead session journal directory (sessions "
                         "mode): makes the server crash-safe via "
                         "BankSessionServer.recover()")
    ap.add_argument("--bank-shards", type=int, default=0, metavar="K",
                    help="run the session lanes on a K-shard sharded "
                         "filter-bank engine (sessions mode, 0 = the plain "
                         "engine)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.fir_bank and args.sessions:
        serve_sessions(args)
        return
    if args.fir_bank:
        serve_fir_bank(args)
        return
    if not args.arch:
        ap.error("--arch is required unless --fir-bank is given")
    serve_lm(args)


if __name__ == "__main__":
    main()
