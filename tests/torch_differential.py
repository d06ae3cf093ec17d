"""The port's differential harness: one compiled program, every backend.

The counterpart of `tests/differential.py` (`five_way_check`,
`cse_check`) for `repro_torch`.  One bank is compiled once into a port
`BlmacProgram`, and every leg consumes that program:

  1. **oracle**    — `lower(program, "oracle")`, the numpy Eq. 2 loop,
  2. **vmachine**  — `lower(program, "vmachine")`: outputs equal to the
                     oracle, per-output cycles equal to
                     `machine_cycles_batch` and `program.machine_cycles`,
  3. **scheduled** — `lower(program, "scheduled")`, the bank kernel K1,
  4. **engine**    — `FilterBankEngine(mode="packed")`, whose
                     `predicted_machine_cycles` equals the vmachine's,
  5. **specialized** — `lower(program, "specialized")`, K2 in one launch,
  6. **machine**   — the scalar cycle-accurate `FirBlmacMachine` on
                     sampled filters and outputs, and reject-parity on
                     every filter the vmachine's fit mask flags,
  7. **sharded**   — `lower(program, "sharded")`, the
                     `ShardedFilterBankEngine` over a mesh (``mesh``, or
                     one slot of ``device``): partition, per-shard
                     programs, halo exchange or channel split, and the
                     caller-order reassembly.

Each leg is then held against `repro` on the same program arrays
(``reference=True``): `repro.compiler` compiles the same bank to the
same ``key``, and its oracle, vmachine, cycle counts, ``"scheduled"``
and ``"sharded"`` backends must give the same numbers — the scheduled
one on the fused ``xla`` lane for 8-bit samples, where that lane is
exact, and interpreted (``lane=None``) for wider ones — and its mesh
planner (``compiled=False``) the same plan as the port's on the CPU for
the sharded leg's mesh shape.  `repro` is imported inside those legs
only, so the port's part runs without it.

`port_chaos_check` is the counterpart of the reference's `chaos_check`:
shards killed mid-stream behind `AsyncBankServer`, the recovered stream
bit-exact against the oracle, the fault counters equal to the kills.

``device`` is where the kernel legs run; None is the GPU and raises
without one, so a caller on a host without a card passes
``device="cpu"`` (the kernels' plain versions) explicitly.  Tolerance 0
everywhere: the integer paths are exact (int32 legs modulo 2**32, which
never wraps at the samples these banks take within the §2.1 bound).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.compiler import BlmacProgram, compile_bank, cse_pass, lower
from repro_torch.core import (FirBlmacMachine, MachineSpec,
                              machine_cycles_batch)
from repro_torch.filters import FilterBankEngine

__all__ = ["PortReport", "plan_fields", "port_chaos_check",
           "port_cse_check", "port_five_way_check", "scalar_machine_legs"]


@dataclass
class PortReport:
    n_filters: int
    n_out: int
    fits: np.ndarray  # (B,) bool — vectorized weight-memory verdicts
    mean_cycles: float  # over all filters, vmachine
    scalar_checked: int  # filters the scalar machine replayed
    scalar_rejected: int  # filters the scalar machine refused to program
    reference_legs: int  # legs also held against `repro`
    sharded_mesh: tuple = (1, 1)  # (n_bank_shards, n_data) of the leg


def _signal(taps: int, n_out: int, sample_bits: int, seed: int):
    lim = 1 << (sample_bits - 1)
    rng = np.random.default_rng(seed)
    return rng.integers(-lim, lim, taps - 1 + n_out)


def scalar_machine_legs(qbank, spec, fits, outputs, cycles, x, rows,
                        scalar_outputs: int) -> tuple[int, int]:
    """The scalar machine against the vmachine: ``rows`` replayed on the
    first ``scalar_outputs`` outputs of ``x`` (outputs and cycles), and
    reject-parity on every filter ``fits`` flags — `program` must raise
    exactly there.  Returns ``(checked, rejected)``."""
    taps = qbank.shape[1]
    xs = np.asarray(x, np.int64)[: taps - 1 + scalar_outputs]
    checked = rejected = 0
    for b in rows:
        m = FirBlmacMachine(spec)
        try:
            m.program(qbank[b])
        except ValueError:
            assert not fits[b], f"scalar rejected filter {b}, vmachine fit it"
            continue  # reject-parity is re-checked (and counted) below
        assert fits[b], f"vmachine rejected filter {b}, scalar programmed it"
        sres = m.run(xs)
        n = sres.outputs.size
        assert np.array_equal(sres.outputs, outputs[b, :n]), \
            f"scalar machine outputs != vmachine (filter {b})"
        assert np.array_equal(sres.cycles, cycles[b, :n]), \
            f"scalar machine cycles != vmachine (filter {b})"
        checked += 1
    for b in np.nonzero(~fits)[0]:
        m = FirBlmacMachine(spec)
        try:
            m.program(qbank[b])
        except ValueError:
            rejected += 1
            continue
        raise AssertionError(
            f"filter {b}: vmachine says overflow, scalar programmed it")
    return checked, rejected


def plan_fields(plan) -> tuple:
    """A sharded plan's fields as plain values (one tuple per shard plan),
    comparable across the two packages."""
    return (plan.n_bank_shards, plan.n_data, plan.data_mode,
            plan.predicted_us, plan.cse,
            tuple((p.mode, p.tile, p.bank_tile, p.merge, p.predicted_us,
                   p.lane, p.cse) for p in plan.shard_plans))


def _sharded_leg(program, x, oracle, mesh, device):
    """`lower(program, "sharded")` against the oracle, and its partition a
    permutation that restores the caller's order; returns the engine and
    its output."""
    sharded = lower(program, "sharded", mesh=mesh, device=device)
    seng = sharded.engine
    bank = program if program.combine is None else program.bank
    assert seng.program is bank, "sharded engine did not adopt the program"
    y = sharded(x)
    assert y.dtype == np.int32, "sharded backend is not int32"
    assert np.array_equal(y[:, 0, :].astype(np.int64), oracle), (
        f"sharded engine != oracle (mesh {seng.n_bank_shards}x"
        f"{seng.n_data}, data={seng.data_mode})")
    order = np.concatenate(seng.partition.assign)
    assert np.array_equal(np.sort(order), np.arange(bank.n_filters)), \
        "sharded partition is not a permutation of the bank"
    assert np.array_equal(order[seng.partition.inv],
                          np.arange(bank.n_filters)), \
        "sharded partition inverse does not restore caller order"
    return seng, y


def _ref_sharded_legs(program, rprog, x, y_port, seng) -> int:
    """`repro`'s ``"sharded"`` backend gives the port's outputs, and its
    mesh planner the port's plan for the port engine's mesh shape (CPU
    slots only: the card plans with its own lane).  Returns the legs
    checked."""
    from repro.compiler import lower as ref_lower
    from repro.kernels.runtime import autotune_sharded_dispatch as ref_plan

    from repro_torch.distributed import mesh_bank_shape
    from repro_torch.kernels.runtime import autotune_sharded_dispatch

    assert np.array_equal(np.asarray(ref_lower(rprog, "sharded")(x)),
                          y_port), "sharded != repro's sharded"
    if seng.mesh is None or seng.mesh.devices[0][0].type != "cpu":
        return 1
    shape = mesh_bank_shape(seng.mesh)
    mine, part, _ = autotune_sharded_dispatch(
        program, mesh_shape=shape, chunk_hint=seng._chunk_hint,
        device="cpu")
    ref, rpart, _ = ref_plan(rprog, mesh_shape=shape,
                             chunk_hint=seng._chunk_hint)
    assert plan_fields(mine) == plan_fields(ref), \
        f"sharded plan != repro's on a {shape} mesh"
    assert all(np.array_equal(a, b) for a, b in zip(part.assign,
                                                    rpart.assign)), \
        "sharded partition != repro's"
    return 2


def _ref_spec(spec: MachineSpec):
    from repro.core import MachineSpec as RefSpec

    return RefSpec(**dataclasses.asdict(spec))


def _ref_scheduled(rprog, x, tile: int, sample_bits_8: bool):
    """`repro`'s ``"scheduled"`` backend: the fused xla lane where it is
    exact (8-bit samples), the interpreted Pallas kernel otherwise."""
    from repro.compiler import lower as ref_lower

    kw = dict(lane="xla") if sample_bits_8 else {}
    return np.asarray(ref_lower(rprog, "scheduled", tile=tile,
                                interpret=True, **kw)(x))


def _is_8bit(x) -> bool:
    x = np.asarray(x)
    return bool(x.size == 0 or (x.min() >= -128 and x.max() < 128))


def port_five_way_check(
    qbank: np.ndarray | None = None,
    x: np.ndarray | None = None,
    spec: MachineSpec | None = None,
    *,
    program: BlmacProgram | None = None,
    n_out: int = 48,
    tile: int = 256,
    scalar_samples: int = 4,
    scalar_outputs: int = 8,
    seed: int = 0,
    device=None,
    mesh=None,
    reference: bool = True,
) -> PortReport:
    """Assert every backend of the port agrees on one program (module doc)
    and, with ``reference``, with `repro` on the same arrays.  ``mesh``
    is the sharded leg's `BankMesh` (None: one slot of ``device``, or
    every card).

    ``x`` defaults to a seeded signal of ``n_out`` outputs within the
    spec's sample range.  Raises AssertionError naming the leg on any
    divergence."""
    if program is None:
        if qbank is None:
            raise ValueError("port_five_way_check needs qbank or program")
        program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
    elif qbank is not None:
        assert np.array_equal(
            np.atleast_2d(np.asarray(qbank, np.int64)), program.qbank
        ), "qbank/program mismatch"
    qbank = program.qbank
    n_filters, taps = qbank.shape
    if spec is None:
        spec = MachineSpec(taps=taps)
    assert spec.taps == taps, "spec/taps mismatch"
    rng = np.random.default_rng(seed)
    if x is None:
        x = _signal(taps, n_out, spec.sample_bits, seed)
    x = np.asarray(x, np.int64)
    n_out = x.size - taps + 1

    # -- leg 1: numpy oracle (reads only program.qbank) -----------------------
    oracle = lower(program, "oracle")(x)[:, 0, :]

    # -- leg 2: vectorized machine --------------------------------------------
    vlow = lower(program, "vmachine", machine_spec=spec)
    vres = vlow.vmachine.run(x)
    fits = vlow.fits
    assert np.array_equal(vres.outputs, oracle), "vmachine outputs != oracle"
    assert np.array_equal(vlow(x)[:, 0, :], oracle), \
        "lowered vmachine != oracle"
    cm = machine_cycles_batch(
        qbank, spec.n_layers, spec.start_overhead, spec.fused_last_add
    )
    assert np.array_equal(
        vres.cycles, np.broadcast_to(cm[:, None], vres.cycles.shape)), \
        "vmachine cycles != static cost model"
    assert np.array_equal(program.machine_cycles(spec), cm), \
        "program cycle prediction != static cost model"

    # -- leg 3: the bank kernel K1 ------------------------------------------
    y = lower(program, "scheduled", tile=tile, device=device)(x)
    assert y.dtype == np.int32, "scheduled backend is not int32"
    assert np.array_equal(y[:, 0, :].astype(np.int64), oracle), \
        "scheduled (K1) != oracle"

    # -- leg 4: the streaming engine through K1 -------------------------------
    eng = FilterBankEngine(program, channels=1, tile=tile, mode="packed",
                           device=device)
    assert eng.program is program, "engine did not adopt the shared program"
    y_eng = eng.push(x)[:, 0, :]
    assert np.array_equal(y_eng.astype(np.int64), oracle), \
        "packed FilterBankEngine != oracle"
    assert np.array_equal(eng.predicted_machine_cycles(spec),
                          vres.cycles[:, 0]), \
        "FilterBankEngine cycle prediction != vmachine"

    # -- leg 5: the specialized kernel K2, one launch -------------------------
    y_sp = lower(program, "specialized", tile=tile, device=device)(x)
    assert np.array_equal(y_sp[:, 0, :].astype(np.int64), oracle), \
        "specialized (K2) != oracle"

    # -- leg 6: scalar cycle-accurate machine (sampled) -----------------------
    rows = rng.choice(n_filters, size=min(scalar_samples, n_filters),
                      replace=False)
    checked, rejected = scalar_machine_legs(
        qbank, spec, fits, vres.outputs, vres.cycles, x, rows,
        min(scalar_outputs, n_out))

    # -- leg 7: the sharded engine over a mesh --------------------------------
    seng, y_sh = _sharded_leg(program, x, oracle, mesh, device)

    # -- the reference on the same arrays -------------------------------------
    ref_legs = 0
    if reference:
        from repro.compiler import compile_bank as ref_compile
        from repro.compiler import lower as ref_lower

        rprog = ref_compile(qbank)
        assert rprog.key == program.key, "repro compiles another key"
        rspec = _ref_spec(spec)
        assert np.array_equal(ref_lower(rprog, "oracle")(x)[:, 0, :],
                              oracle), "oracle != repro's oracle"
        rvm = ref_lower(rprog, "vmachine", machine_spec=rspec)
        assert np.array_equal(rvm.fits, fits), "fit mask != repro's"
        rres = rvm.vmachine.run(x)
        assert np.array_equal(rres.outputs, vres.outputs), \
            "vmachine outputs != repro's"
        assert np.array_equal(rres.cycles, vres.cycles), \
            "vmachine cycles != repro's"
        assert np.array_equal(rprog.machine_cycles(rspec),
                              program.machine_cycles(spec)), \
            "program cycles != repro's"
        y_ref = _ref_scheduled(rprog, x, tile, _is_8bit(x))
        assert np.array_equal(y_ref, y), "scheduled != repro's scheduled"
        ref_legs = 5 + _ref_sharded_legs(program, rprog, x, y_sh, seng)

    return PortReport(
        n_filters=n_filters, n_out=n_out, fits=fits,
        mean_cycles=vres.mean_cycles, scalar_checked=checked,
        scalar_rejected=rejected, reference_legs=ref_legs,
        sharded_mesh=(seng.n_bank_shards, seng.n_data))


def port_cse_check(
    qbank: np.ndarray | None = None,
    x: np.ndarray | None = None,
    *,
    program: BlmacProgram | None = None,
    n_out: int = 48,
    tile: int = 256,
    scalar_samples: int = 4,
    scalar_outputs: int = 8,
    seed: int = 0,
    device=None,
    mesh=None,
    level=2,
    max_shared: int | None = None,
    reference: bool = True,
) -> dict:
    """CSE leg of the harness: optimize a compiled bank with the port's
    `cse_pass` and assert the optimized program equals the parent's
    oracle on every backend — the weight-level ``effective_qbank``, K1
    and K2 on the augmented rows plus the fold, the vmachine (widened
    spec, exact int64 fold), the sharded engine over ``mesh`` (the
    augmented rows partitioned, the fold at reassembly, on its device)
    and the packed engine — and the pass's
    accounting: no more pulses or §3.3 adds than the parent, and §4
    cycles equal to the augmented rows' plus one per combine use.  The
    scalar machine replays sampled augmented rows and rejects exactly
    the rows the widened vmachine flags.  With ``reference``, `repro`'s
    pass gives the same key and the same ``machine_cycles`` and
    ``shared_cycles``, its oracle, ``"scheduled"`` and ``"sharded"``
    backends the same outputs, and its mesh planner the same plan for the
    optimized program (the CSE verdict included).  Returns a small report
    dict."""
    if program is None:
        if qbank is None:
            raise ValueError("port_cse_check needs qbank or program")
        program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
    opt = cse_pass(program, level, max_shared=max_shared)
    taps = program.taps
    if x is None:
        x = _signal(taps, n_out, program.spec.sample_bits, seed)
    x = np.asarray(x, np.int64)
    oracle = lower(program, "oracle")(x)[:, 0, :]

    report = {
        "n_real": program.n_filters,
        "n_shared": 0,
        "adds_parent": program.total_adds(),
        "adds_optimized": opt.total_adds(),
        "scalar_checked": 0,
        "scalar_rejected": 0,
        "reference_legs": 0,
    }
    if opt is not program:
        report["n_shared"] = opt.n_shared

        # -- accounting ---------------------------------------------------------
        assert np.array_equal(opt.effective_qbank(), program.qbank), \
            "cse: effective_qbank != parent qbank"
        assert int(opt.pulse_counts.sum()) <= \
            int(program.pulse_counts.sum()), \
            "cse: optimized bank has more pulses than the parent"
        assert opt.total_adds() <= program.total_adds(), \
            "cse: optimized program has more §3.3 adds than the parent"
        wspec = MachineSpec(taps=taps, coeff_bits=opt.n_layers + 1)
        assert np.array_equal(
            opt.machine_cycles(),
            opt.bank.machine_cycles(wspec)[: opt.n_real] + opt.use_counts,
        ), "cse: cycle prediction != augmented cycles + combine uses"
        assert np.array_equal(
            opt.shared_cycles(), opt.bank.machine_cycles(wspec)[opt.n_real:]
        ), "cse: shared cycles != the virtual rows' cycles"

        # -- execution legs -----------------------------------------------------
        for leg in ("oracle", "scheduled", "specialized", "vmachine"):
            y = lower(opt, leg, tile=tile, device=device)(x)
            assert y.shape == (opt.n_real, 1, x.size - taps + 1), leg
            assert np.array_equal(y[:, 0, :].astype(np.int64), oracle), \
                f"cse: optimized {leg} != parent oracle"
        seng, y_sh = _sharded_leg(opt, x, oracle, mesh, device)
        report["sharded_mesh"] = (seng.n_bank_shards, seng.n_data)
        eng = FilterBankEngine(opt, channels=1, tile=tile, mode="packed",
                               device=device)
        assert eng.n_filters == opt.out_filters
        assert np.array_equal(eng.push(x)[:, 0, :].astype(np.int64),
                              oracle), "cse: packed engine != parent oracle"
        assert np.array_equal(eng.predicted_machine_cycles(),
                              opt.machine_cycles())

        # -- the scalar machine on the augmented rows, widened spec -----------
        vlow = lower(opt, "vmachine")
        assert vlow.vmachine.spec.coeff_bits == opt.n_layers + 1
        vres = vlow.vmachine.run(x)
        rng = np.random.default_rng(seed)
        rows = rng.choice(opt.n_filters,
                          size=min(scalar_samples, opt.n_filters),
                          replace=False)
        checked, rejected = scalar_machine_legs(
            opt.qbank, vlow.vmachine.spec, vlow.fits, vres.outputs,
            vres.cycles, x, rows, min(scalar_outputs, x.size - taps + 1))
        report["scalar_checked"] = checked
        report["scalar_rejected"] = rejected

    if reference:
        from repro.compiler import compile_bank as ref_compile
        from repro.compiler import cse_pass as ref_cse
        from repro.compiler import lower as ref_lower

        rparent = ref_compile(program.qbank)
        assert rparent.key == program.key, "repro compiles another parent"
        ropt = ref_cse(rparent, level, max_shared=max_shared)
        assert (ropt is rparent) == (opt is program), \
            "cse: the port and repro disagree on declining"
        assert ropt.key == opt.key, "cse: optimized key != repro's"
        if opt is not program:
            assert np.array_equal(ropt.machine_cycles(), opt.machine_cycles()), \
                "cse: machine_cycles != repro's"
            assert np.array_equal(ropt.shared_cycles(), opt.shared_cycles()), \
                "cse: shared_cycles != repro's"
            assert np.array_equal(ref_lower(ropt, "oracle")(x)[:, 0, :],
                                  oracle), "cse: oracle != repro's"
            y = lower(opt, "scheduled", tile=tile, device=device)(x)
            assert np.array_equal(_ref_scheduled(ropt, x, tile, _is_8bit(x)),
                                  y), "cse: scheduled != repro's"
            report["reference_legs"] = 4 + _ref_sharded_legs(
                opt, ropt, x, y_sh, seng)
    return report


def port_chaos_check(
    qbank: np.ndarray,
    kills,
    *,
    n_chunks: int = 6,
    chunk: int = 512,
    mesh=None,
    n_bank_shards: int | None = None,
    data_mode: str | None = None,
    depth: int = 2,
    seed: int = 0,
    device=None,
    integrity_check: bool = True,
) -> dict:
    """Chaos leg of the harness, the reference's `chaos_check` on the
    port: kill shards mid-stream and assert the recovered stream equals
    the oracle and the fault counters equal the kills.

    ``kills`` lists ``(shard, at_chunk)`` points for
    `FaultInjector.kill_shard` (shard slots at fire time: survivors
    renumber from 0 after a recovery).  The stream of ``n_chunks`` seeded
    chunks runs through `AsyncBankServer` at ``depth``; every in-flight
    chunk at a kill is replayed from its tail snapshot through the
    re-partitioned mesh.  ``mesh`` is a `BankMesh` (None: one slot of
    ``device``, or every card).  Returns the engine's ``fault_stats()``
    with the final mesh's ``n_bank_shards``/``n_data``/``data_mode``.
    """
    from repro_torch.distributed import FaultInjector, bank_mesh
    from repro_torch.filters import ShardedFilterBankEngine
    from repro_torch.serving import AsyncBankServer

    program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
    rng = np.random.default_rng(seed)
    lim = 1 << (program.spec.sample_bits - 1)
    x = rng.integers(-lim, lim, n_chunks * chunk)
    oracle = lower(program, "oracle")(x)[:, 0, :]

    injector = FaultInjector()
    kills = list(kills)
    for shard, at_chunk in kills:
        injector.kill_shard(shard, at_chunk)
    if mesh is None and device is not None:
        mesh = bank_mesh(1, 1, devices=[device])
    eng = ShardedFilterBankEngine(
        program, mesh=mesh, n_bank_shards=n_bank_shards,
        data_mode=data_mode, fault_injector=injector,
        integrity_check=integrity_check,
    )
    server = AsyncBankServer(eng, depth=depth)
    got = []
    for k in range(n_chunks):
        got += server.submit(x[k * chunk: (k + 1) * chunk])
    got += server.drain()
    y = np.concatenate([g for g in got if g.shape[2]], axis=2)[:, 0, :]
    assert np.array_equal(np.asarray(y, np.int64), oracle), (
        f"chaos: recovered stream != oracle after kills {kills} "
        f"(final mesh {eng.n_bank_shards}x{eng.n_data})"
    )
    stats = eng.fault_stats()
    assert stats["injected"]["kills"] == len(kills), (
        f"chaos: {stats['injected']['kills']} of {len(kills)} kills fired "
        f"— the grid points never hit a live (shard, chunk)"
    )
    assert stats["lost_shards"] == len(kills), stats
    assert stats["recoveries"] == len(kills), stats
    assert stats["detections"] == len(kills), stats
    assert server.failed_chunks == 0 and server.chunks_out == n_chunks, (
        "chaos: the server dropped chunks — recovery must be lossless"
    )
    return stats
