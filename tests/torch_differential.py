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
`port_session_chaos_check` is the counterpart of `session_chaos_check`:
tenants batched into the lanes of a `BankSessionServer` over the sharded
engine, shards killed mid-`step()`, every tenant bit-exact and each
fault attributed to the tenants of its round only.

`ref_param_arrays` and `ref_lm_params` carry `repro`'s language-model
parameters across (numpy arrays under the reference's key paths, then
`repro_torch.nn.params_from_arrays`) for the ``test_torch_lm_*`` files;
`lm_train_batch`, `adam_drift_bound` and `train_tree_gap` serve the
``test_torch_train_*`` files (a batch for both packages, and a
train-state tree of the port held against `repro`'s leaf by leaf);
`train_card_vs_cpu` holds the port's train step on the card against its
own on the CPU, for the card tests and `chip_smoke.py`; `mesh_vs` holds
a reduced arch's train steps and decode on a (2, 4) mesh of slots
against the same unsharded or on another mesh (the card tests hold
``cuda:0`` slots against CPU slots, `chip_smoke.py` against the card
unsharded).

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
           "port_cse_check", "port_five_way_check",
           "port_session_chaos_check", "ref_config", "ref_lm_params",
           "ref_param_arrays", "scalar_machine_legs", "lm_train_batch",
           "adam_drift_bound", "mesh_vs", "train_card_vs_cpu",
           "train_tree_gap"]


def ref_param_arrays(params) -> dict:
    """`repro`'s parameter tree as ``{key path: numpy array}``, the
    path's keys joined by ``"/"`` (as its `quantize_param_tree` names
    them)."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def ref_config(cfg):
    """The port's `ModelConfig` as `repro`'s, field for field."""
    from repro.configs import ModelConfig

    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def ref_lm_params(cfg, seed: int = 0, device="cpu"):
    """(`repro`'s parameters of ``cfg`` from ``jax.random.key(seed)``, the
    same values as the port's tree on ``device``)."""
    import jax

    from repro.nn import init_params, model_decls
    from repro_torch.nn import params_from_arrays

    params = init_params(model_decls(ref_config(cfg)), jax.random.key(seed))
    return params, params_from_arrays(cfg, ref_param_arrays(params), device)


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


def port_session_chaos_check(
    qbank: np.ndarray,
    kills,
    *,
    n_sessions: int = 8,
    n_slots: int = 4,
    rows_per_session: int = 2,
    n_chunks: int = 6,
    chunk: int = 256,
    n_bank_shards: int | None = None,
    mesh=None,
    seed: int = 0,
    journal_path=None,
    device=None,
    integrity_check: bool = False,
    sample_bits: int | None = None,
) -> dict:
    """Sessions × shards chaos leg, the reference's `session_chaos_check`
    on the port: ``n_sessions`` tenant streams batched into the
    ``n_slots`` lanes of a `BankSessionServer` whose dispatches run
    through a `ShardedFilterBankEngine`, with shards killed mid-`step()`.

    Every tenant's joined stream must equal the oracle for its own
    (stream, rows) to the last bit (modulo 2**32: ``sample_bits`` wider
    than the program's bound wraps the int32 outputs, which the
    integrity probe must not read as corruption), and each detected fault
    is attributed to the tenants of the failed round only: ``kills`` ×
    ``n_slots`` in all when every round is full.  ``mesh`` is a
    `BankMesh` (None: one slot of ``device``, or every card);
    ``journal_path`` journals the run.  Returns the server's
    ``fault_stats()``."""
    from repro_torch.distributed import FaultInjector, bank_mesh
    from repro_torch.filters import ShardedFilterBankEngine
    from repro_torch.serving import BankSessionServer

    program = compile_bank(np.atleast_2d(np.asarray(qbank, np.int64)))
    rng = np.random.default_rng(seed)
    lim = 1 << ((sample_bits or program.spec.sample_bits) - 1)
    n = program.n_filters
    sels = [
        np.sort(rng.choice(n, size=min(rows_per_session, n), replace=False))
        for _ in range(n_sessions)
    ]
    streams = [
        rng.integers(-lim, lim, n_chunks * chunk).astype(np.int32)
        for _ in range(n_sessions)
    ]

    def oracle(x, rows):  # the numpy Eq. 2 loop over the tenant's rows
        return lower(program.select(rows), "oracle")(x)[:, 0, :]

    injector = FaultInjector()
    kills = list(kills)
    for shard, at_chunk in kills:
        injector.kill_shard(shard, at_chunk)
    if mesh is None and device is not None:
        mesh = bank_mesh(1, 1, devices=[device])
    eng = ShardedFilterBankEngine(
        program, channels=n_slots, mesh=mesh, n_bank_shards=n_bank_shards,
        fault_injector=injector, integrity_check=integrity_check,
    )
    server = BankSessionServer(
        program, n_slots=n_slots, auto_step=False, engine=eng,
        step_budget_us=1e12, journal=journal_path,
    )
    sessions = [server.open_session(sel) for sel in sels]
    outs = [[] for _ in range(n_sessions)]
    for k in range(n_chunks):
        for i, s in enumerate(sessions):
            s.push(streams[i][k * chunk: (k + 1) * chunk])
        server.step()
        for i, s in enumerate(sessions):
            out = s.pull()
            if out.shape[1]:
                outs[i].append(out)
    for i in range(n_sessions):
        want = oracle(streams[i], sels[i]).astype(np.int32)
        got = np.concatenate(outs[i], axis=1)
        assert np.array_equal(got, want), (
            f"session chaos: tenant {i} diverged from its oracle after "
            f"kills {kills} (final mesh {eng.n_bank_shards}x{eng.n_data})"
        )
    stats = server.fault_stats()
    assert stats["injected"]["kills"] == len(kills), stats
    assert stats["lost_shards"] == len(kills), stats
    assert stats["recoveries"] == len(kills), stats
    assert stats["corruptions"] == 0, stats
    # per-tenant isolation: each kill marked one round's tenants, and
    # only them — total attributed faults = kills × round size
    marked = sum(stats["per_session"].values())
    assert marked <= len(kills) * n_slots, stats
    if n_sessions % n_slots == 0:  # every round full
        assert marked == len(kills) * n_slots, stats
    assert stats["session_faults"] == len(kills), stats
    server.close()
    return stats


# ---------------------------------------------------------------------------
# language models: one reduced arch through `repro` and the port
# ---------------------------------------------------------------------------

LM_BATCH, LM_PROMPT, LM_CACHE, LM_DECODE_STEPS = 2, 12, 32, 4


@dataclass
class LmCase:
    """One reduced arch in float32 through both packages on the CPU: the
    prefill (`forward` with a cache), `LM_DECODE_STEPS` decode steps, the
    loss and `ServeEngine.generate` — the reference's outputs (numpy) and
    the port's (tensors)."""

    cfg: object
    ref: dict
    port: dict


def _lm_inputs(cfg, rng):
    b, s = LM_BATCH, LM_PROMPT
    inp = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "mask": (rng.uniform(size=(b, s)) < 0.8).astype(np.float32)}
    if cfg.input_kind == "embeds":
        inp["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
        steps = [{"embed": rng.standard_normal((b, 1, cfg.d_model))
                  .astype(np.float32)} for _ in range(LM_DECODE_STEPS)]
    else:
        inp["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
        steps = [{"token": rng.integers(0, cfg.vocab_size, (b, 1))
                  .astype(np.int32)} for _ in range(LM_DECODE_STEPS)]
    return inp, steps


def lm_case(arch: str, seed: int = 0) -> LmCase:
    """`arch` reduced, compute float32, with the same converted
    parameters in both packages (`ref_lm_params`)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.nn import ShardCtx as RCtx
    from repro.nn import loss_fn as r_loss
    from repro.serving import ServeEngine as RServe
    from repro_torch.configs import get_config
    from repro_torch.nn import ShardCtx, loss_fn
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    rparams, tparams = ref_lm_params(cfg, seed)
    inp, steps = _lm_inputs(cfg, np.random.default_rng(seed))
    key = "embeds" if cfg.input_kind == "embeds" else "tokens"
    ref, port = {}, {}
    # prefill and decode: the engines' own steps
    reng = RServe(ref_config(cfg), rparams, cache_len=LM_CACHE)
    teng = ServeEngine(cfg, tparams, cache_len=LM_CACHE, device="cpu")
    rlog, rstate = reng._prefill(rparams, {key: jnp.asarray(inp[key])})
    with torch.inference_mode():
        tlog, tstate = teng._prefill(teng.params,
                                     {key: torch.tensor(inp[key])})
    ref["prefill"] = np.asarray(rlog)
    port["prefill"] = tlog
    ref["caches"] = jax.tree_util.tree_map(np.asarray, rstate["caches"])
    port["caches"] = [tuple({k: t.clone() for k, t in c.items()} for c in st)
                      for st in tstate["caches"]]
    ref["decode"], port["decode"] = [], []
    for step in steps:
        rlog, rstate = reng._decode(
            rparams, {k: jnp.asarray(v) for k, v in step.items()}, rstate)
        with torch.inference_mode():
            tlog, tstate = teng._decode(
                teng.params, {k: torch.tensor(v) for k, v in step.items()},
                tstate)
        ref["decode"].append(np.asarray(rlog))
        port["decode"].append(tlog)
    ref["decode_caches"] = jax.tree_util.tree_map(np.asarray,
                                                  rstate["caches"])
    port["decode_caches"] = tstate["caches"]
    # the loss (its value) and the forward's aux
    pos = np.broadcast_to(np.arange(LM_PROMPT)[None],
                          (LM_BATCH, LM_PROMPT)).astype(np.int32)
    rloss, rmet = jax.jit(lambda p, b: r_loss(p, b, ref_config(cfg), RCtx(
        positions=jnp.asarray(pos), compute_dtype=jnp.float32)))(
            rparams, {k: jnp.asarray(v) for k, v in inp.items()})
    tloss, tmet = loss_fn(tparams, {k: torch.tensor(v) for k, v in
                                    inp.items()}, cfg,
                          ShardCtx(positions=torch.tensor(pos),
                                   compute_dtype=torch.float32))
    ref["loss"], ref["metrics"] = float(rloss), {k: float(v) for k, v in
                                                 rmet.items()}
    port["loss"], port["metrics"] = float(tloss), {k: float(v) for k, v in
                                                   tmet.items()}
    # greedy generation (an embeds backbone served on tokens, as the
    # launchers do)
    if cfg.input_kind == "embeds":
        gcfg = dataclasses.replace(cfg, input_kind="tokens")
        rparams, tparams = ref_lm_params(gcfg, seed)
        reng = RServe(ref_config(gcfg), rparams, cache_len=LM_CACHE)
        teng = ServeEngine(gcfg, tparams, cache_len=LM_CACHE, device="cpu")
    prompts = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    ref["generate"] = np.asarray(reng.generate(prompts, LM_DECODE_STEPS + 1))
    port["generate"] = teng.generate(prompts, LM_DECODE_STEPS + 1)
    return LmCase(cfg, ref, port)


# training: one batch for both packages, and a state held leaf by leaf
# ---------------------------------------------------------------------------


def lm_train_batch(cfg, rows: int, seq: int, seed: int) -> dict:
    """A training batch of numpy arrays for ``cfg``: tokens (or embeds),
    labels, and a mask with about a fifth of its entries 0."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (rows, seq))
             .astype(np.int32),
             "mask": (rng.uniform(size=(rows, seq)) < 0.8).astype(np.float32)}
    if cfg.input_kind == "embeds":
        batch["embeds"] = rng.standard_normal((rows, seq, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (rows, seq)) \
            .astype(np.int32)
    return batch


# leaves whose gradient is tiny beside their scale after a step, so that
# Adam turns the rounding of most of their elements into lr-sized updates:
# the attention key bias (zero at init; the softmax over keys cancels
# every part of q·bk that does not vary with the key's position)
NEAR_ZERO_GRAD_LEAVES = ("mixer/bk",)
# elsewhere, at most this share of a leaf's elements may be so excused
AMPLIFIED_SHARE = 0.01
# an element's moments are "tight" when its m agrees within this share of
# the bound of itself and its v within that (see `train_tree_gap`)
TIGHT_M, TIGHT_V = 0.25, 0.5


def adam_drift_bound(hp, steps) -> float:
    """The most one parameter element can differ between two AdamW runs
    from the same state through the optimizer steps ``steps`` (the
    ``step`` values before each update), whatever their gradients.

    A step moves an element by lr_t·|m̂/(√v̂ + eps)| (plus the decay,
    which shrinks a difference), and by Cauchy–Schwarz over the moments'
    weights aᵢ = (1−b1)·b1^(t−i), cᵢ = (1−b2)·b2^(t−i),
    |m̂|/√v̂ ≤ √(Σ aᵢ²/cᵢ) · √(1−b2^t) / (1−b1^t) =: ρ_t (1 at t = 1,
    1.17 at most for b1 0.9, b2 0.95); so two runs part by at most
    2·Σ lr_t·ρ_t.  ``hp``: the port's `OptHParams`."""
    import torch

    from repro_torch.training import schedule

    total = 0.0
    for step in steps:
        t = step + 1
        s = sum((1 - hp.b1) ** 2 * hp.b1 ** (2 * (t - i))
                / ((1 - hp.b2) * hp.b2 ** (t - i)) for i in range(1, t + 1))
        rho = np.sqrt(s) * np.sqrt(1 - hp.b2 ** t) / (1 - hp.b1 ** t)
        total += float(schedule(hp, torch.tensor(step))) * rho
    return 2.0 * total


def train_tree_gap(port: dict, ref: dict, bound: float, opt=None,
                   drift: float | None = None) -> dict:
    """``port`` (a flat tree of tensors) against ``ref`` (numpy arrays
    or tensors under the same ``"/"`` keys), each leaf's max |difference|
    over its max |ref|, held to ``bound``.

    AdamW normalises each element by its own moments
    (u = m̂ / (√v̂ + eps)), and to first order u moves by
    |Δm|/|m| + ½·|Δv|/|v| of itself.  With ``opt = (port's optimizer
    state, ref's)`` (flat, ``"m/<leaf>"`` and ``"v/<leaf>"`` keys) each
    element of a leaf with moments is classed by its own moments:

      * *tight* when its m agrees within ``TIGHT_M · bound`` of itself
        and its v within ``TIGHT_V · bound``: its update then agrees
        within ``bound / 2`` of itself, so its param — which the updates
        moved by at most its leaf's scale — within ``bound / 2`` of the
        leaf's scale.  It is held to ``bound``.
      * *loose* otherwise: its rounding, relatively large where its
        gradient is small beside its leaf's largest, may turn into an
        update of order ``lr``.  It is held to ``drift``, the most two
        AdamW runs can part (`adam_drift_bound`, required with ``opt``);
        beyond ``bound`` of its leaf's scale it is counted under
        ``"amplified"``, and such elements must be at most
        `AMPLIFIED_SHARE` of the leaf's unless the leaf is one of
        `NEAR_ZERO_GRAD_LEAVES` (past that share the leaf's loose
        elements are held to ``bound`` too).

    Every other element is held to ``bound``.  Returns ``{"worst": the
    largest gap of the elements so held (over the leaf's scale; a tight
    element's, unless an excuse's limit broke), "worst_leaf",
    "loose_worst", "loose_worst_leaf": the largest gap of the loose
    elements, "amplified": count, "amplified_leaves",
    "amplified_by_leaf": {leaf: (count, share of the leaf)},
    "amplified_max": the largest amplified difference, "drift"}``.  The
    arithmetic is float64, on the device of each ``port`` leaf."""
    if opt is not None and drift is None:
        raise ValueError("an excuse for Adam's amplified rounding needs "
                         "drift= (adam_drift_bound)")
    import torch

    out = {"worst": 0.0, "worst_leaf": None, "loose_worst": 0.0,
           "loose_worst_leaf": None, "amplified": 0, "amplified_leaves": [],
           "amplified_by_leaf": {}, "amplified_max": 0.0, "drift": drift}
    for k, t in port.items():
        # float64 on the port leaf's device (a card compares on the card)
        dev = t.device if hasattr(t, "device") else torch.device("cpu")

        def f64(x):
            if not torch.is_tensor(x):  # a numpy array: a float64 copy
                x = torch.from_numpy(np.array(x, dtype=np.float64))
            return x.to(dev).to(torch.float64)

        r = f64(ref[k])
        d = (f64(t) - r).abs()
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1e-30)
        if opt is not None and f"m/{k}" in opt[1]:
            loose = torch.zeros(r.shape, dtype=torch.bool, device=dev)
            for mom, tol in (("m", TIGHT_M * bound), ("v", TIGHT_V * bound)):
                mp, mr = f64(opt[0][f"{mom}/{k}"]), f64(opt[1][f"{mom}/{k}"])
                loose |= (mp - mr).abs() > tol * mr.abs()
            lw = float(torch.where(loose, d, 0.0).max()) / scale
            if lw > out["loose_worst"]:
                out["loose_worst"], out["loose_worst_leaf"] = lw, k
            excusable = loose & (d <= drift)
            amp = excusable & (d > bound * scale)
            whole = any(k.endswith(s) for s in NEAR_ZERO_GRAD_LEAVES)
            n_amp = int(amp.sum())
            if whole or n_amp <= AMPLIFIED_SHARE * d.numel():
                if n_amp:
                    out["amplified"] += n_amp
                    out["amplified_leaves"].append(k)
                    out["amplified_by_leaf"][k] = (n_amp, n_amp / d.numel())
                    out["amplified_max"] = max(out["amplified_max"],
                                               float(d[amp].max()))
                d = torch.where(excusable, 0.0, d)
        gap = float(d.max()) / scale if d.numel() else 0.0
        if gap > out["worst"]:
            out["worst"], out["worst_leaf"] = gap, k
    return out


def train_card_vs_cpu(archs, device, bound: float = 1e-4,
                      steps: int = 2) -> dict:
    """``steps`` train steps of each reduced arch in float32, TF32 off, on
    the card ``device`` and on the CPU from one parameter tree (from a CPU
    generator, seed 0), on the same batches; the first step runs at the
    schedule's lr 0, the next at its peak 1e-3.

    Returns ``{arch: report}``: ``"ok"`` when every step's metrics are
    within ``bound`` of the CPU's (relative, over a floor of 0.01), the
    params within ``bound`` of each leaf's scale (`train_tree_gap`, Adam's
    amplified rounding counted within its limits) and the optimizer
    state within ``bound`` of each leaf's scale; the gaps themselves
    beside it.  Adafactor (deepseek-v3-671b's own optimizer) has no
    ``m``: its params get no excuse."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn import flatten_tree, init_params, model_decls
    from repro_torch.nn.common import map_tree
    from repro_torch.training import (OptHParams, TrainHParams,
                                      make_train_step, train_state_init)

    opt_hp = OptHParams(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for arch in archs:
            cfg = get_config(arch).reduced(compute_dtype="float32")
            params = init_params(model_decls(cfg),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
            states = {"cpu": train_state_init(params, cfg),
                      "card": train_state_init(
                          map_tree(lambda t: t.to(device, copy=True),
                                   params), cfg)}
            step = make_train_step(cfg, TrainHParams(opt=opt_hp))
            met_rel = 0.0
            for i in range(steps):
                batch = lm_train_batch(cfg, 4, 16, seed=i)
                met = {}
                for name, dev in (("cpu", "cpu"), ("card", device)):
                    states[name], met[name] = step(states[name], {
                        k: torch.as_tensor(v).to(dev)
                        for k, v in batch.items()})
                for k, v in met["cpu"].items():
                    met_rel = max(met_rel, abs(float(met["card"][k])
                                               - float(v))
                                  / max(abs(float(v)), 1e-2))
            card_opt = flatten_tree(states["card"]["opt"])
            cpu_opt = flatten_tree(states["cpu"]["opt"])
            gp = train_tree_gap(flatten_tree(states["card"]["params"]),
                                flatten_tree(states["cpu"]["params"]), bound,
                                opt=(card_opt, cpu_opt),
                                drift=adam_drift_bound(opt_hp, range(steps)))
            go = train_tree_gap(card_opt, cpu_opt, bound)
            on_card = all(t.device.type == torch.device(device).type
                          for t in card_opt.values())
            out[arch] = {
                "ok": bool(met_rel <= bound and gp["worst"] <= bound
                           and go["worst"] <= bound and on_card),
                "optimizer": cfg.optimizer, "metrics_rel": met_rel,
                "params_rel": gp["worst"], "params_worst_leaf":
                gp["worst_leaf"], "params_loose_rel": gp["loose_worst"],
                "amplified": gp["amplified"],
                "amplified_leaves": gp["amplified_leaves"],
                "amplified_max": gp["amplified_max"], "drift": gp["drift"],
                "opt_rel": go["worst"], "opt_worst_leaf": go["worst_leaf"]}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def mesh_vs(arch: str, devices, ref, bound: float = 1e-4,
            steps: int = 2) -> dict:
    """``arch`` reduced, float32 with TF32 off, on a (2, 4) mesh of the
    slot ``devices`` against ``ref``: one device (the step and engine
    unsharded there) or 8 slot devices (a (2, 4) mesh of them).  MoE
    archs take ``moe_groups = 2``.  From one parameter tree (a CPU
    generator, seed 0): ``steps`` train steps on the same batches (the
    first at the schedule's lr 0, the next at its peak 1e-3; 8 rows ×
    16), then greedy generation of 5 tokens from 4 prompts of 12 in both
    decode cases (the batch over ``data``; a batch below the data size).

    Returns ``"ok"`` when every step's metrics are within ``bound`` of
    the reference's (relative, over a floor of 0.01), the params and the
    optimizer state within ``bound`` of each leaf's scale (the params
    under `train_tree_gap`'s limits for Adam's amplified rounding), the
    tokens equal and each emitted token's logits within ``bound`` of
    their scale; the gaps beside it, with the loose elements' largest gap
    and the amplified elements' count and share a leaf."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import (batch_shardings, device_put,
                                         gather, make_mesh, make_rules,
                                         sanitized_shardings)
    from repro_torch.nn import flatten_tree, init_params, model_decls
    from repro_torch.nn.common import map_tree
    from repro_torch.serving import ServeEngine
    from repro_torch.training import (OptHParams, TrainHParams,
                                      make_train_step, train_state_init,
                                      train_state_pspecs)

    opt_hp = OptHParams(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    cfg = get_config(arch).reduced(compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=2)
    hp = TrainHParams(opt=opt_hp)
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def side(devs):
        """(mesh or None, the device batches go to)."""
        if isinstance(devs, (list, tuple)):
            mesh = make_mesh((2, 4), ("data", "model"), devices=devs)
            return mesh, mesh.devices.flat[0]
        return None, torch.device(devs)

    def placed_state(mesh, dev):
        st = train_state_init(map_tree(lambda t: t.to(dev, copy=True),
                                       params), cfg)
        if mesh is None:
            return st
        return device_put(st, sanitized_shardings(mesh, train_state_pspecs(
            cfg, model_decls(cfg), make_rules(mesh, "train")), st))

    try:
        runs = {}
        for name, devs in (("mesh", devices), ("ref", ref)):
            mesh, dev = side(devs)
            rules = make_rules(mesh, "train") if mesh is not None else None
            state = placed_state(mesh, dev)
            step = make_train_step(cfg, hp, mesh, rules)
            mets = []
            for i in range(steps):
                batch = {k: torch.as_tensor(v).to(dev) for k, v in
                         lm_train_batch(cfg, 8, 16, seed=i).items()}
                if mesh is not None:
                    batch = device_put(batch, batch_shardings(mesh, rules,
                                                              batch))
                state, m = step(state, batch)
                mets.append({k: float(v) for k, v in m.items()})
            gen = []
            # an embeds backbone is served on tokens, as the launchers do
            gcfg = dataclasses.replace(cfg, input_kind="tokens")
            gparams = params if gcfg == cfg else init_params(
                model_decls(gcfg), torch.Generator().manual_seed(0),
                device="cpu")
            prompts = np.random.default_rng(1).integers(
                0, cfg.vocab_size, (4, 12)).astype(np.int32)
            for gb in (None, 1):
                kw = ({"device": dev} if mesh is None else
                      {"mesh": mesh, "rules": make_rules(mesh, "decode", gb)})
                eng = ServeEngine(gcfg, gparams, cache_len=32, **kw)
                tok, lg = eng.generate(prompts, 5, with_logits=True)
                gen.append((tok.cpu(), [x.cpu() for x in lg]))
            runs[name] = (mets, gather(state, "cpu"), gen)
        (mm, ms, mg), (rm, rs, rg) = runs["mesh"], runs["ref"]
        met_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2)
                      for a, b in zip(mm, rm) for k in b)
        mopt, ropt = flatten_tree(ms["opt"]), flatten_tree(rs["opt"])
        gp = train_tree_gap(flatten_tree(ms["params"]),
                            flatten_tree(rs["params"]), bound,
                            opt=(mopt, ropt) if cfg.optimizer == "adamw"
                            else None,
                            drift=adam_drift_bound(opt_hp, range(steps)))
        go = train_tree_gap(mopt, ropt, bound)
        tokens_equal = all(torch.equal(a[0], b[0]) for a, b in zip(mg, rg))
        logit_rel = max(float((x - y).abs().max() / y.abs().max())
                        for a, b in zip(mg, rg) for x, y in zip(a[1], b[1]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"ok": bool(met_rel <= bound and gp["worst"] <= bound
                       and go["worst"] <= bound and tokens_equal
                       and logit_rel <= bound),
            "optimizer": cfg.optimizer, "metrics_rel": met_rel,
            "params_rel": gp["worst"], "params_worst_leaf": gp["worst_leaf"],
            "params_loose_rel": gp["loose_worst"],
            "amplified": gp["amplified"],
            "amplified_by_leaf": gp["amplified_by_leaf"],
            "opt_rel": go["worst"], "tokens_equal": tokens_equal,
            "logits_rel": logit_rel}


def dryrun_vs_step(arch: str, devices, mesh_shape=(2, 4), rows: int = 4,
                   seq: int = 16) -> dict:
    """A reduced arch's train step (B ``rows`` × ``seq``) run once on a
    mesh of ``devices`` slots, and the port's dry run of the same cell on
    ``meta`` slots (every slot traced): ``{"dry": run_cell's result,
    "flops": `FlopCounterMode`'s count of the real step, "traffic": the
    `TRAFFIC` it moved, "collectives": its `COLLECTIVES` summed by
    kind}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config, input_specs
    from repro_torch.distributed import (TRAFFIC, batch_shardings,
                                         device_put, make_mesh, make_rules,
                                         reset_traffic, sanitized_shardings)
    from repro_torch.launch.dryrun import build_cell, run_cell
    from repro_torch.nn import init_params, model_decls
    from repro_torch.training import (TrainHParams, make_train_step,
                                      train_state_init, train_state_pspecs)

    cfg = get_config(arch).reduced()
    shape = ShapeSpec("t", seq, rows, "train")
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                              dtype=v.dtype) if not v.dtype.is_floating_point
             else torch.ones(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, shape).items()}
    dry = run_cell(arch, shape, out_dir=None, mesh_shape=mesh_shape, cfg=cfg,
                   all_slots=True)
    cfg = build_cell(arch, shape, mesh_shape=mesh_shape, cfg=cfg).cfg
    mesh = make_mesh(mesh_shape, ("data", "model"), devices=list(devices))
    rules = make_rules(mesh, "train")
    decls = model_decls(cfg)
    dev = torch.device(devices[0])
    params = init_params(decls, torch.Generator().manual_seed(0), dev)
    state = train_state_init(params, cfg)
    state = device_put(state, sanitized_shardings(
        mesh, train_state_pspecs(cfg, decls, rules), state))
    placed = device_put({k: v.to(dev) for k, v in batch.items()},
                        batch_shardings(mesh, rules, batch))
    step = make_train_step(cfg, TrainHParams(), mesh, rules)
    from repro_torch.distributed.placement import COLLECTIVES

    reset_traffic()
    with FlopCounterMode(display=False) as fc:
        step(state, placed)
    coll: dict = {}
    for (kind, _, _), rec in COLLECTIVES.items():
        mine = coll.setdefault(kind, dict.fromkeys(rec, 0))
        for f, v in rec.items():
            mine[f] += v
    return {"dry": dry, "flops": fc.get_total_flops(),
            "traffic": dict(TRAFFIC), "collectives": coll}
