"""`repro_torch`'s sharded filter-bank engine against `repro`'s.

The counterpart of `tests/test_sharded_bank.py` on the port: partition
balance and caller-order restoration, the planner's verdicts, the 1×1
mesh against `FilterBankEngine`, the (4, 2) time mesh, the (4, 2)
channel mesh, the (8, 1) mesh on a shuffled bank, ragged streams, the
all-zero bank, bad inputs and the double-buffered server.  The
reference runs its multi-device cases in a subprocess with forced host
devices; the port runs them in this process on meshes of ``"cpu"``
slots.  Everything is held against `repro` on the same inputs: the
partition and the `select()` subprograms (keys included), the planner's
``compiled=False`` plan field for field, the cost models, and every
output against `repro`'s numpy oracle, tolerance 0.
"""
import numpy as np
import pytest
import torch

import repro.compiler as rc
import repro.core.costmodel as rcm
import repro.distributed as rd
import repro.kernels.runtime as rrt
from differential import adversarial_bank
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro.kernels.blmac_fir import pack_bank_trits
from repro_torch.compiler import compile_bank, cse_pass
from repro_torch.compiler.cache import PROGRAM_CACHE
from repro_torch.core import costmodel as tcm
from repro_torch.distributed import (BankMesh, bank_mesh, halo_exchange_left,
                                     mesh_bank_shape, partition_bank)
from repro_torch.filters import FilterBankEngine, ShardedFilterBankEngine
from repro_torch.kernels.runtime import autotune_sharded_dispatch
from repro_torch.serving import AsyncBankServer
from test_sharded_bank import _skewed_bank
from torch_differential import plan_fields, port_five_way_check


def _qbank(n_filters: int, taps: int = 31) -> np.ndarray:
    return spread_lowpass_qbank(n_filters, taps)


def _mesh(n_bank: int = 1, n_data: int = 1) -> BankMesh:
    return bank_mesh(n_bank, n_data, devices=["cpu"] * (n_bank * n_data))


def _assert_same_partition(port, ref):
    assert len(port.assign) == len(ref.assign)
    for a, b in zip(port.assign, ref.assign):
        assert np.array_equal(a, b)
    assert np.array_equal(port.inv, ref.inv)
    assert np.array_equal(port.cost, ref.cost)


# ---------------------------------------------------------------------------
# partition specs (pure planning)
# ---------------------------------------------------------------------------


def test_partition_is_permutation_and_uneven_counts():
    q = _qbank(13)
    packed = pack_bank_trits(q)
    part = partition_bank(packed, 4, q.shape[1])
    _assert_same_partition(part, rd.partition_bank(packed, 4, q.shape[1]))
    sizes = [len(a) for a in part.assign]
    assert sum(sizes) == 13 and min(sizes) >= 1
    order = np.concatenate(part.assign)
    assert np.array_equal(np.sort(order), np.arange(13))
    assert np.array_equal(order[part.inv], np.arange(13))


def test_partition_balances_occupancy_skew():
    q = _skewed_bank(n_dense=8, n_sparse=8)
    packed = pack_bank_trits(q)
    part = partition_bank(packed, 4, q.shape[1])
    _assert_same_partition(part, rd.partition_bank(packed, 4, q.shape[1]))
    assert part.imbalance < 1.5, part.cost
    assert part.imbalance == rd.partition_bank(packed, 4, 31).imbalance
    sigs = [packed[a].any(axis=-1).sum(axis=-1) for a in part.assign]
    assert all(s.max() - s.min() <= 16 for s in sigs)


def test_partition_clamps_shards_to_bank():
    q = _qbank(3)
    part = partition_bank(pack_bank_trits(q), 8, q.shape[1])
    assert part.n_shards == 3
    assert all(len(a) == 1 for a in part.assign)
    with pytest.raises(ValueError, match="empty bank"):
        partition_bank(np.zeros((0, 16, 1), np.uint32), 2, 31)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 20])
@pytest.mark.parametrize("bank", ["spread", "skewed", "adversarial"])
def test_program_partition_and_select_equal_repro(bank, n_shards):
    """`BlmacProgram.partition` is `repro`'s, and every shard's `select()`
    subprogram carries `repro`'s key, is memoized, and is registered
    content-addressed (compiling its rows finds it)."""
    q = {"spread": lambda: _qbank(13), "adversarial": adversarial_bank,
         "skewed": lambda: _skewed_bank(n_dense=4, n_sparse=4)}[bank]()
    port, ref = compile_bank(q), rc.compile_bank(q)
    part, rpart = port.partition(n_shards), ref.partition(n_shards)
    _assert_same_partition(part, rpart)
    assert port.partition(n_shards) is part  # memoized
    assert np.array_equal(port.filter_costs, ref.filter_costs)
    for rows in part.assign:
        sub = port.select(rows)
        assert sub.key == ref.select(rows).key
        assert port.select(list(rows)) is sub
        assert np.array_equal(sub.qbank, q[rows])
        assert compile_bank(sub.qbank) is sub
        assert PROGRAM_CACHE.get(("p", bytes.fromhex(sub.key), sub.packed.shape,
                                  sub.taps, sub.spec.sample_bits)) is sub


def test_select_and_partition_refuse_on_an_optimized_program():
    opt = cse_pass(compile_bank(_qbank(16, 63)))
    with pytest.raises(NotImplementedError):
        opt.select([0])
    with pytest.raises(NotImplementedError):
        opt.partition(2)
    with pytest.raises(IndexError):
        compile_bank(_qbank(3)).select([5])


def test_program_docstring_examples_run():
    import doctest

    import repro_torch.compiler.program as program

    res = doctest.testmod(program, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0


# ---------------------------------------------------------------------------
# the mesh, the halo exchange, the cost models
# ---------------------------------------------------------------------------


def test_bank_mesh_slots_and_refusals(monkeypatch):
    mesh = _mesh(4, 2)
    assert mesh_bank_shape(mesh) == (4, 2) and mesh.size == 8
    assert mesh.shape == {"bank": 4, "data": 2}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    assert mesh_bank_shape(bank_mesh(devices=["cpu"] * 6, n_data=2)) == (3, 2)
    with pytest.raises(ValueError, match="needs 8 devices"):
        bank_mesh(4, 2, devices=["cpu"] * 7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bank_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFilterBankEngine(_qbank(4))


def test_halo_exchange_left_moves_exactly_the_halo():
    x = torch.arange(2 * 12, dtype=torch.int32).reshape(2, 12)
    slices = [x[:, 0:4], x[:, 4:8], x[:, 8:12]]
    out = halo_exchange_left(slices, 3)
    assert [tuple(o.shape) for o in out] == [(2, 7)] * 3
    assert not out[0][:, :3].any()
    for j in (1, 2):
        assert torch.equal(out[j][:, :3], slices[j - 1][:, -3:])
        assert torch.equal(out[j][:, 3:], slices[j])
    assert halo_exchange_left(slices, 0) == slices
    with pytest.raises(ValueError, match="exceeds the local slice"):
        halo_exchange_left(slices, 5)


@pytest.mark.parametrize("case", [
    ([100.0], 1, "none", None), ([100.0, 300.0, 50.0], 1, "none", [10, 10]),
    ([100.0, 90.0], 2, "time", [500.0, 600.0]),
    ([100.0, 90.0], 2, "channels", [5.0]), ([7.5], 4, "time", None)])
def test_sharded_cost_model_equals_repro(case):
    shard_us, nd, mode, host = case
    assert tcm.predict_sharded_us(shard_us, nd, mode, host_us=host) == \
        rcm.predict_sharded_us(shard_us, nd, mode, host_us=host)
    for name in ("SHARD_DISPATCH_US", "HALO_EXCHANGE_US", "RECOVERY_REPLAN_US",
                 "REPLAY_US_PER_SAMPLE", "RECOVERY_HORIZON_PUSHES"):
        assert getattr(tcm, name) == getattr(rcm, name)
    with pytest.raises(ValueError):
        tcm.predict_sharded_us([])
    for steady, n, replay in ((100.0, 2, 1000), (3360.0, 7, 0), (0.0, 0, 5)):
        assert tcm.predict_recovery_us(steady, n, replay) == \
            rcm.predict_recovery_us(steady, n, replay)


# ---------------------------------------------------------------------------
# mesh-aware planning (device-free): field for field against repro
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "wide_8x1": (lambda: _qbank(256, 63), dict(mesh_shape=(8, 1),
                                               chunk_hint=8192)),
    "narrow_8x1": (lambda: _qbank(2), dict(mesh_shape=(8, 1),
                                           chunk_hint=512)),
    "data_1x2": (lambda: _qbank(4), dict(mesh_shape=(1, 2), chunk_hint=256)),
    "channels_1x2": (lambda: _qbank(4), dict(channels=2, mesh_shape=(1, 2),
                                             chunk_hint=256)),
    "time_4x2": (lambda: _qbank(256, 63), dict(mesh_shape=(4, 2),
                                               chunk_hint=4096)),
    "forced_shards": (lambda: _qbank(16), dict(mesh_shape=(8, 1),
                                               force_shards=4)),
    "forced_time": (lambda: _qbank(13), dict(mesh_shape=(4, 2),
                                             force_shards=4,
                                             force_data="time")),
    "adversarial_2x2_c4": (adversarial_bank, dict(channels=4,
                                                  mesh_shape=(2, 2))),
    "skewed_4x1": (lambda: _skewed_bank(n_dense=4, n_sparse=4),
                   dict(mesh_shape=(4, 1), chunk_hint=1024)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_equals_repro(case):
    make, kw = PLAN_CASES[case]
    q = make()
    port, ref = compile_bank(q), rc.compile_bank(q)
    plan, part, scheds = autotune_sharded_dispatch(port, device="cpu", **kw)
    rplan, rpart, rscheds = rrt.autotune_sharded_dispatch(ref, **kw)
    assert plan_fields(plan) == plan_fields(rplan)
    _assert_same_partition(part, rpart)
    for s, r in zip(scheds, rscheds):
        assert (s is None) == (r is None)
        if s is not None:
            assert (s.tile_size, s.merge) == (r.tile_size, r.merge)
            assert np.array_equal(s.perm, r.perm)
    assert len(scheds) == plan.n_bank_shards == part.n_shards
    # LRU-cached on the program digest
    assert autotune_sharded_dispatch(port, device="cpu", **kw)[0] is plan


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_planner_on_an_optimized_program_equals_repro(mesh_shape):
    q = _qbank(64, 63)
    opt, ropt = cse_pass(compile_bank(q)), rc.cse_pass(rc.compile_bank(q))
    assert opt.key == ropt.key
    plan, part, _ = autotune_sharded_dispatch(
        opt, mesh_shape=mesh_shape, chunk_hint=4096, device="cpu")
    rplan, rpart, _ = rrt.autotune_sharded_dispatch(
        ropt, mesh_shape=mesh_shape, chunk_hint=4096)
    assert plan.cse in ("optimized", "declined")
    assert plan_fields(plan) == plan_fields(rplan)
    _assert_same_partition(part, rpart)


def test_autotuner_shards_wide_bank_and_declines_narrow():
    plan, part, schedules = autotune_sharded_dispatch(
        pack_bank_trits(_qbank(256, 63)), 63, channels=1, mesh_shape=(8, 1),
        chunk_hint=8192, device="cpu")
    assert plan.n_bank_shards > 1
    assert len(schedules) == plan.n_bank_shards == part.n_shards
    plan2, _, _ = autotune_sharded_dispatch(
        pack_bank_trits(_qbank(2)), 31, channels=1, mesh_shape=(8, 1),
        chunk_hint=512, device="cpu")
    assert plan2.n_bank_shards == 1 and not plan2.sharded


def test_autotuner_can_decline_the_data_axis():
    packed = pack_bank_trits(_qbank(4))
    plan, _, _ = autotune_sharded_dispatch(
        packed, 31, channels=1, mesh_shape=(1, 2), chunk_hint=256,
        device="cpu")
    assert plan.n_data == 1 and plan.data_mode == "none"
    with pytest.raises(ValueError, match="not available"):
        autotune_sharded_dispatch(packed, 31, channels=3, mesh_shape=(1, 2),
                                  chunk_hint=256, force_data="channels",
                                  device="cpu")


def test_forced_shard_count_is_respected():
    plan, part, _ = autotune_sharded_dispatch(
        pack_bank_trits(_qbank(16)), 31, channels=1, mesh_shape=(8, 1),
        chunk_hint=2048, force_shards=4, device="cpu")
    assert plan.n_bank_shards == 4 and part.n_shards == 4


# ---------------------------------------------------------------------------
# single-slot degradation and the five-way harness
# ---------------------------------------------------------------------------


def test_single_device_mesh_degrades_to_plain_engine():
    q = _qbank(9)
    eng = ShardedFilterBankEngine(q, mesh=_mesh())
    assert eng.n_bank_shards == 1 and eng.data_mode == "none"
    plain = FilterBankEngine(q, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, 700)
    a = eng.push(x)
    assert np.array_equal(a, plain.push(x))
    assert np.array_equal(a, fir_bit_layers_batch(x, q))
    for sz in (3, 250, 97):
        x2 = rng.integers(-128, 128, sz)
        assert np.array_equal(eng.push(x2), plain.push(x2))
    assert eng.pending == plain.pending


def test_five_way_differential_adversarial():
    rep = port_five_way_check(adversarial_bank(taps=31), n_out=24, tile=128,
                              device="cpu")
    assert rep.sharded_mesh == (1, 1) and rep.reference_legs == 7


def test_five_way_differential_skewed():
    rep = port_five_way_check(_skewed_bank(n_dense=4, n_sparse=4), n_out=32,
                              device="cpu")
    assert rep.n_filters == 8


# ---------------------------------------------------------------------------
# multi-slot meshes (in process, CPU slots)
# ---------------------------------------------------------------------------


def test_sharded_engine_8_devices():
    taps = 31
    q = _qbank(13, taps)
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, 4096)
    ref = fir_bit_layers_batch(x, q)[:, 0, :]

    # uneven B = 13 over 4 bank shards × 2 time slots (halo exchange)
    eng = ShardedFilterBankEngine(q, mesh=_mesh(4, 2), n_bank_shards=4,
                                  data_mode="time")
    assert eng.data_mode == "time" and eng.n_bank_shards == 4
    assert eng._quantum % 2 == 0 and eng._quantum // 2 >= taps - 1
    assert np.array_equal(eng.push(x)[:, 0, :], ref)

    # streamed ragged chunks through the same mesh
    eng.reset()
    outs, i = [], 0
    for sz in (17, 1000, 3, 2000, 1076):
        outs.append(eng.push(x[i:i + sz]))
        i += sz
    y = np.concatenate([o for o in outs if o.shape[2]], axis=2)[:, 0, :]
    assert np.array_equal(y, ref)

    # channel sharding: C = 4 over the data axis, no halo
    xc = rng.integers(-128, 128, (4, 2048))
    engc = ShardedFilterBankEngine(q, channels=4, mesh=_mesh(4, 2),
                                   n_bank_shards=4, data_mode="channels")
    assert engc.data_mode == "channels"
    assert np.array_equal(engc.push(xc), fir_bit_layers_batch(xc, q))

    # caller order under a shuffled bank on an (8, 1) mesh
    perm = rng.permutation(13)
    engp = ShardedFilterBankEngine(q[perm], mesh=_mesh(8, 1))
    assert np.array_equal(engp.push(x)[:, 0, :], ref[perm])


def test_five_way_differential_8_devices():
    rep = port_five_way_check(adversarial_bank(taps=31), n_out=24, tile=128,
                              device="cpu", mesh=_mesh(8, 1))
    assert rep.sharded_mesh[0] >= 1


def test_async_double_buffered_server():
    q = _qbank(6)
    server = AsyncBankServer(ShardedFilterBankEngine(q, mesh=_mesh()),
                             depth=2)
    assert server.program is server.engine.program
    x = np.random.default_rng(2).integers(-128, 128, 4 * 600)
    ref = fir_bit_layers_batch(x, q)[:, 0, :]
    got = []
    for k in range(4):
        got += server.submit(x[k * 600: (k + 1) * 600])
    assert server.inflight == 2  # the double buffer stayed full
    got += server.drain()
    assert server.inflight == 0
    y = np.concatenate([g for g in got if g.shape[2]], axis=2)[:, 0, :]
    assert np.array_equal(y, ref)
    assert server.chunks_in == server.chunks_out == 4


def test_pending_chunk_holds_device_tensors_until_resolved():
    eng = ShardedFilterBankEngine(_qbank(3), mesh=_mesh(2, 1),
                                  n_bank_shards=2)
    x = np.arange(500) % 100
    p = eng.push_async(x)
    assert all(torch.is_tensor(t) for outs in p._shard_outs for t in outs)
    a = p.result()
    assert p.result() is a  # resolved once, cached
    assert p._shard_outs is None and eng._inflight == []
    assert np.array_equal(a, fir_bit_layers_batch(x, _qbank(3)))


@pytest.mark.parametrize("mesh_shape, channels", [((2, 2), 1),
                                                   ((2, 2), 2), ((4, 1), 1)])
def test_engine_folds_an_optimized_bank_at_reassembly(mesh_shape, channels):
    """The augmented bank of a CSE program, sharded with its ``combine``:
    the shared rows fold into the real rows after reassembly, so a ragged
    stream (priming chunk included) equals `repro`'s oracle of the parent
    bank, real rows only."""
    q = _qbank(24)
    opt = cse_pass(compile_bank(q))
    assert opt.n_shared > 0
    eng = ShardedFilterBankEngine(opt.bank, channels=channels,
                                  mesh=_mesh(*mesh_shape), n_bank_shards=2,
                                  combine=opt.combine)
    assert eng.n_out_filters == len(q) < eng.n_filters
    rng = np.random.default_rng(21)
    x = rng.integers(-128, 128, (channels, 20 + 300 + 170))
    outs = [eng.push(x[:, a:b]) for a, b in ((0, 20), (20, 320), (320, 490))]
    assert outs[0].shape == (len(q), channels, 0)
    assert np.array_equal(np.concatenate(outs, axis=2),
                          fir_bit_layers_batch(x, q))
    with pytest.raises(ValueError):
        ShardedFilterBankEngine(opt.bank, mesh=_mesh(),
                                combine=opt.combine[:, 1:])


def test_all_zero_bank_sharded():
    q = np.zeros((5, 31), np.int64)
    eng = ShardedFilterBankEngine(q, mesh=_mesh(2, 2))
    y = eng.push(np.random.default_rng(3).integers(-128, 128, 400))
    assert y.shape == (5, 1, 400 - 31 + 1) and y.dtype == np.int32
    assert not y.any()


def test_rejects_bad_inputs():
    q = _qbank(4)
    with pytest.raises(ValueError):
        ShardedFilterBankEngine(q, channels=0, mesh=_mesh())
    eng = ShardedFilterBankEngine(q, channels=2, mesh=_mesh())
    with pytest.raises(ValueError):
        eng.push(np.zeros((3, 100)))  # wrong channel count
    with pytest.raises(ValueError):
        eng.apply_lanes(np.zeros((2, 10)))  # shorter than the filter
    with pytest.raises(ValueError):
        eng.time_shards(np.zeros((2, 10)))


def test_apply_lanes_and_time_shards_leave_the_stream_alone():
    q = _qbank(7)
    eng = ShardedFilterBankEngine(q, channels=2, mesh=_mesh(2, 2),
                                  n_bank_shards=2, data_mode="channels")
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (2, 300))
    eng.push(x)
    pending, n_in = eng.pending, eng.samples_in
    lanes = rng.integers(-128, 128, (2, 200))
    assert np.array_equal(eng.apply_lanes(lanes),
                          fir_bit_layers_batch(lanes, q))
    times = eng.time_shards(lanes, repeats=2)
    assert times.shape == (2,) and (times > 0).all()
    assert (eng.pending, eng.samples_in) == (pending, n_in)
    assert eng._inflight == []
    assert "mesh=(2x2)" in eng.describe()


def test_serve_fir_bank_hands_every_chunk_to_its_consumer(tmp_path):
    """The launcher's loop, in process: every resolved chunk reaches the
    consumer in stream order, and together they are the oracle's stream."""
    from repro_torch.launch.serve import parser, serve_fir_bank

    args = parser().parse_args(["--fir-bank", "8", "--taps", "31", "--chunk",
                                "256", "--chunks", "5", "--channels", "2",
                                "--device", "cpu"])
    got = []
    run = serve_fir_bank(args, consume=got.append)
    assert len(got) == 5 and run.server.chunks_out == 5
    assert run.samples == sum(g.shape[2] for g in got) == 5 * 256 - 30
    assert np.array_equal(np.concatenate(got, axis=2),
                          fir_bit_layers_batch(run.stream, _qbank(8)))
