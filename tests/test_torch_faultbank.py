"""Fault tolerance of the port's sharded bank service against `repro`'s.

The counterpart of `tests/test_faultbank.py`: the taxonomy, injector and
watchdog (`repro_torch.distributed.faultbank`), tail snapshots captured,
restored and saved (files either package reads), the engine's detect →
re-partition → replay recovery, `AsyncBankServer`'s retry, deadline and
backoff contract, and the multi-slot recovery legs — in this process on
meshes of ``"cpu"`` slots, where the reference forces host devices in a
subprocess.  The reference's chaos grid runs in `repro` in such a
subprocess and its counters are held against the port's on the same
bank and kills.  Every stream is held against `repro`'s numpy oracle,
tolerance 0.
"""
import json
import os

import numpy as np
import pytest

import repro.core as rcore
import repro.distributed.faultbank as rfb
from _subproc import run_py
from differential import adversarial_bank
from repro.compiler import TailSnapshot as RefTailSnapshot
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro_torch.compiler import SnapshotFormatError, TailSnapshot, compile_bank
from repro_torch.core import predict_recovery_us
from repro_torch.distributed import bank_mesh
from repro_torch.distributed import faultbank as tfb
from repro_torch.distributed.faultbank import (DeadlineExceeded, FaultInjector,
                                               PendingInvalidated,
                                               RetriesExhausted, ShardHealth,
                                               ShardLost, StragglerStats,
                                               TransientShardError)
from repro_torch.filters import FilterBankEngine, ShardedFilterBankEngine
from repro_torch.serving import AsyncBankServer
from torch_differential import port_chaos_check

TAPS = 31


def _qbank(n_filters: int, taps: int = TAPS) -> np.ndarray:
    return spread_lowpass_qbank(n_filters, taps)


def _stream(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-128, 128, n)


def _mesh(n_bank: int = 1, n_data: int = 1):
    return bank_mesh(n_bank, n_data, devices=["cpu"] * (n_bank * n_data))


def _engine(q, **kw):
    kw.setdefault("mesh", _mesh())
    return ShardedFilterBankEngine(q, **kw)


def _joined(outs) -> np.ndarray:
    return np.concatenate([o for o in outs if o.shape[2]], axis=2)


# ---------------------------------------------------------------------------
# substrate: taxonomy, watchdog, injector (no devices involved)
# ---------------------------------------------------------------------------


def test_taxonomy_and_counters_match_repro():
    for name in rfb.__all__:
        ours = getattr(tfb, name)
        theirs = getattr(rfb, name)
        assert [c.__name__ for c in ours.__mro__] == \
            [c.__name__ for c in theirs.__mro__], name
    assert tfb.FaultStats().as_dict().keys() == rfb.FaultStats().as_dict().keys()
    assert ShardLost(3).shard == 3 and "shard 3" in str(ShardLost(3))


def test_straggler_stats_flags_only_with_history():
    st = StragglerStats(factor=2.0)
    assert not any(st.record(100.0) for _ in range(4))  # < 5 samples: never
    st = StragglerStats(factor=2.0)
    for _ in range(4):
        st.record(1.0)
    assert st.record(100.0)
    assert not st.record(1.0)
    assert st.slow_steps == 1


def test_shard_health_reset_and_summary():
    h = ShardHealth(3, timeout=0.5, straggler_factor=3.0)
    r = rfb.ShardHealth(3, timeout=0.5, straggler_factor=3.0)
    for _ in range(6):
        h.record(0, 0.01)
        r.record(0, 0.01)
    assert h.record(0, 1.0) and r.record(0, 1.0)
    assert h.summary() == r.summary()
    s = h.summary()
    assert s["n_shards"] == 3 and s["timeout_s"] == 0.5
    assert s["heartbeats"] == [7, 0, 0] and s["slow_steps"][0] == 1
    h.reset(2)
    assert h.n_shards == 2 and h.summary()["heartbeats"] == [0, 0]


def test_injector_is_deterministic_and_slot_scoped():
    inj = FaultInjector().kill_shard(1, at_chunk=2).kill_shard(1, at_chunk=5)
    inj.fail_push(0, at_chunk=1, times=2).corrupt_output(2, at_chunk=3)
    inj.on_dispatch(1, 0)
    inj.on_dispatch(1, 1)
    with pytest.raises(ShardLost):
        inj.on_dispatch(1, 2)
    with pytest.raises(ShardLost):
        inj.on_dispatch(1, 3)
    assert inj.faults_injected()["kills"] == 1
    inj.on_shard_removed(1)
    inj.on_dispatch(1, 3)
    with pytest.raises(ShardLost):
        inj.on_dispatch(1, 5)
    assert inj.faults_injected()["kills"] == 2
    for _ in range(2):
        with pytest.raises(TransientShardError):
            inj.on_dispatch(0, 1)
    inj.on_dispatch(0, 1)
    a = np.zeros((2, 1, 4), np.int32)
    assert inj.corrupt(2, 3, a).sum() == 8
    assert inj.corrupt(2, 3, a).sum() == 0
    assert inj.faults_injected() == {
        "kills": 2, "delays": 0, "transients": 2, "corruptions": 1,
    }


def test_predict_recovery_us_orders_candidates_sensibly():
    base = predict_recovery_us(100.0, 2, 1000)
    assert base == rcore.predict_recovery_us(100.0, 2, 1000)
    assert predict_recovery_us(100.0, 4, 1000) > base
    assert predict_recovery_us(100.0, 2, 50_000) > base
    assert predict_recovery_us(50.0, 2, 1000) < base


# ---------------------------------------------------------------------------
# tail snapshots: capture / restore / persist (content-addressed)
# ---------------------------------------------------------------------------


def test_tail_snapshot_resumes_both_engines_bit_exactly():
    q = _qbank(5)
    x = _stream(0, 1200)
    ref = fir_bit_layers_batch(x, q)[:, 0, :]
    for make in (lambda: FilterBankEngine(q, device="cpu"),
                 lambda: _engine(q), lambda: _engine(q, mesh=_mesh(2, 2))):
        eng = make()
        eng.push(x[:700])
        snap = eng.snapshot_tail()
        assert snap.samples_in == 700
        a = eng.push(x[700:])
        fresh = make()
        fresh.restore_tail(snap)
        b = fresh.push(x[700:])
        assert np.array_equal(a, b)
        assert np.array_equal(b[:, 0, :], ref[:, 700 - TAPS + 1:])


def test_tail_snapshot_rejects_foreign_program_and_channels():
    q = _qbank(4)
    other = compile_bank(_qbank(4, taps=15))
    for eng in (FilterBankEngine(q, device="cpu"), _engine(q)):
        eng.push(_stream(1, 400))
        snap = eng.snapshot_tail()
        with pytest.raises(ValueError, match="belongs to program"):
            FilterBankEngine(other, device="cpu").restore_tail(snap)
        with pytest.raises(ValueError, match="belongs to program"):
            _engine(other).restore_tail(snap)
        with pytest.raises(ValueError, match="channels"):
            _engine(q, channels=2).restore_tail(snap)


def test_tail_snapshot_file_roundtrip_and_format_errors(tmp_path):
    eng = _engine(_qbank(3), channels=2, mesh=_mesh(2, 1))
    eng.push(np.stack([_stream(2, 500), _stream(3, 500)]))
    snap = eng.snapshot_tail()
    path = os.path.join(tmp_path, "tail.npz")
    snap.save(path)
    for back in (TailSnapshot.load(path), RefTailSnapshot.load(path)):
        assert back.program_key == snap.program_key
        assert back.samples_in == snap.samples_in == 500
        assert back.samples_out == snap.samples_out
        assert np.array_equal(back.tail, snap.tail)
    eng2 = _engine(_qbank(3), channels=2)
    eng2.restore_tail(TailSnapshot.load(path))
    assert eng2.pending == eng.pending
    bad = os.path.join(tmp_path, "bad.npz")
    with open(bad, "wb") as f:
        f.write(b"not a zipfile")
    with pytest.raises(SnapshotFormatError):
        TailSnapshot.load(bad)
    prog = os.path.join(tmp_path, "prog.npz")
    eng.program.save(prog)
    with pytest.raises(SnapshotFormatError, match="not a tail-snapshot"):
        TailSnapshot.load(prog)


# ---------------------------------------------------------------------------
# engine semantics on a 1×1 mesh (fault paths that need no second slot)
# ---------------------------------------------------------------------------


def test_reset_invalidates_inflight_pendings():
    eng = _engine(_qbank(4))
    p = eng.push_async(_stream(4, 600))
    eng.reset()
    with pytest.raises(PendingInvalidated):
        p.result()
    x = _stream(5, 600)
    assert np.array_equal(eng.push(x)[:, 0, :],
                          fir_bit_layers_batch(x, _qbank(4))[:, 0, :])


def test_restore_tail_invalidates_inflight_pendings():
    eng = _engine(_qbank(4))
    snap = eng.snapshot_tail()
    p = eng.push_async(_stream(6, 500))
    eng.restore_tail(snap)
    with pytest.raises(PendingInvalidated):
        p.result()


def test_corruption_is_detected_and_replayed_bit_exactly():
    q = _qbank(5)
    inj = FaultInjector().corrupt_output(0, at_chunk=1, times=1)
    eng = _engine(q, fault_injector=inj, integrity_check=True)
    x = _stream(7, 1024)
    y = _joined([eng.push(x[:512]), eng.push(x[512:])])[:, 0, :]
    assert np.array_equal(y, fir_bit_layers_batch(x, q)[:, 0, :])
    st = eng.fault_stats()
    assert st["corruptions"] == 1 and st["replayed_chunks"] == 1
    assert st["detections"] == 1 and st["recoveries"] == 0


@pytest.mark.parametrize("n_bank", [2, 4])
@pytest.mark.parametrize("kill", [False, True])
def test_integrity_probe_wraps_full_range_int32_samples(n_bank, kill):
    """Samples wider than the §2.1 bound wrap the int32 outputs; the probe
    compares modulo 2**32, as the kernels compute, so a wrapped output is
    not corruption (the reference's probe raises `ShardLost` here)."""
    q = spread_lowpass_qbank(6, 7)
    x = np.random.default_rng(11).integers(-2 ** 31, 2 ** 31, 1024) \
        .astype(np.int32)
    inj = FaultInjector()
    if kill:
        inj.kill_shard(1, at_chunk=1)
    eng = _engine(q, mesh=_mesh(n_bank), n_bank_shards=n_bank,
                  fault_injector=inj, integrity_check=True)
    y = _joined([eng.push(x[k * 256:(k + 1) * 256]) for k in range(4)])
    want = fir_bit_layers_batch(x, q)
    assert np.abs(want).max() >= 2 ** 31  # the stream does wrap
    assert np.array_equal(y, want.astype(np.int32))
    st = eng.fault_stats()
    assert st["corruptions"] == 0
    assert st["detections"] == st["lost_shards"] == st["recoveries"] \
        == int(kill)


def test_persistent_corruption_escalates_to_loss():
    inj = FaultInjector().corrupt_output(0, at_chunk=0, times=10)
    eng = _engine(_qbank(4), fault_injector=inj, integrity_check=True)
    with pytest.raises(ShardLost, match="no surviving devices"):
        eng.push(_stream(8, 600))
    assert eng.fault.corruptions == eng.max_heals + 1
    assert eng.fault.replayed_chunks == eng.max_heals


def test_losing_the_only_shard_is_unrecoverable_not_a_hang():
    inj = FaultInjector().kill_shard(0, at_chunk=0)
    eng = _engine(_qbank(4), fault_injector=inj)
    p = eng.push_async(_stream(9, 500))  # dispatch does not raise
    with pytest.raises(ShardLost, match="no surviving devices"):
        p.result()
    assert eng.fault_stats()["detections"] == 1
    assert eng.fault_stats()["recoveries"] == 0


def test_watchdog_timeout_escalates_to_loss():
    inj = FaultInjector().delay_shard(0, at_chunk=0, seconds=0.6)
    eng = _engine(_qbank(4), fault_injector=inj, shard_timeout=0.05)
    with pytest.raises(ShardLost):
        eng.push(_stream(10, 500))
    st = eng.fault_stats()
    assert st["timeouts"] == 1 and st["health"]["timeout_s"] == 0.05


def test_watchdog_timeout_on_a_mesh_recovers_bit_exactly():
    """A delayed shard on a 2-row mesh times out, is dropped, and the
    chunk replays on the survivor; the abandoned read stays harmless."""
    q = _qbank(6)
    inj = FaultInjector().delay_shard(1, at_chunk=1, seconds=0.5)
    eng = _engine(q, mesh=_mesh(2, 1), n_bank_shards=2, fault_injector=inj,
                  shard_timeout=0.1)
    x = _stream(18, 1500)
    y = _joined([eng.push(x[k * 500:(k + 1) * 500]) for k in range(3)])
    assert np.array_equal(y, fir_bit_layers_batch(x, q))
    st = eng.fault_stats()
    assert st["timeouts"] == 1 and st["lost_shards"] == 1 and st["degraded"]


# ---------------------------------------------------------------------------
# AsyncBankServer failure semantics (retry / deadline / ordering)
# ---------------------------------------------------------------------------


def test_server_retries_transients_then_succeeds():
    q = _qbank(5)
    inj = FaultInjector().fail_push(0, at_chunk=1, times=2)
    server = AsyncBankServer(_engine(q, fault_injector=inj), depth=2,
                             max_retries=3, backoff_s=1e-4)
    x = _stream(11, 4 * 512)
    got = []
    for k in range(4):
        got += server.submit(x[k * 512:(k + 1) * 512])
    got += server.drain()
    assert np.array_equal(_joined(got)[:, 0, :],
                          fir_bit_layers_batch(x, q)[:, 0, :])
    assert server.retries == 2 and server.failed_chunks == 0
    st = server.fault_stats()
    assert st["engine"]["transients"] == 2
    assert st["engine"]["replayed_chunks"] >= 2


def test_server_exhausts_retries_and_the_stream_survives():
    q = _qbank(5)
    inj = FaultInjector().fail_push(0, at_chunk=0, times=10)
    server = AsyncBankServer(_engine(q, fault_injector=inj), depth=2,
                             max_retries=2, backoff_s=1e-4)
    x = _stream(12, 2 * 500)
    server.submit(x[:500])
    server.submit(x[500:])
    with pytest.raises(RetriesExhausted):
        server.drain()
    assert server.retries_exhausted == 1 and server.failed_chunks == 1
    rest = server.drain()
    assert len(rest) == 1 and server.chunks_out == 1
    ref = fir_bit_layers_batch(x, q)[:, 0, :]
    assert np.array_equal(rest[0][:, 0, :], ref[:, 500 - TAPS + 1:])


def test_server_deadline_expires_before_the_retry_budget():
    inj = FaultInjector().fail_push(0, at_chunk=0, times=10)
    server = AsyncBankServer(_engine(_qbank(4), fault_injector=inj), depth=1,
                             max_retries=50, backoff_s=0.02, deadline_s=0.01)
    server.submit(_stream(13, 500))
    with pytest.raises(DeadlineExceeded):
        server.drain()
    assert server.deadline_expired == 1 and server.retries_exhausted == 0
    assert server.inflight == 0


def test_server_delivers_resolved_outputs_when_a_later_chunk_fails():
    q = _qbank(5)
    inj = FaultInjector().fail_push(0, at_chunk=1, times=10)
    server = AsyncBankServer(_engine(q, fault_injector=inj), depth=2,
                             max_retries=1, backoff_s=1e-4)
    x = _stream(15, 2 * 500)
    server.submit(x[:500])
    server.submit(x[500:])
    with pytest.raises(RetriesExhausted):
        server.drain()
    assert server.fault_stats()["buffered"] == 1
    rest = server.drain()
    assert len(rest) == 1 and server.fault_stats()["buffered"] == 0
    ref = fir_bit_layers_batch(x, q)[:, 0, :]
    assert np.array_equal(rest[0][:, 0, :], ref[:, :500 - TAPS + 1])


def test_server_backoff_never_sleeps_past_the_deadline():
    import time

    inj = FaultInjector().fail_push(0, at_chunk=0, times=100)
    server = AsyncBankServer(_engine(_qbank(4), fault_injector=inj), depth=1,
                             max_retries=1000, backoff_s=10.0,
                             deadline_s=0.05)
    server.submit(_stream(16, 500))
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded):
        server.drain()
    assert time.monotonic() - t0 < 2.0
    assert server.deadline_expired == 1 and server.inflight == 0


def test_server_backoff_is_capped(monkeypatch):
    import time

    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    inj = FaultInjector().fail_push(0, at_chunk=0, times=100)
    eng = _engine(_qbank(4), fault_injector=inj)
    server = AsyncBankServer(eng, depth=1, max_retries=6, backoff_s=1e-3,
                             max_backoff_s=4e-3)
    server.submit(_stream(17, 400))
    with pytest.raises(RetriesExhausted):
        server.drain()
    assert sleeps[:3] == [1e-3, 2e-3, 4e-3]
    assert max(sleeps) <= 4e-3
    for bad in (dict(max_backoff_s=0.0), dict(depth=0),
                dict(max_retries=-1)):
        with pytest.raises(ValueError):
            AsyncBankServer(eng, **bad)


def test_server_fault_stats_are_json_ready():
    eng = _engine(_qbank(4), fault_injector=FaultInjector())
    server = AsyncBankServer(eng)
    server.submit(_stream(14, 400))
    server.drain()
    st = server.fault_stats()
    json.dumps(st)
    assert st["chunks_in"] == st["chunks_out"] == 1
    assert st["engine"]["n_bank_shards"] == 1
    assert st["engine"]["injected"]["kills"] == 0
    assert st["engine"]["health"]["heartbeats"] == [1]


# ---------------------------------------------------------------------------
# multi-slot recovery legs (CPU slots, in process)
# ---------------------------------------------------------------------------


def test_kill_and_recover_8_devices():
    rng = np.random.default_rng(0)
    q = _qbank(13)
    n_chunks, chunk = 6, 512
    x = rng.integers(-128, 128, n_chunks * chunk)
    inj = FaultInjector().kill_shard(1, at_chunk=2)
    eng = _engine(q, mesh=_mesh(4, 1), n_bank_shards=4, fault_injector=inj)
    server = AsyncBankServer(eng, depth=2)
    got = []
    for k in range(n_chunks):
        got += server.submit(x[k * chunk:(k + 1) * chunk])
    got += server.drain()
    assert np.array_equal(_joined(got), fir_bit_layers_batch(x, q))
    st = eng.fault_stats()
    assert st["detections"] == 1 and st["recoveries"] == 1
    assert st["lost_shards"] == 1 and st["replayed_chunks"] == 2
    assert server.failed_chunks == 0 and server.chunks_out == n_chunks
    assert eng.n_bank_shards == 3 and not st["degraded"]

    # cascade: three kills degrade 4x1 to the plain engine on the survivor
    q2 = _qbank(9)
    x2 = rng.integers(-128, 128, 8 * 400)
    inj2 = (FaultInjector().kill_shard(0, at_chunk=1)
            .kill_shard(1, at_chunk=3).kill_shard(0, at_chunk=5))
    eng2 = _engine(q2, mesh=_mesh(4, 1), n_bank_shards=4,
                   fault_injector=inj2)
    outs = [eng2.push(x2[k * 400:(k + 1) * 400]) for k in range(8)]
    assert np.array_equal(_joined(outs), fir_bit_layers_batch(x2, q2))
    st2 = eng2.fault_stats()
    assert st2["detections"] == 3 and st2["recoveries"] == 3
    assert st2["lost_shards"] == 3 and st2["degraded"]
    assert eng2.n_bank_shards == 1 and "DEGRADED" in eng2.describe()
    assert inj2.faults_injected()["kills"] == 3


def test_data_axis_meshes_recover_8_devices():
    rng = np.random.default_rng(1)
    q = _qbank(8)
    x = rng.integers(-128, 128, 6 * 600)
    inj = FaultInjector().kill_shard(1, at_chunk=2)
    eng = _engine(q, mesh=_mesh(2, 2), n_bank_shards=2, data_mode="time",
                  fault_injector=inj, integrity_check=True)
    assert eng.data_mode == "time"
    outs = [eng.push(x[k * 600:(k + 1) * 600]) for k in range(6)]
    assert np.array_equal(_joined(outs), fir_bit_layers_batch(x, q))
    assert eng.n_bank_shards == 1 and eng.n_data == 2
    assert eng.data_mode == "time"

    xc = rng.integers(-128, 128, (2, 6 * 512))
    injc = FaultInjector().kill_shard(0, at_chunk=3)
    engc = _engine(q, channels=2, mesh=_mesh(2, 2), n_bank_shards=2,
                   data_mode="channels", fault_injector=injc)
    server = AsyncBankServer(engc, depth=2)
    got = []
    for k in range(6):
        got += server.submit(xc[:, k * 512:(k + 1) * 512])
    got += server.drain()
    assert np.array_equal(_joined(got), fir_bit_layers_batch(xc, q))
    assert server.failed_chunks == 0 and server.chunks_out == 6
    assert engc.fault_stats()["recoveries"] == 1


# the counters a chaos run decides, without its wall-clock fields
_TIMED = ("last_recovery_s", "degraded_s", "stragglers")


def _untimed(stats: dict) -> dict:
    out = {k: v for k, v in stats.items() if k not in _TIMED}
    out["health"] = {k: v for k, v in stats["health"].items()
                     if k not in ("wall_s", "slow_steps")}
    return out


def test_chaos_differential_grid_8_devices():
    """`repro`'s `chaos_check` on 8 forced host devices and the port's
    `port_chaos_check` on an 8-slot CPU mesh, one bank and one two-kill
    cascade: the same recovered stream (each against the oracle), the
    same fault counters and the same final mesh."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kills = [(0, 1), (1, 3)]
    out = run_py(f"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {os.path.join(root, "tests")!r})
from tests.differential import adversarial_bank, chaos_check
stats = chaos_check(adversarial_bank(taps=31), {kills!r}, n_bank_shards=4)
print("STATS", json.dumps(stats))
""", devices=8)
    ref = json.loads(out.split("STATS ", 1)[1].splitlines()[0])
    mine = port_chaos_check(adversarial_bank(taps=31), kills,
                            n_bank_shards=4, mesh=_mesh(8, 1))
    assert _untimed(mine) == _untimed(ref)
    assert mine["lost_shards"] == len(kills) == mine["recoveries"]
