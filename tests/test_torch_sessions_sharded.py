"""Sessions × shards on the port: `BankSessionServer` over a
`ShardedFilterBankEngine`, against `repro`'s.

The counterpart of `tests/test_sessions_sharded.py`, on meshes of
``"cpu"`` slots in this process where the reference forces host devices
in a subprocess.  Lane dispatches route through the sharded engine's
stateless `apply_lanes`, so a shard kill, transient or corruption
mid-`step()` triggers the engine's recovery while the session layer
isolates tenants: only the sessions of the failed round replay, and
`fault_stats()` attributes the fault to exactly those.  The reference's
`session_chaos_check` runs in `repro` on 8 forced host devices and its
counters are held against `port_session_chaos_check`'s; samples wider
than the program's bound run with the integrity probe on.  Every stream
is held against the numpy oracle, tolerance 0.
"""
import json
import os
import signal

import numpy as np
import pytest

from _subproc import run_py, run_py_raw
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro_torch.compiler import compile_bank
from repro_torch.distributed import bank_mesh
from repro_torch.distributed.faultbank import (FaultInjector,
                                               TransientShardError)
from repro_torch.filters import ShardedFilterBankEngine
from repro_torch.serving import BankSessionServer
from torch_differential import port_session_chaos_check

TAPS = 31
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program(n_filters: int = 8, taps: int = TAPS):
    return compile_bank(spread_lowpass_qbank(n_filters, taps))


def _mesh(n_bank: int = 1, n_data: int = 1):
    return bank_mesh(n_bank, n_data, devices=["cpu"] * (n_bank * n_data))


def _sharded_server(prog, inj=None, n_slots=2, **engine_kw):
    engine_kw.setdefault("mesh", _mesh())
    eng = ShardedFilterBankEngine(prog, channels=n_slots, fault_injector=inj,
                                  **engine_kw)
    return BankSessionServer(prog, n_slots=n_slots, auto_step=False,
                             engine=eng), eng


def _stream_one(srv, session, x, chunk=100):
    outs = []
    for k in range(0, x.size, chunk):
        session.push(x[k:k + chunk])
        srv.step()
        out = session.pull()
        if out.shape[1]:
            outs.append(out)
    return np.concatenate(outs, axis=1)


def _oracle(x, prog, rows):
    return fir_bit_layers_batch(x[None, :], prog.qbank)[np.asarray(rows), 0]


# ---------------------------------------------------------------------------
# engine injection contract
# ---------------------------------------------------------------------------


def test_engine_injection_validates_program_and_geometry():
    prog = _program()
    other = _program(taps=TAPS + 2)
    with pytest.raises(ValueError, match="program"):
        BankSessionServer(
            prog, n_slots=2, auto_step=False,
            engine=ShardedFilterBankEngine(other, channels=2, mesh=_mesh()),
        )
    with pytest.raises(ValueError, match="channel lanes"):
        BankSessionServer(
            prog, n_slots=4, auto_step=False,
            engine=ShardedFilterBankEngine(prog, channels=2, mesh=_mesh()),
        )


def test_swap_program_refused_on_injected_engine():
    prog = _program()
    srv, _ = _sharded_server(prog)
    with pytest.raises(ValueError, match="injected"):
        srv.swap_program(_program(taps=TAPS + 2))


def test_sessions_on_sharded_engine_bit_exact_no_faults():
    prog = _program()
    rng = np.random.default_rng(5)
    srv, eng = _sharded_server(prog, mesh=_mesh(2, 1), n_bank_shards=2)
    assert eng.n_bank_shards == 2
    sels = [[0, 3], [5, 1], [7]]
    sessions = [srv.open_session(r) for r in sels]
    streams = [rng.integers(-128, 128, 4 * 100).astype(np.int32)
               for _ in sels]
    outs = [[] for _ in sels]
    for k in range(4):  # 3 tenants over 2 lanes: multi-round steps
        for i, s in enumerate(sessions):
            s.push(streams[i][k * 100:(k + 1) * 100])
        srv.step()
        for i, s in enumerate(sessions):
            out = s.pull()
            if out.shape[1]:
                outs[i].append(out)
    for i, sel in enumerate(sels):
        assert np.array_equal(np.concatenate(outs[i], axis=1),
                              _oracle(streams[i], prog, sel))
    # lane dispatches went through the sharded engine, statelessly
    assert eng._chunk_idx == srv.rounds
    assert eng.samples_in == 0 and not eng._inflight
    # admission prices the sharded engine's live plan
    assert srv._dispatch_us() == eng.plan.predicted_us


# ---------------------------------------------------------------------------
# fault paths: transient retry, corruption heal, attribution, isolation
# ---------------------------------------------------------------------------


def test_transient_fault_is_retried_inside_step_and_attributed():
    prog = _program()
    inj = FaultInjector().fail_push(0, at_chunk=1, times=1)
    srv, _ = _sharded_server(prog, inj)
    s = srv.open_session([0, 3])
    x = np.random.default_rng(0).integers(-128, 128, 400).astype(np.int32)
    got = _stream_one(srv, s, x)
    assert np.array_equal(got, _oracle(x, prog, [0, 3]))
    fs = srv.fault_stats()
    assert srv.step_retries == 1 and fs["transients"] == 1
    assert fs["session_faults"] == 1 and fs["per_session"][s.session_id] == 1


def test_corruption_is_healed_in_call_and_attributed():
    prog = _program()
    inj = FaultInjector().corrupt_output(0, at_chunk=1, times=1)
    srv, _ = _sharded_server(prog, inj, integrity_check=True)
    s = srv.open_session([1, 2])
    x = np.random.default_rng(1).integers(-128, 128, 400).astype(np.int32)
    got = _stream_one(srv, s, x)
    assert np.array_equal(got, _oracle(x, prog, [1, 2]))
    fs = srv.fault_stats()
    assert fs["corruptions"] == 1 and fs["replayed_chunks"] == 1
    assert srv.step_retries == 0  # healed inside the call, not re-raised
    assert fs["per_session"][s.session_id] == 1


def test_retry_exhaustion_raises_and_leaves_queue_intact():
    prog = _program()
    # three consecutive dispatch indices armed: with max_step_retries=1
    # the second attempt exhausts the budget and step() re-raises
    inj = (FaultInjector().fail_push(0, at_chunk=1)
           .fail_push(0, at_chunk=2).fail_push(0, at_chunk=3))
    eng = ShardedFilterBankEngine(prog, channels=2, mesh=_mesh(),
                                  fault_injector=inj)
    srv = BankSessionServer(prog, n_slots=2, auto_step=False, engine=eng,
                            max_step_retries=1)
    s = srv.open_session([0])
    x = np.random.default_rng(2).integers(-128, 128, 300).astype(np.int32)
    s.push(x[:100])
    srv.step()
    delivered = [s.pull()]
    s.push(x[100:200])
    with pytest.raises(TransientShardError):
        srv.step()
    # nothing consumed, nothing lost: the chunk is still queued and a
    # later step (fault drained) serves it bit-exactly
    assert s.queued_samples == 100 and len(s.queue) == 1
    s.push(x[200:])
    srv.step()
    delivered.append(s.pull())
    assert np.array_equal(np.concatenate(delivered, axis=1),
                          _oracle(x, prog, [0]))
    assert srv.step_retries == 3  # two in the failed step, one absorbed


def test_faults_attributed_only_to_sessions_in_failed_round():
    """Per-tenant isolation: 4 tenants over 2 lanes = 2 rounds/step; a
    transient in ONE round must mark exactly that round's tenants."""
    prog = _program()
    inj = FaultInjector().fail_push(0, at_chunk=1, times=1)
    srv, _ = _sharded_server(prog, inj)
    sessions = [srv.open_session([i]) for i in range(4)]
    rng = np.random.default_rng(3)
    for s in sessions:
        s.push(rng.integers(-128, 128, 100).astype(np.int32))
    srv.step()  # round 0 = chunk 0 (clean), round 1 = chunk 1 (faulted)
    assert [s.faults for s in sessions] == [0, 0, 1, 1]
    assert srv.session_faults == 1


# ---------------------------------------------------------------------------
# multi-slot legs: kills, degradation, the wide-sample probe
# ---------------------------------------------------------------------------


def test_sessions_survive_shard_kills_on_8_slots():
    prog = _program(64)
    rng = np.random.default_rng(7)
    n, ch = 12, 128
    sels = [np.arange((i * 5) % 60, (i * 5) % 60 + 5) for i in range(n)]
    inj = FaultInjector().kill_shard(1, at_chunk=2).kill_shard(0, at_chunk=5)
    srv, eng = _sharded_server(prog, inj, n_slots=4, mesh=_mesh(8, 1),
                               n_bank_shards=4)
    srv.step_budget_us = 1e9
    ss = [srv.open_session(sels[i]) for i in range(n)]
    streams = [rng.integers(-128, 128, ch * 8).astype(np.int32)
               for _ in range(n)]
    outs = [[] for _ in range(n)]
    for k in range(8):
        for i, s in enumerate(ss):
            s.push(streams[i][k * ch:(k + 1) * ch])
        srv.step()
        for i, s in enumerate(ss):
            o = s.pull()
            if o.shape[1]:
                outs[i].append(o)
    for i in range(n):
        assert np.array_equal(np.concatenate(outs[i], axis=1),
                              _oracle(streams[i], prog, sels[i])), i
    fs = srv.fault_stats()
    assert fs["lost_shards"] == 2 and fs["recoveries"] == 2
    assert fs["session_faults"] == 2
    # exact attribution: 12 tenants / 4 lanes = 3 rounds per step, and
    # both kills (dispatch 2 and 5) land in round 2 of their step — the
    # SAME four tenants are marked twice, everyone else stays clean
    assert sorted(fs["per_session"].values()) == [0] * 8 + [2] * 4
    # spare slots let recovery re-partition at full width
    assert eng.n_bank_shards == 4 and not srv.serve_stats()["degraded"]


def test_degraded_mesh_reprices_admission_and_sheds():
    prog = _program(9)
    rng = np.random.default_rng(8)
    # cascade: three kills degrade the 4x1 mesh to the plain 1x1 engine
    inj = (FaultInjector().kill_shard(0, at_chunk=1)
           .kill_shard(1, at_chunk=3).kill_shard(0, at_chunk=5))
    srv, eng = _sharded_server(prog, inj, mesh=_mesh(4, 1), n_bank_shards=4)
    srv.step_budget_us = 1e12
    s = srv.open_session([0, 4])
    x = rng.integers(-128, 128, 8 * 200).astype(np.int32)
    outs = []
    for k in range(8):
        s.push(x[k * 200:(k + 1) * 200])
        srv.step()
        o = s.pull()
        if o.shape[1]:
            outs.append(o)
    assert np.array_equal(np.concatenate(outs, axis=1),
                          _oracle(x, prog, [0, 4]))
    st = srv.serve_stats()
    assert st["degraded"] and srv._degraded()
    # admission prices against the LIVE (degraded) plan, finitely
    pred = srv.predicted_step_us(extra_sessions=1)
    assert np.isfinite(pred) and pred > 0
    assert srv.fault_stats()["lost_shards"] == 3
    # a budget the degraded plan no longer fits sheds idle tenants
    idle = srv.open_session([1])
    srv.step_budget_us = srv.predicted_step_us() - 1.0
    assert srv._shed_to_budget() >= 1 and idle.parked


@pytest.mark.parametrize("kills", [[], [(1, 2)]])
def test_wide_samples_with_the_probe_through_sessions(kills):
    """Full-range int32 samples wrap the outputs; with the integrity probe
    on, the sessions × shards stream stays bit-exact (modulo 2**32) and
    no wrapped output reads as corruption."""
    stats = port_session_chaos_check(
        spread_lowpass_qbank(6, 7), kills, n_bank_shards=4,
        mesh=_mesh(4, 1), integrity_check=True, sample_bits=32,
        n_chunks=4)
    assert stats["detections"] == len(kills)
    assert stats["corruptions"] == 0


# the counters a chaos run decides, without its wall-clock fields
_TIMED = ("last_recovery_s", "degraded_s", "stragglers")


def _untimed(stats: dict) -> dict:
    out = {k: v for k, v in stats.items() if k not in _TIMED}
    out["health"] = {k: v for k, v in stats["health"].items()
                     if k not in ("wall_s", "slow_steps")}
    return out


def test_differential_session_chaos_leg_matches_repro(tmp_path):
    """`repro`'s `session_chaos_check` on 8 forced host devices and the
    port's on an 8-slot CPU mesh, journaled, one bank and two kills: each
    bit-exact against its oracle, the same counters and attribution."""
    kills = [(1, 3), (0, 9)]
    out = run_py(f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from tests.differential import random_type1_bank, session_chaos_check
stats = session_chaos_check(random_type1_bank(12, taps={TAPS}, seed=5),
                            {kills!r}, n_bank_shards=4,
                            journal_path={str(tmp_path / "ref")!r})
print("STATS", json.dumps(stats))
""", devices=8)
    ref = json.loads(out.split("STATS ", 1)[1].splitlines()[0])
    from differential import random_type1_bank

    mine = port_session_chaos_check(
        random_type1_bank(12, taps=TAPS, seed=5), kills, n_bank_shards=4,
        mesh=_mesh(8, 1), journal_path=tmp_path / "port", device="cpu")
    assert _untimed(mine) == _untimed(ref)
    assert mine["detections"] == 2 and mine["n_bank_shards"] >= 1


def test_chaos_64_sessions_8_shards_kill_and_sigkill_recovery(tmp_path):
    """64 tenants over an 8-shard mesh of CPU slots survive (a) a mid-step
    shard kill and (b) a SIGKILL of the whole serving process followed
    by `recover()`: every session's joined output bit-exact against an
    uninterrupted run, with exact fault accounting."""
    wal = str(tmp_path / "wal")
    setup = f"""
import numpy as np
from repro_torch.compiler import compile_bank
from repro_torch.distributed import bank_mesh
from repro_torch.distributed.faultbank import FaultInjector
from repro_torch.filters import (ShardedFilterBankEngine,
                                 spread_lowpass_qbank)
from repro_torch.serving import BankSessionServer

TAPS, N, CH, SLOTS = {TAPS}, 64, 128, 8
qbank = spread_lowpass_qbank(64, TAPS)
prog = compile_bank(qbank)
sels = [[i % 64, (i * 7 + 3) % 64] for i in range(N)]
mesh = bank_mesh(8, 1, devices=["cpu"] * 8)

def chunks_for(n_steps):
    rng = np.random.default_rng(21)
    out = [[] for _ in range(N)]
    for _ in range(n_steps):
        for i in range(N):
            out[i].append(rng.integers(-128, 128, CH).astype(np.int32))
    return out
"""
    victim = run_py_raw(setup + f"""
import os, signal
# 64 tenants / 8 lanes = 8 rounds per step; chunk 12 lands mid-step 2
inj = FaultInjector().kill_shard(3, at_chunk=12)
eng = ShardedFilterBankEngine(prog, channels=SLOTS, mesh=mesh,
                              n_bank_shards=8, fault_injector=inj)
srv = BankSessionServer(prog, n_slots=SLOTS, auto_step=False, engine=eng,
                        step_budget_us=1e12, journal={wal!r},
                        snapshot_every=2)
ss = [srv.open_session(sels[i], session_id=f"t{{i}}") for i in range(N)]
chunks = chunks_for(4)
for k in range(3):
    for i, s in enumerate(ss):
        s.push(chunks[i][k])
    srv.step()
    for s in ss:
        s.pull()
fs = srv.fault_stats()
assert fs["lost_shards"] == 1 and fs["recoveries"] == 1, fs
assert fs["session_faults"] == 1, fs
assert sorted(fs["per_session"].values()) == [0] * 56 + [1] * 8, fs
assert eng.n_bank_shards == 7
for i, s in enumerate(ss):   # chunk 4: journaled, queued, never stepped
    s.push(chunks[i][3])
print("VICTIM_OK", flush=True)
os.kill(os.getpid(), signal.SIGKILL)
""", devices=1, timeout=600)
    assert victim.returncode == -signal.SIGKILL, (
        victim.stdout + victim.stderr)
    assert "VICTIM_OK" in victim.stdout

    taps, n, ch, slots = TAPS, 64, 128, 8
    qbank = spread_lowpass_qbank(64, taps)
    prog = compile_bank(qbank)
    sels = [[i % 64, (i * 7 + 3) % 64] for i in range(n)]
    eng = ShardedFilterBankEngine(prog, channels=slots, mesh=_mesh(8, 1),
                                  n_bank_shards=8)
    srv = BankSessionServer.recover(wal, prog, engine=eng, n_slots=slots,
                                    step_budget_us=1e12)
    assert len(srv.sessions) == n
    rng = np.random.default_rng(21)
    chunks = [[] for _ in range(n)]
    for _ in range(5):
        for i in range(n):
            chunks[i].append(rng.integers(-128, 128, ch).astype(np.int32))
    outs = [[] for _ in range(n)]
    ss = [srv.sessions[f"t{i}"] for i in range(n)]
    for i, s in enumerate(ss):
        out = s.pull()  # regenerated, journal-trimmed
        if out.shape[1]:
            outs[i].append(out)
    srv.auto_step = False
    for i, s in enumerate(ss):  # one more chunk after recovery
        s.push(chunks[i][4])
    srv.step()
    for i, s in enumerate(ss):
        out = s.pull()
        if out.shape[1]:
            outs[i].append(out)
    n_pre = 3 * ch - (taps - 1)  # delivered by the victim before the crash
    for i in range(n):
        x = np.concatenate(chunks[i])
        ref = fir_bit_layers_batch(x[None, :], qbank)[np.asarray(sels[i]), 0]
        got = np.concatenate(outs[i], axis=1)
        assert got.shape[1] == 2 * ch, (i, got.shape)  # chunks 4+5, no gaps
        assert np.array_equal(got, ref[:, n_pre:n_pre + got.shape[1]]), i
        assert ss[i].samples_in == 5 * ch
    srv.close()


def test_sessions_launcher_on_a_mesh_it_is_given(tmp_path, capsys):
    """`serve_sessions` runs ``--bank-shards K`` on a mesh passed by its
    caller (K slots of one device), journaled without fsync: every round
    dispatched through the sharded engine, every tenant bit-exact against
    the oracle for its rows, the journal replayable."""
    from repro_torch.launch.serve import parser, serve_sessions
    from repro_torch.serving import SessionJournal

    args = parser().parse_args([
        "--fir-bank", "16", "--taps", str(TAPS), "--sessions", "6",
        "--slots", "4", "--chunk", "256", "--chunks", "5",
        "--bank-shards", "2", "--journal-path", str(tmp_path / "wal"),
        "--device", "cpu"])
    run = serve_sessions(args, mesh=_mesh(2, 1), journal_fsync=False)
    eng = run.server.engine
    assert isinstance(eng, ShardedFilterBankEngine)
    assert eng.n_bank_shards == 2 and eng._chunk_idx == run.stats["rounds"]
    assert "mesh=(2x1)" in capsys.readouterr().out
    for i, (x, sel) in enumerate(zip(run.streams, run.selections)):
        assert np.array_equal(run.tenant_output(i),
                              _oracle(x, run.program, sel)), i
    assert run.stats["journal"]["fsync"] is False
    assert len(run.step_seconds) == run.stats["steps"] == args.chunks + 1
    header, _ = SessionJournal.replay(tmp_path / "wal")
    assert header["program_key"] == run.program.key
