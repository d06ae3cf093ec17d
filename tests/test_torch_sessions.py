"""The port's multi-tenant session server against `repro`'s.

The counterpart of `tests/test_sessions.py` for
`repro_torch.serving.BankSessionServer` on the CPU (``device="cpu"``).
The load-bearing property is the reference's: ANY schedule of pushes
across N sessions — independently paced chunk sizes, arbitrary step()
points, mid-stream filter hot-swap, pause/resume, program swap — gives
bit for bit the streams of N dedicated per-session engines.  Beyond it,
the port is held against `repro`'s server: one seeded schedule through
both, snapshots crossing packages, the cost model and the admission,
parking and rejection decisions, and the stats' keys.  Tolerance 0.
"""
import json

import numpy as np
import pytest

import repro.core.costmodel as rcost
from _subproc import run_py
from repro.compiler import TailSnapshot as RefTailSnapshot
from repro.compiler import compile_bank as ref_compile
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro.serving import AdmissionRejected as RefAdmissionRejected
from repro.serving import BankSessionServer as RefServer
from repro_torch.compiler import TailSnapshot, compile_bank
from repro_torch.core import SESSION_LANE_US, predict_session_step_us
from repro_torch.filters import FilterBankEngine
from repro_torch.serving import AdmissionRejected, BankSessionServer

TAPS = 31


def _qbank(n_filters: int, taps: int = TAPS, bits: int = 16):
    return spread_lowpass_qbank(n_filters, taps, coeff_bits=bits)


def _program(n_filters: int, taps: int = TAPS, bits: int = 16):
    return compile_bank(_qbank(n_filters, taps, bits))


def _server(prog, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("auto_step", False)
    return BankSessionServer(prog, device="cpu", **kw)


def _engine(prog):
    return FilterBankEngine(prog, channels=1, device="cpu")


def _push_both(session, ref, rows, chunk, ref_out):
    session.push(chunk)
    ref_out.append(ref.push(chunk[None, :])[np.asarray(rows), 0])


# ---------------------------------------------------------------------------
# the bit-exactness property: arbitrary interleavings vs dedicated engines
# ---------------------------------------------------------------------------


def _random_schedule(srv, seed, sels, pushes=12):
    """The reference test's random schedule on ``srv``: every iteration a
    random subset of sessions pushes a random-sized chunk (tiny priming
    chunks included) and the server steps at random points.  Returns
    every session's pulled output and input chunks."""
    rng = np.random.default_rng(seed)
    sessions = [srv.open_session(r) for r in sels]
    chunks = [[] for _ in sels]
    for _ in range(pushes):
        for i in rng.permutation(len(sessions)):
            if rng.random() < 0.7:
                chunk = rng.integers(-128, 128, int(rng.integers(1, 50)))
                chunks[i].append(chunk)
                sessions[i].push(chunk)
        if rng.random() < 0.6:
            srv.step()
    srv.step()
    return [s.pull() for s in sessions], chunks


def test_any_interleaving_matches_dedicated_engines_and_repro():
    prog = _program(16)
    sels = [[0, 3], [5], [7, 8, 9], [1, 15], [2]]
    srv = _server(prog, n_slots=3)
    got, chunks = _random_schedule(srv, 0, sels)
    for i, sel in enumerate(sels):
        eng = _engine(prog)
        want = np.concatenate([eng.push(c[None, :])[np.asarray(sel), 0]
                               for c in chunks[i]], axis=1)
        assert np.array_equal(got[i], want), f"session {i} diverged"
    # the same schedule through the reference's server: the same streams,
    # rounds and counters
    rsrv = RefServer(ref_compile(_qbank(16)), n_slots=3, interpret=True,
                     auto_step=False)
    rgot, _ = _random_schedule(rsrv, 0, sels)
    assert all(np.array_equal(a, b) for a, b in zip(got, rgot))
    st, rst = srv.serve_stats(), rsrv.serve_stats()
    for k in ("steps", "rounds", "chunks_in", "chunks_out", "samples_in",
              "samples_out", "occupancy"):
        assert st[k] == rst[k], k


def test_interleaving_with_hot_swap_and_pause_resume():
    # one session through three eras — original selection, hot-swapped
    # selection, resumed-from-snapshot — against ONE dedicated engine
    # that just keeps streaming: the tail carries across both events
    rng = np.random.default_rng(1)
    prog = _program(12)
    srv = _server(prog)
    rows = [2, 7]
    s = srv.open_session(rows)
    ref = _engine(prog)
    ref_out = []
    for _ in range(4):
        chunk = rng.integers(-128, 128, int(rng.integers(5, 60)))
        _push_both(s, ref, rows, chunk, ref_out)
    srv.step()
    era1 = s.pull()
    assert np.array_equal(era1, np.concatenate(ref_out, axis=1))
    # mid-stream selection hot-swap: tail carries, output shape changes
    rows = [0, 4, 9]
    assert s.swap_filters(rows).shape[1] == 0  # already flushed + pulled
    ref_out = []
    for _ in range(3):
        chunk = rng.integers(-128, 128, int(rng.integers(5, 60)))
        _push_both(s, ref, rows, chunk, ref_out)
    srv.step()
    # mid-stream pause → resume (through the snapshot object)
    snap = s.pause()
    era2 = s.pull()  # pull still works on the paused handle
    assert snap.session == s.session_id
    assert np.array_equal(era2, np.concatenate(ref_out, axis=1))
    s = srv.resume_session(snap, rows)
    ref_out = []
    for _ in range(3):
        chunk = rng.integers(-128, 128, int(rng.integers(5, 60)))
        _push_both(s, ref, rows, chunk, ref_out)
    srv.step()
    era3 = s.pull()
    assert np.array_equal(era3, np.concatenate(ref_out, axis=1))


def test_program_hot_swap_is_zero_downtime_and_bit_exact():
    rng = np.random.default_rng(2)
    qb_a = spread_lowpass_qbank(8, TAPS)
    qb_b = spread_lowpass_qbank(8, TAPS, coeff_bits=12)
    srv = _server(qb_a)
    rows = [1, 6]
    s = srv.open_session(rows)
    ref = _engine(srv.program)
    x1 = rng.integers(-128, 128, 90)
    s.push(x1)
    srv.step()
    want1 = ref.push(x1[None, :])[rows, 0]
    assert np.array_equal(s.pull(), want1)
    old_key = srv.program.key
    old_engine = srv.engine
    srv.swap_program(qb_b)
    assert srv.program.key != old_key and srv.program_swaps == 1
    # the new engine runs where the server was asked to run
    assert srv.engine is not old_engine and srv.engine.device.type == "cpu"
    # the dedicated reference for the new era inherits the same raw
    # input history — exactly what the server's per-session tails carry
    ref_b = _engine(srv.program)
    ref_b.restore_tail(TailSnapshot(
        program_key=srv.program.key, channels=1, samples_in=90,
        samples_out=90 - TAPS + 1, tail=ref.snapshot_tail().tail))
    x2 = rng.integers(-128, 128, 90)
    s.push(x2)
    srv.step()
    want2 = ref_b.push(x2[None, :])[rows, 0]
    assert np.array_equal(s.pull(), want2)
    # swapping identical content is a ProgramCache hit, not a recompile
    srv.swap_program(qb_b)
    assert srv.program_swaps == 2
    with pytest.raises(ValueError):
        srv.swap_program(spread_lowpass_qbank(8, TAPS + 2))  # taps differ


# ---------------------------------------------------------------------------
# session lifecycle: snapshots, admission, eviction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saver", ["port", "repro"])
def test_snapshot_session_field_round_trips_through_disk(tmp_path, saver):
    """A paused tenant's snapshot, saved by either package's server,
    resumes bit-exactly in the port's; the port's in `repro`'s too."""
    qb = _qbank(6)
    prog = compile_bank(qb)
    if saver == "port":
        srv = _server(prog)
    else:
        srv = RefServer(ref_compile(qb), n_slots=2, interpret=True,
                        auto_step=False)
    s = srv.open_session([0, 2], session_id="tenant-42")
    s.push(np.arange(100))
    srv.step()
    s.pull()
    snap = s.pause()
    path = tmp_path / "tenant-42.npz"
    snap.save(path)
    loaded = TailSnapshot.load(path)
    assert loaded.session == "tenant-42"
    assert loaded.program_key == prog.select([0, 2]).key
    # a resumed stream continues bit-exactly from the file
    port = _server(prog)
    s2 = port.resume_session(loaded, [0, 2])
    assert s2.session_id == "tenant-42"
    ref = _engine(prog)
    ref.push(np.arange(100)[None, :])
    x = np.arange(100, 160)
    s2.push(x)
    port.step()
    want = ref.push(x[None, :])[[0, 2], 0]
    assert np.array_equal(s2.pull(), want)
    # resuming under the wrong selection is a loud error
    with pytest.raises(ValueError):
        port.resume_session(loaded, [0, 3])
    if saver == "port":  # ...and the port's file resumes in repro
        rsrv = RefServer(ref_compile(qb), n_slots=2, interpret=True,
                         auto_step=False)
        rs = rsrv.resume_session(RefTailSnapshot.load(path), [0, 2])
        rs.push(x)
        rsrv.step()
        assert np.array_equal(rs.pull(), want)


def test_admission_control_rejects_over_budget():
    prog = _program(4)
    srv = _server(prog, auto_step=True, step_budget_us=1.0)
    with pytest.raises(AdmissionRejected) as ei:
        srv.open_session([0])
    assert ei.value.predicted_us > ei.value.budget_us == 1.0
    assert srv.serve_stats()["admission_rejections"] == 1
    # the budget uses the cost model's round structure
    base = srv.predicted_step_us(extra_sessions=1)
    assert base == predict_session_step_us(srv._dispatch_us(), 1, 2)


def _admission_trace(srv, rejected_cls):
    """A fixed sequence of opens, pushes and steps under a budget that fits
    two active sessions over two lanes: after each operation its
    outcome (with a rejection's predicted µs), the parked sessions, the
    evictions, the rejections and the predicted step."""
    ops = ["open s0", "open s1", "open s2", "open s3", "push s0", "step",
           "push s1", "push s2", "push s3", "open s4", "step", "push s0",
           "open s5", "step", "push s4"]
    sessions = {}
    trace = []
    for op in ops:
        verb, _, sid = op.partition(" ")
        try:
            if verb == "open":
                sessions[sid] = srv.open_session([int(sid[1]) % 4],
                                                 session_id=sid)
            elif verb == "push":
                sessions[sid].push(np.arange(40))
            else:
                srv.step()
            what = "ok"
        except rejected_cls as e:
            what = ("rejected", e.predicted_us, e.budget_us)
        except KeyError:  # a push to a session that was never admitted
            what = "absent"
        trace.append((op, what, sorted(k for k, v in srv.sessions.items()
                                       if v.parked),
                      srv.evictions, srv.admission_rejections,
                      srv.predicted_step_us()))
    return trace


@pytest.mark.parametrize("journaled", [False, True])
def test_admission_parking_and_rejection_decide_as_repro(tmp_path,
                                                         journaled):
    """With the dispatch estimate pinned to one value in both servers, the
    port admits, parks and rejects exactly as `repro` does, with or
    without a journal's per-step bill."""
    qb = _qbank(4)
    # two active sessions fit (one round), a third spills a second round
    journal_us = 2 * 15.0 + 400.0 if journaled else 0.0
    budget = predict_session_step_us(1000.0, 2, 2, journal_us) + 1.0
    kw = dict(n_slots=2, auto_step=False, step_budget_us=budget)
    port = _server(compile_bank(qb), journal=(tmp_path / "p" if journaled
                                              else None), **kw)
    ref = RefServer(ref_compile(qb), interpret=True,
                    journal=tmp_path / "r" if journaled else None, **kw)
    for srv in (port, ref):
        srv._dispatch_us = lambda: 1000.0
    a = _admission_trace(port, AdmissionRejected)
    b = _admission_trace(ref, RefAdmissionRejected)
    assert a == b
    assert a[-1][3] >= 2 and a[-1][4] >= 1  # parked twice, rejected once


def test_eviction_parks_idle_lru_and_push_readmits():
    prog = _program(4)
    srv = _server(prog, max_sessions=2)
    a = srv.open_session([0])
    b = srv.open_session([1])
    c = srv.open_session([2])  # over the cap: parks the LRU idle (a)
    assert a.parked and not b.parked and not c.parked
    assert srv.evictions == 1
    st = srv.serve_stats()
    assert st["active"] == 2 and st["parked"] == 1
    # a parked session's stream survives parking bit-exactly: push
    # re-admits it transparently (parking someone else)
    ref = _engine(prog)
    x = np.arange(80)
    a.push(x)
    assert not a.parked and srv.evictions == 2
    srv.step()
    assert np.array_equal(a.pull(), ref.push(x[None, :])[[0], 0])
    # with every session busy, the cap is a hard rejection
    for s in srv.sessions.values():
        if not s.parked:
            s.push(np.arange(5))
    with pytest.raises(AdmissionRejected):
        srv.open_session([3])


def test_serve_stats_are_json_ready_with_repros_keys():
    qb = _qbank(6)
    srvs = [_server(compile_bank(qb), auto_step=True),
            RefServer(ref_compile(qb), n_slots=2, interpret=True)]
    stats = []
    for srv in srvs:
        s = srv.open_session([0, 1])
        s.push(np.arange(64))
        s.push(np.arange(64))
        stats.append(srv.serve_stats())
    st, rst = stats
    json.dumps(st)  # the whole surface must serialize
    assert st["sessions"] == st["active"] == 1
    assert st["chunks_in"] == 2 and st["steps"] >= 1
    assert 0.0 < st["occupancy"] <= 1.0
    assert st["per_session"]["s0"]["latency_p50_ms"] is not None
    assert st["predicted_step_us"] > 0
    assert list(st) == list(rst)
    assert list(st["per_session"]["s0"]) == list(rst["per_session"]["s0"])
    assert list(srvs[0].fault_stats()) == list(srvs[1].fault_stats())


def test_session_validation_errors():
    prog = _program(4)
    srv = _server(prog, auto_step=True)
    with pytest.raises(ValueError):
        srv.open_session([])  # empty selection
    with pytest.raises(ValueError):
        srv.open_session([4])  # out of range
    s = srv.open_session([0], session_id="dup")
    with pytest.raises(ValueError):
        srv.open_session([1], session_id="dup")
    with pytest.raises(ValueError):
        s.push(np.zeros((2, 8)))  # sessions are single-lane streams
    s.close()
    with pytest.raises(ValueError):
        s.push(np.arange(8))  # closed
    with pytest.raises(ValueError):
        BankSessionServer(prog, n_slots=0, device="cpu")


def test_apply_lanes_is_stateless_and_validated():
    prog = _program(4)
    eng = FilterBankEngine(prog, channels=2, device="cpu")
    rng = np.random.default_rng(3)
    buf = rng.integers(-128, 128, (2, 100)).astype(np.int32)
    y = eng.apply_lanes(buf)
    assert y.shape == (4, 2, 100 - TAPS + 1)
    assert np.array_equal(y, fir_bit_layers_batch(buf, prog.qbank))
    assert eng.samples_in == 0 and eng.pending == 0  # stateless
    with pytest.raises(ValueError):
        eng.apply_lanes(buf[:1])  # wrong lane count
    with pytest.raises(ValueError):
        eng.apply_lanes(buf[:, : TAPS - 1])  # shorter than one window


def test_predict_session_step_us_round_structure_equals_repros():
    # one slot-rounding boundary: 8 active over 8 slots is one round,
    # 9 active spills a second full dispatch
    one = predict_session_step_us(1000.0, 8, 8)
    two = predict_session_step_us(1000.0, 9, 8)
    assert one == 1000.0 + 8 * SESSION_LANE_US
    assert two == 2 * one
    assert predict_session_step_us(1000.0, 0, 8) == 0.0
    with pytest.raises(ValueError):
        predict_session_step_us(1000.0, 1, 0)
    for dispatch in (0.0, 12.5, 800.0, 4418.5):
        for n_active in range(0, 20):
            for n_slots in (1, 2, 3, 8, 16):
                for journal in (0.0, 415.0):
                    assert predict_session_step_us(
                        dispatch, n_active, n_slots, journal
                    ) == rcost.predict_session_step_us(
                        dispatch, n_active, n_slots, journal)


# ---------------------------------------------------------------------------
# acceptance: 64 sessions over a 256-filter bank, hot-swap + pause/resume
# ---------------------------------------------------------------------------


def test_64_sessions_over_256_filter_bank_bit_exact():
    rng = np.random.default_rng(4)
    prog = _program(256, taps=15)
    srv = _server(prog, n_slots=16, tile=128)
    n_sessions = 64
    sels = [np.arange(i * 4, i * 4 + 4) for i in range(n_sessions)]
    sessions = [srv.open_session(sel) for sel in sels]
    streams = [rng.integers(-128, 128, 96).astype(np.int32)
               for _ in range(n_sessions)]
    got = [[] for _ in range(n_sessions)]
    cuts = [np.sort(rng.integers(1, 96, 2)).tolist()
            for _ in range(n_sessions)]
    for k in range(3):  # three independently-sized chunks per session
        if k == 1:
            # one mid-stream hot-swap (same rows back: exercises the
            # flush-then-retarget path without changing the reference)
            got[7].append(sessions[7].swap_filters(sels[7]))
            # one mid-stream pause/resume
            snap = sessions[13].pause()
            got[13].append(sessions[13].pull())
            sessions[13] = srv.resume_session(snap, sels[13])
        for i, s in enumerate(sessions):
            lo = 0 if k == 0 else cuts[i][k - 1]
            hi = cuts[i][k] if k < 2 else 96
            if hi > lo:
                s.push(streams[i][lo:hi])
        srv.step()
        for i, s in enumerate(sessions):
            got[i].append(s.pull())
    # (256, 64, 96-15+1): filter b applied to stream c
    oracle = fir_bit_layers_batch(np.stack(streams), prog.qbank)
    for i in range(n_sessions):
        out = np.concatenate([g for g in got[i] if g.shape[1]], axis=1)
        want = oracle[sels[i], i, :]
        assert out.shape == want.shape
        assert np.array_equal(out, want), f"session {i} diverged"
    st = srv.serve_stats()
    assert st["occupancy"] > 0.9  # 64 ready sessions over 16 lanes
    assert st["rounds"] >= 9  # ≈ 4 rounds/step minus priming absorptions


# ---------------------------------------------------------------------------
# the reference under a forced 8-device count, against the port
# ---------------------------------------------------------------------------


def test_sessions_match_repro_under_forced_device_count():
    """`repro`'s server on 8 forced host devices and the port's in this
    process, one schedule: the same outputs."""
    script = """
import numpy as np
from repro.filters import spread_lowpass_qbank
from repro.serving import BankSessionServer

srv = BankSessionServer(spread_lowpass_qbank(8, 31), n_slots=4,
                        interpret=True, auto_step=False)
sels = [[0, 1], [5], [2, 6, 7]]
sessions = [srv.open_session(r) for r in sels]
rng = np.random.default_rng(0)
for s in sessions:
    s.push(rng.integers(-128, 128, 70))
srv.step()
print("OUT", [s.pull().tolist() for s in sessions], srv.serve_stats()["rounds"])
"""
    out = run_py(script, devices=8)
    ref = out.split("OUT ", 1)[1].splitlines()[0]
    srv = _server(_qbank(8), n_slots=4)
    sels = [[0, 1], [5], [2, 6, 7]]
    sessions = [srv.open_session(r) for r in sels]
    rng = np.random.default_rng(0)
    for s, sel in zip(sessions, sels):
        x = rng.integers(-128, 128, 70)
        s.push(x)
    srv.step()
    got = [s.pull() for s in sessions]
    assert ref == f"{[g.tolist() for g in got]} {srv.serve_stats()['rounds']}"
    rng = np.random.default_rng(0)
    for g, sel in zip(got, sels):
        x = rng.integers(-128, 128, 70)
        assert np.array_equal(g, fir_bit_layers_batch(x, _qbank(8)[sel])[:, 0])
