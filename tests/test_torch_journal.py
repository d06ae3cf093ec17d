"""The port's write-ahead session journal against `repro`'s.

The counterpart of `tests/test_journal.py` for
`repro_torch.serving.journal` and `BankSessionServer.recover`: the
CRC-framed records, torn tails, format gating, rotation and crash
recovery, on the CPU (``device="cpu"``).  Beyond the reference's cases,
the bytes themselves: a record sequence framed by either package gives
the same segment file, the two servers journal one schedule to the same
bytes, and a journal written by either server recovers bit-exact in the
other.  Tolerance 0 throughout.
"""
import json
import os
import signal
import struct

import numpy as np
import pytest

import repro.serving.journal as rjournal
from _subproc import run_py_raw
from repro.compiler import compile_bank as ref_compile
from repro.filters import fir_bit_layers_batch, spread_lowpass_qbank
from repro.serving import BankSessionServer as RefServer
from repro_torch.compiler import SnapshotFormatError, TailSnapshot, compile_bank
from repro_torch.filters import FilterBankEngine
from repro_torch.serving import (BankSessionServer, JournalFormatError,
                                 SessionJournal)
from repro_torch.serving.journal import (_read_records, decode_array,
                                         encode_array)

TAPS = 31


def _program(n_filters: int = 16, taps: int = TAPS):
    return compile_bank(spread_lowpass_qbank(n_filters, taps))


def _journal(path, prog, cls=SessionJournal, **kw):
    return cls(path, program_key=prog.key, taps=prog.taps,
               n_filters=prog.n_filters, **kw)


def _server(prog, **kw):
    return BankSessionServer(prog, n_slots=2, device="cpu", auto_step=False,
                             **kw)


def _seg(path):
    names = sorted(n for n in os.listdir(path) if n.startswith("wal."))
    return os.path.join(str(path), names[-1])


# ---------------------------------------------------------------------------
# record framing: CRC rejection, torn tails, format gating
# ---------------------------------------------------------------------------


def test_array_payload_round_trip():
    a = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)
    b = decode_array(encode_array(a))
    assert b.dtype == a.dtype and np.array_equal(a, b)
    assert b.flags.writeable  # decode must not hand out frozen buffers
    # the payload is the reference's, key for key and byte for byte
    assert encode_array(a) == rjournal.encode_array(a)
    assert np.array_equal(rjournal.decode_array(encode_array(a)), a)


def test_append_replay_round_trip(tmp_path):
    prog = _program()
    j = _journal(tmp_path / "wal", prog)
    j.start_segment()
    j.append({"t": "open", "sid": "a", "rows": [1, 2]})
    j.append({"t": "chunk", "sid": "a", "seq": 1,
              "x": encode_array(np.arange(5, dtype=np.int32))}, sync=True)
    j.close()
    header, records = SessionJournal.replay(tmp_path / "wal")
    assert header["program_key"] == prog.key
    assert [r["t"] for r in records] == ["open", "chunk"]
    assert np.array_equal(decode_array(records[1]["x"]), np.arange(5))
    # the reference reads the port's segment to the same records
    assert rjournal.SessionJournal.replay(tmp_path / "wal") == (header,
                                                                 records)


def test_corrupt_record_crc_truncates_everything_after(tmp_path):
    prog = _program()
    j = _journal(tmp_path / "wal", prog)
    j.start_segment()
    for i in range(4):
        j.append({"t": "open", "sid": f"s{i}", "rows": [i]})
    j.close()
    seg = _seg(tmp_path / "wal")
    records, _ = _read_records(seg)
    assert len(records) == 5  # header + 4
    # flip one payload byte inside the THIRD record: it and everything
    # after it are untrustworthy (framing is sequential)
    data = bytearray(open(seg, "rb").read())
    off = 0
    for _ in range(2):  # skip header + first open
        ln, _crc = struct.unpack_from("<II", data, off)
        off += 8 + ln
    data[off + 8 + 3] ^= 0xFF
    open(seg, "wb").write(bytes(data))
    header, records = SessionJournal.replay(tmp_path / "wal", repair=False)
    assert [r["sid"] for r in records] == ["s0"]
    assert rjournal.SessionJournal.replay(tmp_path / "wal",
                                          repair=False)[1] == records


def test_torn_tail_truncated_and_physically_repaired(tmp_path):
    prog = _program()
    j = _journal(tmp_path / "wal", prog)
    j.start_segment()
    j.append({"t": "open", "sid": "a", "rows": [0]})
    j.close()
    seg = _seg(tmp_path / "wal")
    whole = os.path.getsize(seg)
    with open(seg, "ab") as f:  # a record the crash cut mid-write
        f.write(struct.pack("<II", 1000, 123) + b"only a few bytes")
    header, records = SessionJournal.replay(tmp_path / "wal")
    assert [r["t"] for r in records] == ["open"]
    # repair=True (default) physically truncates the torn bytes away
    assert os.path.getsize(seg) == whole
    # ...so a recovered server can append right where the log ends
    j2 = _journal(tmp_path / "wal", prog)
    assert j2._seg_index == 0


def test_replay_rejects_unusable_directories(tmp_path):
    with pytest.raises(JournalFormatError, match="not a journal"):
        SessionJournal.replay(tmp_path / "nope")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(JournalFormatError, match="no journal segments"):
        SessionJournal.replay(empty)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "wal.000000.log").write_bytes(b"\xff" * 32)
    with pytest.raises(JournalFormatError, match="no readable header"):
        SessionJournal.replay(bad)


def test_replay_rejects_wrong_kind_and_version(tmp_path):
    prog = _program()
    for patch, match in [({"kind": "other"}, "not a session journal"),
                         ({"format_version": 99}, "version")]:
        root = tmp_path / patch["kind"] if "kind" in patch else tmp_path / "v"
        j = _journal(root, prog)
        hdr = j._header(0)
        hdr.update(patch)
        j._header = lambda index, _h=hdr: _h
        j.start_segment()
        j.close()
        with pytest.raises(JournalFormatError, match=match):
            SessionJournal.replay(root)


def test_rotation_checkpoints_and_deletes_old_segments(tmp_path):
    prog = _program(8)
    srv = _server(prog, journal=tmp_path / "wal", snapshot_every=1,
                  segment_bytes=2000)
    s = srv.open_session([0, 1])
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, 6 * 64).astype(np.int32)
    for k in range(6):
        s.push(x[k * 64:(k + 1) * 64])
        srv.step()
        s.pull()
    assert srv.journal.rotations >= 1
    names = [n for n in os.listdir(tmp_path / "wal") if n.startswith("wal.")]
    assert len(names) == 1  # superseded segments are deleted
    srv.close()
    # the surviving segment alone rebuilds the full session
    srv2 = BankSessionServer.recover(tmp_path / "wal", prog, device="cpu")
    s2 = srv2.sessions[s.session_id]
    assert s2.samples_in == 6 * 64 and s2.delivered == s2.samples_out
    srv2.close()


# ---------------------------------------------------------------------------
# the bytes across packages
# ---------------------------------------------------------------------------


def test_segments_are_byte_identical_across_packages(tmp_path):
    """One record sequence (every record type, arrays included) framed by
    either package's journal, with a rotation: the same segment bytes."""
    prog = _program()
    tail = np.arange(-3, 27, dtype=np.int32)[None, :]
    recs = [
        {"t": "open", "sid": "s0", "rows": [0, 5]},
        {"t": "chunk", "sid": "s0", "seq": 1,
         "data": encode_array(np.arange(-40, 60, dtype=np.int32))},
        {"t": "pull", "sid": "s0", "delivered": 70},
        {"t": "snap", "sid": "s0", "seq": 1, "samples_in": 100,
         "samples_out": 70, "delivered": 70, "tail": encode_array(tail)},
        {"t": "select", "sid": "s0", "rows": [3]},
        {"t": "close", "sid": "s0"},
    ]
    blobs = []
    for name, cls in (("port", SessionJournal),
                      ("ref", rjournal.SessionJournal)):
        j = _journal(tmp_path / name, prog, cls=cls, fsync=False)
        j.start_segment(recs[:1])
        for r in recs[1:]:
            j.append(r)
        j.start_segment(recs)  # a rotation: checkpoint of every record
        j.append(recs[0], sync=True)
        j.close()
        assert j.stats()["rotations"] == 1
        blobs.append(open(_seg(tmp_path / name), "rb").read())
    assert blobs[0] == blobs[1]


def _schedule(srv, seed, sels, steps=5, leave_queued=True):
    """A seeded push/step/pull schedule, with one `swap_filters`; returns
    every session's outputs and input streams."""
    rng = np.random.default_rng(seed)
    sessions = [srv.open_session(r, session_id=f"t{i}")
                for i, r in enumerate(sels)]
    streams = [[] for _ in sels]
    outs = [[] for _ in sels]
    for k in range(steps):
        if k == 2:
            outs[1].append(sessions[1].swap_filters(sels[1]))
        for i, s in enumerate(sessions):
            chunk = rng.integers(-128, 128, int(rng.integers(8, 80))) \
                .astype(np.int32)
            streams[i].append(chunk)
            s.push(chunk)
        if k < steps - 1 or not leave_queued:
            srv.step()
            for i, s in enumerate(sessions):
                out = s.pull()
                if out.shape[1]:
                    outs[i].append(out)
    return outs, streams


SELS = [[0, 3], [5, 1], [7]]


def test_servers_journal_one_schedule_to_the_same_bytes(tmp_path):
    """The port's and `repro`'s servers on one schedule write the same
    journal, byte for byte: records, order, snapshots and rotations."""
    prog = _program()
    rprog = ref_compile(spread_lowpass_qbank(16, TAPS))
    assert rprog.key == prog.key
    port = _server(prog, journal=tmp_path / "port", journal_fsync=False,
                   snapshot_every=2, segment_bytes=6000)
    ref = RefServer(rprog, n_slots=2, interpret=True, auto_step=False,
                    journal=tmp_path / "ref", journal_fsync=False,
                    snapshot_every=2, segment_bytes=6000)
    got = [_schedule(srv, 3, SELS) for srv in (port, ref)]
    for a, b in zip(got[0][0], got[1][0]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert port.journal.stats()["rotations"] >= 1
    assert {k: v for k, v in port.journal.stats().items() if k != "path"} \
        == {k: v for k, v in ref.journal.stats().items() if k != "path"}
    assert open(_seg(tmp_path / "port"), "rb").read() \
        == open(_seg(tmp_path / "ref"), "rb").read()


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_recover_across_packages_is_bit_exact(tmp_path, writer):
    """A journal written by either package's server (chunks still queued,
    no close) recovers bit-exact in the other's `recover`."""
    qb = spread_lowpass_qbank(16, TAPS)
    prog, rprog = compile_bank(qb), ref_compile(qb)
    if writer == "repro":
        srv = RefServer(rprog, n_slots=2, interpret=True, auto_step=False,
                        journal=tmp_path / "wal", snapshot_every=2)
    else:
        srv = _server(prog, journal=tmp_path / "wal", snapshot_every=2)
    outs, streams = _schedule(srv, 4, SELS)
    del srv  # the SIGKILL model: appends are unbuffered writes
    if writer == "repro":
        srv2 = BankSessionServer.recover(tmp_path / "wal", prog,
                                         device="cpu")
    else:
        srv2 = RefServer.recover(tmp_path / "wal", rprog, interpret=True)
    srv2.auto_step = False
    rng = np.random.default_rng(40)
    for i in range(len(SELS)):
        s = srv2.sessions[f"t{i}"]
        out = s.pull()
        if out.shape[1]:
            outs[i].append(out)
        chunk = rng.integers(-128, 128, 64).astype(np.int32)
        streams[i].append(chunk)
        s.push(chunk)
    srv2.step()
    for i, sel in enumerate(SELS):
        outs[i].append(srv2.sessions[f"t{i}"].pull())
        x = np.concatenate(streams[i])
        got = np.concatenate(outs[i], axis=1)
        assert np.array_equal(got, fir_bit_layers_batch(x, qb[sel])[:, 0])
    srv2.close()


# ---------------------------------------------------------------------------
# server-level crash recovery
# ---------------------------------------------------------------------------


def test_recover_is_bit_exact_with_queued_chunks(tmp_path):
    prog = _program()
    srv = _server(prog, journal=tmp_path / "wal", snapshot_every=2)
    outs, streams = _schedule(srv, 3, SELS)
    # die here: the last chunks queued but never stepped, no close(), no
    # sync — abandoning the object IS the SIGKILL model because appends
    # are unbuffered writes
    del srv

    srv2 = BankSessionServer.recover(tmp_path / "wal", prog, device="cpu",
                                     auto_step=False)
    rng = np.random.default_rng(30)
    sessions2 = [srv2.sessions[f"t{i}"] for i in range(len(SELS))]
    for i, s in enumerate(sessions2):
        out = s.pull()
        if out.shape[1]:
            outs[i].append(out)
        chunk = rng.integers(-128, 128, 64).astype(np.int32)
        streams[i].append(chunk)
        s.push(chunk)
    srv2.step()
    for i, s in enumerate(sessions2):
        out = s.pull()
        if out.shape[1]:
            outs[i].append(out)
        x = np.concatenate(streams[i])
        ref = fir_bit_layers_batch(x[None, :], prog.qbank)[
            np.asarray(SELS[i]), 0]
        got = np.concatenate(outs[i], axis=1)
        assert np.array_equal(got, ref[:, :got.shape[1]]), f"session {i}"
        assert got.shape[1] == x.size - TAPS + 1  # nothing lost
    srv2.close()


def test_recover_rejects_program_digest_mismatch(tmp_path):
    prog = _program()
    srv = _server(prog, journal=tmp_path / "wal")
    srv.open_session([0])
    srv.close()
    other = _program(taps=TAPS + 2)
    with pytest.raises(JournalFormatError, match="belongs to program"):
        BankSessionServer.recover(tmp_path / "wal", other, device="cpu")


def test_attach_to_populated_journal_dir_is_refused(tmp_path):
    prog = _program()
    srv = _server(prog, journal=tmp_path / "wal")
    srv.close()
    with pytest.raises(ValueError, match="recover"):
        _server(prog, journal=tmp_path / "wal")


def test_sigkill_crash_then_recover_subprocess(tmp_path):
    """The real thing: a serving PROCESS is SIGKILLed mid-flight and this
    one recovers every stream bit-exactly."""
    wal = tmp_path / "wal"
    victim = run_py_raw(f"""
import os, signal
import numpy as np
from repro_torch.compiler import compile_bank
from repro_torch.filters import spread_lowpass_qbank
from repro_torch.serving import BankSessionServer

prog = compile_bank(spread_lowpass_qbank(16, {TAPS}))
srv = BankSessionServer(prog, n_slots=2, device="cpu", auto_step=False,
                        journal={str(wal)!r}, snapshot_every=2)
rng = np.random.default_rng(11)
ss = [srv.open_session([i, i + 8], session_id=f"t{{i}}") for i in range(3)]
for k in range(3):
    for s in ss:
        s.push(rng.integers(-128, 128, 96).astype(np.int32))
    srv.step()
    for s in ss:
        s.pull()
for s in ss:  # queued, never stepped
    s.push(rng.integers(-128, 128, 96).astype(np.int32))
os.kill(os.getpid(), signal.SIGKILL)
""", devices=1)
    assert victim.returncode == -signal.SIGKILL, victim.stderr
    prog = _program()
    srv = BankSessionServer.recover(wal, prog, device="cpu")
    assert sorted(srv.sessions) == ["t0", "t1", "t2"]
    # replay the victim's RNG: 4 chunks of 96 per session, round-robin
    rng = np.random.default_rng(11)
    streams = [[] for _ in range(3)]
    for _ in range(4):
        for i in range(3):
            streams[i].append(rng.integers(-128, 128, 96).astype(np.int32))
    for i in range(3):
        s = srv.sessions[f"t{i}"]
        got = s.pull()
        x = np.concatenate(streams[i])
        ref = fir_bit_layers_batch(x[None, :], prog.qbank)[[i, i + 8], 0]
        n_pre = 3 * 96 - (TAPS - 1)  # delivered before the crash
        assert got.shape[1] == 96
        assert np.array_equal(got, ref[:, n_pre:n_pre + got.shape[1]])
        assert s.samples_in == 4 * 96
    srv.close()


# ---------------------------------------------------------------------------
# tolerant snapshot load + empty-stats guard
# ---------------------------------------------------------------------------


def test_tail_snapshot_tolerates_pre_session_field_files(tmp_path):
    """Snapshots written before the session field existed (header without
    a ``session`` key) must still load, with ``session == ""``."""
    prog = _program()
    eng = FilterBankEngine(prog, channels=1, device="cpu")
    eng.push(np.arange(TAPS + 5, dtype=np.int32)[None, :])
    snap = eng.snapshot_tail()
    path = tmp_path / "old.npz"
    snap.save(path)
    with np.load(path) as z:
        header = json.loads(str(z["header"]))
        tail = z["tail"]
    del header["session"]
    np.savez(path, header=json.dumps(header), tail=tail)
    loaded = TailSnapshot.load(path)
    assert loaded.session == ""
    assert np.array_equal(loaded.tail, snap.tail)
    # ...while a wrong-kind file still fails loudly
    np.savez(path, header=json.dumps({"kind": "x"}), tail=tail)
    with pytest.raises(SnapshotFormatError, match="not a tail-snapshot"):
        TailSnapshot.load(path)


def test_serve_stats_empty_percentiles_are_none():
    srv = _server(_program())
    srv.open_session([0])  # registered but never served
    stats = srv.serve_stats()
    assert stats["latency_p50_ms"] is None
    assert stats["latency_p99_ms"] is None
    assert json.dumps(stats)  # stays JSON-clean
