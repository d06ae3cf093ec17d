"""Write-ahead session journal: crash durability for the session server.

The port's copy of `repro.serving.journal`, byte for byte in what it
writes: the framing, the header and the JSON key order are the
reference's, so a journal written by either package recovers in the
other (the program key is shared: `BlmacProgram.key`).

`repro_torch.serving.BankSessionServer` keeps every tenant's stream
state (overlap-save tail, counters, queued chunks) in host memory; a
process crash would lose all of it.  `SessionJournal` is the write-ahead
log that makes the server rebuildable: every state transition is
appended as a CRC-framed record BEFORE the caller observes its effect,
so `BankSessionServer.recover(path, program)` can replay the log and
resume every session bit-exactly after a `SIGKILL`.

Format
------
A journal is a directory of segment files ``wal.NNNNNN.log``.  Each
segment is a sequence of records::

    <u32 payload_len> <u32 crc32(payload)> <payload: compact JSON>

and BEGINS with a ``journal`` header record carrying the format version
and the **program content digest** — recovering under a different
program is a loud error, never a silently wrong stream.  Numpy arrays
ride in payloads as ``{dtype, shape, b64}``.  Record types:

  * ``journal`` — segment header: format version, program key, geometry.
  * ``open`` / ``close`` / ``select`` — session registry: a session
    exists, died, or was retargeted (`swap_filters`) to new rows.
  * ``chunk``  — one pushed input chunk, with its per-session sequence
    number.  Appended at ``push`` time, before the samples can reach a
    kernel.
  * ``snap``   — a per-session `TailSnapshot`-equivalent (tail +
    counters), written only at **quiescent** points (nothing queued,
    everything computed has been delivered) at a configurable cadence;
    chunks at or below its ``seq`` become dead weight and are dropped
    from the next rotation.
  * ``pull``   — the session's cumulative delivered-sample watermark,
    appended before `pull` returns data; recovery trims regenerated
    output below the watermark so a client sees no duplicates and no
    gaps.

Durability: segment files are opened **unbuffered**, so every appended
record reaches the OS page cache in the `write` — that alone makes the
log complete under `SIGKILL` (the crash the serving story cares about).
`sync()` adds an `fsync` for power-loss durability; the server group-
commits one at the end of every `step()` and forces one on registry
changes and snapshots.

Rotation is atomic: when the live segment outgrows ``segment_bytes``
the server condenses the full live state into checkpoint records and
`rotate()` writes header + checkpoint into a NEW segment via
`repro_torch.core.io.atomic_write` (tmp + fsync + rename), then deletes the
older segments — a crash at any point leaves either the old segments
or a complete new one.

Recovery reads the NEWEST segment (older ones are superseded
checkpoints awaiting deletion).  A torn tail record — the process died
mid-append — truncates the log at the last valid record; a record that
fails its CRC is rejected the same way (nothing after a bad frame can
be trusted, because framing is sequential).  A segment whose header is
unreadable raises `JournalFormatError`.
"""
from __future__ import annotations

import base64
import json
import os
import re
import struct
import zlib

import numpy as np

from ..core.io import atomic_write, check_format_header, fsync_dir

__all__ = ["JOURNAL_FORMAT_VERSION", "JournalFormatError", "SessionJournal"]

JOURNAL_FORMAT_VERSION = 1
_KIND = "blmac_session_journal"
_SEG_RE = re.compile(r"^wal\.(\d{6})\.log$")
_FRAME = struct.Struct("<II")
#: framing sanity bound — a "length" beyond this is corruption, not data
_MAX_RECORD = 1 << 26


class JournalFormatError(ValueError):
    """The journal directory is unusable: no segments, an unreadable
    segment header, a format version this build cannot read, or a
    program-digest mismatch.  (A torn TAIL record is NOT this error —
    that is expected crash damage and is truncated away.)"""


def encode_array(a: np.ndarray) -> dict:
    """Numpy array → JSON-able payload fragment (dtype, shape, base64)."""
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(d: dict) -> np.ndarray:
    return (
        np.frombuffer(base64.b64decode(d["b64"]), dtype=d["dtype"])
        .reshape(d["shape"])
        .copy()
    )


def _frame(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _segments(path) -> list:
    """Sorted (index, filename) of every committed segment in ``path``."""
    out = []
    for name in os.listdir(path):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    return sorted(out)


def _read_records(seg_path):
    """Parse one segment → (records, valid_bytes).  Stops at the first
    bad frame (short header, implausible length, CRC mismatch, broken
    JSON): everything before it is valid, everything from it on is a
    torn tail.  ``valid_bytes`` is the offset a repair should truncate
    the file to."""
    records = []
    with open(seg_path, "rb") as f:
        data = f.read()
    off = 0
    while off + _FRAME.size <= len(data):
        length, crc = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + length
        if length > _MAX_RECORD or end > len(data):
            break
        payload = data[off + _FRAME.size: end]
        if zlib.crc32(payload) != crc:
            break
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        off = end
    return records, off


class SessionJournal:
    """One server's write-ahead log, rooted at a directory.

    Construction only prepares the root; the server calls
    `start_segment(records)` (also the rotation primitive) to commit a
    checkpoint and open the live segment for appends.  ``fsync=False``
    keeps `SIGKILL` durability (unbuffered writes) but skips the
    power-loss fsyncs — the benchmark's knob.
    """

    def __init__(
        self,
        path,
        *,
        program_key: str,
        taps: int,
        n_filters: int,
        segment_bytes: int = 4 << 20,
        fsync: bool = True,
    ):
        self.path = os.fspath(path)
        os.makedirs(self.path, exist_ok=True)
        self.program_key = str(program_key)
        self.taps = int(taps)
        self.n_filters = int(n_filters)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        segs = _segments(self.path)
        self._seg_index = segs[-1][0] if segs else -1
        self._f = None
        self._size = 0
        self._dirty = False
        # observability counters (surface through server fault_stats)
        self.appends = 0
        self.syncs = 0
        self.rotations = 0

    # -- segment lifecycle ---------------------------------------------------

    def _header(self, index: int) -> dict:
        return {
            "t": "journal",
            "kind": _KIND,
            "format_version": JOURNAL_FORMAT_VERSION,
            "segment": index,
            "program_key": self.program_key,
            "taps": self.taps,
            "n_filters": self.n_filters,
        }

    @property
    def segment_path(self) -> str:
        return os.path.join(self.path, f"wal.{self._seg_index:06d}.log")

    def start_segment(self, records=()) -> None:
        """Atomically commit a NEW segment holding the header plus the
        ``records`` checkpoint, point appends at it, and delete every
        older segment.  Called once at attach time and again on every
        rotation; a crash anywhere leaves a recoverable directory."""
        index = self._seg_index + 1
        blob = _frame(self._header(index))
        for rec in records:
            blob += _frame(rec)
        name = f"wal.{index:06d}.log"
        final = os.path.join(self.path, name)
        atomic_write(final, lambda f: f.write(blob), fsync=self.fsync)
        if self._f is not None:
            self._f.close()
        # buffering=0: every append is a syscall straight into the OS
        # page cache — SIGKILL cannot lose an acknowledged record
        self._f = open(final, "ab", buffering=0)
        old, self._seg_index = self._seg_index, index
        self._size = len(blob)
        self._dirty = False
        if old >= 0:
            self.rotations += 1
        for i, seg_name in _segments(self.path):
            if i < index:
                try:
                    os.unlink(os.path.join(self.path, seg_name))
                except OSError:
                    pass

    # -- appends -------------------------------------------------------------

    def append(self, rec: dict, sync: bool = False) -> None:
        """Frame + CRC + write one record to the live segment.  The
        unbuffered write makes it `SIGKILL`-durable on return; pass
        ``sync=True`` (registry changes, snapshots) to fsync too."""
        if self._f is None:
            raise RuntimeError(
                "journal has no live segment — call start_segment() first"
            )
        blob = _frame(rec)
        self._f.write(blob)
        self._size += len(blob)
        self._dirty = True
        self.appends += 1
        if sync:
            self.sync()

    def sync(self) -> None:
        """Group-commit fsync of everything appended since the last sync
        (no-op when clean or when the journal was opened fsync=False)."""
        if self._f is None or not self._dirty:
            return
        if self.fsync:
            os.fsync(self._f.fileno())
        self._dirty = False
        self.syncs += 1

    @property
    def needs_rotation(self) -> bool:
        return self._size > self.segment_bytes

    def close(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    def stats(self) -> dict:
        return {
            "path": self.path,
            "segment": self._seg_index,
            "segment_bytes": self._size,
            "appends": self.appends,
            "syncs": self.syncs,
            "rotations": self.rotations,
            "fsync": self.fsync,
        }

    # -- replay --------------------------------------------------------------

    @staticmethod
    def replay(path, repair: bool = True):
        """Read a journal directory → ``(header, records)``.

        Only the NEWEST segment is replayed — every segment starts with
        a complete checkpoint of the state at its birth, so older
        segments are superseded (rotation deletes them; a crash between
        rename and unlink leaves them behind harmlessly).  A torn tail
        truncates the log at the last valid record (physically, when
        ``repair`` and the file is writable).  An unusable directory or
        header raises `JournalFormatError`."""
        path = os.fspath(path)
        if not os.path.isdir(path):
            raise JournalFormatError(f"{path}: not a journal directory")
        segs = _segments(path)
        if not segs:
            raise JournalFormatError(f"{path}: no journal segments")
        index, name = segs[-1]
        seg_path = os.path.join(path, name)
        records, valid = _read_records(seg_path)
        if not records:
            raise JournalFormatError(
                f"{seg_path}: no readable header record"
            )
        header = records[0]
        check_format_header(
            header, kind=_KIND, version=JOURNAL_FORMAT_VERSION,
            path=seg_path, error_cls=JournalFormatError,
            label="session journal",
        )
        if repair and valid < os.path.getsize(seg_path):
            try:
                with open(seg_path, "r+b") as f:
                    f.truncate(valid)
                fsync_dir(path)
            except OSError:
                pass  # read-only media: logical truncation is enough
        return header, records[1:]
