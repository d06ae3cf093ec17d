"""Streaming tail state as a first-class compiler artifact.

The port's copy of `repro.compiler.state`, with the same file format:
a snapshot saved by either package restores in the other.  Overlap-save
streaming keeps one piece of mutable state per engine — the last
``taps − 1`` input samples of every channel plus the stream counters.
`TailSnapshot` freezes it and keys it to the program's content digest
(`BlmacProgram.key`), so restoring it into an engine built from another
bank is a loud `ValueError`, never a silently wrong stream.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..core.io import atomic_write, check_format_header

__all__ = ["STATE_FORMAT_VERSION", "SnapshotFormatError", "TailSnapshot"]

STATE_FORMAT_VERSION = 1


class SnapshotFormatError(ValueError):
    """A saved tail-snapshot file has the wrong kind/version or is
    corrupted — recapture the snapshot (or start a fresh stream)."""


@dataclasses.dataclass(frozen=True)
class TailSnapshot:
    """Frozen overlap-save stream state, content-addressed to a program.

    ``program_key`` is the hex digest of the `BlmacProgram` the stream
    was running; ``tail`` is the (channels, ≤ taps−1) int32 history;
    ``samples_in`` / ``samples_out`` are the stream counters at capture
    time.  Engines validate the key and channel count on restore.

    ``session`` is an optional caller-chosen stream identity carried in
    the file; engines ignore it, and files written before the field
    existed load with ``session=""``.
    """

    program_key: str
    channels: int
    samples_in: int
    samples_out: int
    tail: np.ndarray
    session: str = ""

    def save(self, path) -> None:
        """Atomic npz write (`atomic_write`), mirroring `BlmacProgram.save`
        — a killed process never leaves a truncated snapshot behind."""
        header = {
            "format_version": STATE_FORMAT_VERSION,
            "kind": "blmac_tail_snapshot",
            "program_key": self.program_key,
            "channels": int(self.channels),
            "samples_in": int(self.samples_in),
            "samples_out": int(self.samples_out),
            "session": str(self.session),
        }
        atomic_write(path, lambda f: np.savez(
            f,
            header=np.array(json.dumps(header)),
            tail=np.asarray(self.tail, np.int32),
        ))

    @classmethod
    def load(cls, path) -> "TailSnapshot":
        """Read a snapshot written by `save`; every way the file can be
        bad raises `SnapshotFormatError`."""
        try:
            with np.load(path, allow_pickle=False) as z:
                header = json.loads(str(z["header"][()]))
                check_format_header(
                    header, kind="blmac_tail_snapshot",
                    version=STATE_FORMAT_VERSION, path=path,
                    error_cls=SnapshotFormatError, label="tail-snapshot",
                )
                tail = np.ascontiguousarray(z["tail"], np.int32)
        except SnapshotFormatError:
            raise
        except Exception as e:  # truncated zip, missing array, bad JSON …
            raise SnapshotFormatError(f"{path}: unreadable snapshot: {e}")
        if tail.ndim != 2 or tail.shape[0] != int(header["channels"]):
            raise SnapshotFormatError(
                f"{path}: tail shape {tail.shape} does not match header "
                f"channels={header['channels']}"
            )
        return cls(
            program_key=str(header["program_key"]),
            channels=int(header["channels"]),
            samples_in=int(header["samples_in"]),
            samples_out=int(header["samples_out"]),
            tail=tail,
            session=str(header.get("session", "")),
        )
