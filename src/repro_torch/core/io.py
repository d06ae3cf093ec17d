"""Durable-file primitives: atomic writes, fsync, format headers.

The port's copy of `repro.core.io`.  Every artifact the port writes —
`BlmacProgram.save` and `TailSnapshot.save` — goes to a sibling temp
file, is optionally fsynced, then `os.replace`d over the target, so a
killed process leaves either the previous file or the complete new one.
"""
from __future__ import annotations

import os

__all__ = ["atomic_write", "fsync_file", "fsync_dir", "check_format_header"]


def fsync_file(f) -> None:
    """Flush python buffers and force the file's bytes to stable storage."""
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path) -> None:
    """Best-effort directory fsync: makes a rename/create in ``path``
    durable against power loss (a no-op where directories cannot be
    opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, writer, fsync: bool = True) -> None:
    """Atomically (re)place ``path``: ``writer(f)`` fills a binary temp
    file next to it, which is fsynced (unless ``fsync=False``) and then
    renamed over the target.  Readers never observe a partial file."""
    path = os.fspath(path)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        writer(f)
        if fsync:
            fsync_file(f)
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def check_format_header(
    header: dict, *, kind: str, version: int, path, error_cls=ValueError,
    label: str | None = None,
) -> None:
    """Validate the ``kind`` / ``format_version`` fields every artifact
    header carries; raises ``error_cls`` on mismatch.  ``label`` is the
    human name used in messages (defaults to ``kind``)."""
    got_kind = header.get("kind")
    if got_kind != kind:
        raise error_cls(f"{path}: not a {label or kind} file")
    got_version = header.get("format_version")
    if got_version != version:
        raise error_cls(
            f"{path}: format version {got_version} != supported {version}"
        )
