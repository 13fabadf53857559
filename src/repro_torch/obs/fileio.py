"""Crash-safe snapshot writes: temp file + atomic ``os.replace``.

The obs layer writes two kinds of files. STREAMED files (the run
ledger) append one line per record to a line-buffered handle — a crash
leaves a readable prefix, which is exactly what a forensic artifact
should do. SNAPSHOT files (metrics registry exports, Chrome traces) are
written whole at one point in time — for those, writing in place means
a crash mid-``write`` leaves a truncated JSON document that silently
poisons whatever reads it later. (A copy of ``repro/obs/fileio.py``.)

:func:`atomic_write` closes that hole: the content lands in a unique
temp file in the TARGET directory (same filesystem, so the final rename
cannot cross a device boundary) and only a completed write is
``os.replace``-d onto the destination — readers see either the old
bytes or the new bytes, never a prefix. On any failure the temp file is
removed and the destination is untouched.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import IO, Iterator


def _umask() -> int:
    """The process umask (os.umask can only read by setting)."""
    cur = os.umask(0)
    os.umask(cur)
    return cur


@contextmanager
def atomic_write(path: str, mode: str = "w") -> Iterator[IO]:
    """``with atomic_write(p) as f: f.write(...)`` — all-or-nothing.

    Creates parent directories, yields a handle onto a temp file next
    to ``path``, and renames it over ``path`` only when the body
    completes without raising. ``mode`` must be a write mode ("w" or
    "wb").
    """
    if "w" not in mode:
        raise ValueError(f"atomic_write needs a write mode, got {mode!r}")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp")
    try:
        # mkstemp creates 0600; the published file should honour the
        # umask like a plain open() would
        os.chmod(tmp, 0o666 & ~_umask())
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
