"""Atomic directory writes: the temp-then-``os.replace`` pattern (port of
``repro/core/atomic.py``).

The serving snapshot store (``serving/snapshot.py``) and the leaf codec
(``train/checkpoint.py``) need one crash-consistency guarantee: a
directory either appears fully written or not at all, and a process killed
mid-write leaves only a ``<dir>.tmp`` that the next writer clears.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Iterator


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Yield a scratch directory; on a clean exit, ``os.replace`` it to
    ``final`` and fsync the parent directory.

    The scratch dir is ``<final>.tmp``; a stale one from a killed writer is
    removed first.  On an exception the scratch dir is removed and the
    exception propagates: ``final`` is never seen half-written, and a
    previous ``final`` stays whole.  An existing ``final`` is removed just
    before the rename (one writer; readers pick snapshots by scanning for
    complete dirs, so the short window without ``final`` falls back to the
    previous one).
    """
    final = os.fspath(final)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(final) or ".")


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry (durability of the rename)."""
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
