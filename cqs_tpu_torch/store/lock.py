"""Index lock file: one writer per index dir.

Reference analog: ``acquire_index_lock`` (``src/cli/files.rs``) — concurrent
``index`` runs fail fast instead of corrupting each other.

Implementation: ``flock(LOCK_EX | LOCK_NB)`` on a persistent lock file. The
kernel owns liveness — a crashed holder's lock drops with its fd, so there is
no stale-pid reclaim step and therefore no check-then-unlink TOCTOU window
(two writers racing a reclaim was the exact corruption the lock exists to
prevent). The holder's pid is written into the file purely for diagnostics,
and the file is never unlinked (unlink-while-contended swaps the inode under
a waiter, which un-serializes the lock).
"""

from __future__ import annotations

import fcntl
import os
from pathlib import Path

LOCK_NAME = "index.lock"


class IndexLocked(Exception):
    pass


class IndexLock:
    def __init__(self, index_dir: str | Path):
        self.path = Path(index_dir) / LOCK_NAME
        self._held = False
        self._fd: int | None = None

    def acquire(self) -> "IndexLock":
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                holder = os.read(fd, 64).decode(errors="replace").strip() or "?"
            except OSError:
                holder = "?"
            os.close(fd)
            raise IndexLocked(
                f"index already being built by pid {holder} (lock: {self.path})")
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        os.fsync(fd)
        self._fd = fd
        self._held = True
        return self

    def release(self) -> None:
        if self._held and self._fd is not None:
            try:
                os.ftruncate(self._fd, 0)
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
            self._fd = None
            self._held = False

    def __enter__(self) -> "IndexLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
