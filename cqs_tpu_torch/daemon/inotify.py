"""Linux inotify watcher via ctypes — no external dependency.

Reference analog: the notify (inotify) watcher + debounce in ``cmd_watch``
(``src/cli/watch/mod.rs:572``). The r1 build was polling-only, making
change-to-fresh latency equal to the reconcile interval; this backend turns
filesystem events into immediate reconciles, with the polling walk kept as a
periodic backstop (the reference does the same). Falls back cleanly on
non-Linux / exhausted watch limits: callers treat a failed constructor as
"no inotify, poll instead".
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import select
import struct
import time
from pathlib import Path

from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("inotify")

IN_MODIFY = 0x00000002
IN_ATTRIB = 0x00000004
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_DELETE_SELF = 0x00000400
IN_ISDIR = 0x40000000
IN_Q_OVERFLOW = 0x00004000

_MASK = (IN_CLOSE_WRITE | IN_MOVED_FROM | IN_MOVED_TO | IN_CREATE
         | IN_DELETE | IN_DELETE_SELF)

_EVENT_HDR = struct.Struct("iIII")      # wd, mask, cookie, len

_SKIP_DIRS = {".git", ".hg", ".svn", "node_modules", "__pycache__",
              ".cqs-tpu", ".venv", "venv", "target", ".idea"}


class InotifyUnavailable(RuntimeError):
    pass


class InotifyWatcher:
    """Recursive directory watcher. ``poll(timeout)`` returns the set of
    changed file paths (absolute), adding watches for newly created dirs."""

    MAX_WATCHES = 8192

    def __init__(self, root: str | Path):
        self.root = Path(root).resolve()
        name = ctypes.util.find_library("c") or "libc.so.6"
        try:
            self._libc = ctypes.CDLL(name, use_errno=True)
            self._libc.inotify_init1.restype = ctypes.c_int
            self.fd = self._libc.inotify_init1(os.O_NONBLOCK)
        except (OSError, AttributeError) as e:
            raise InotifyUnavailable(str(e))
        if self.fd < 0:
            raise InotifyUnavailable(os.strerror(ctypes.get_errno()))
        self._wd_to_dir: dict[int, Path] = {}
        self._n_overflow = 0
        try:
            self._add_tree(self.root)
        except InotifyUnavailable:
            self.close()
            raise

    def _add_watch(self, d: Path) -> None:
        if len(self._wd_to_dir) >= self.MAX_WATCHES:
            raise InotifyUnavailable(f"watch cap {self.MAX_WATCHES} reached")
        wd = self._libc.inotify_add_watch(
            self.fd, str(d).encode(), ctypes.c_uint32(_MASK))
        if wd < 0:
            err = ctypes.get_errno()
            if err in (errno.ENOSPC, errno.EMFILE):
                raise InotifyUnavailable(os.strerror(err))
            return          # unreadable dir: skip
        self._wd_to_dir[wd] = d

    def _add_tree(self, top: Path) -> None:
        self._add_watch(top)
        for dirpath, dirnames, _ in os.walk(top):
            dirnames[:] = [d for d in dirnames
                           if d not in _SKIP_DIRS and not d.startswith(".")]
            for d in dirnames:
                self._add_watch(Path(dirpath) / d)

    def poll(self, timeout_s: float, settle_s: float = 0.15) -> set[Path]:
        """Block up to ``timeout_s`` for events, then keep draining until the
        stream is quiet for ``settle_s`` (the debounce window). Returns
        changed FILE paths; directory creations add watches transparently."""
        changed: set[Path] = set()
        deadline = time.monotonic() + timeout_s
        wait = timeout_s
        while True:
            r, _, _ = select.select([self.fd], [], [], max(wait, 0.0))
            if not r:
                break
            try:
                data = os.read(self.fd, 1 << 16)
            except BlockingIOError:
                data = b""
            off = 0
            while off + _EVENT_HDR.size <= len(data):
                wd, mask, _cookie, ln = _EVENT_HDR.unpack_from(data, off)
                name = data[off + _EVENT_HDR.size: off + _EVENT_HDR.size + ln]
                off += _EVENT_HDR.size + ln
                if mask & IN_Q_OVERFLOW:
                    self._n_overflow += 1
                    continue
                base = self._wd_to_dir.get(wd)
                if base is None:
                    continue
                fname = name.split(b"\0", 1)[0].decode(errors="replace")
                path = base / fname if fname else base
                if mask & IN_ISDIR:
                    if mask & (IN_CREATE | IN_MOVED_TO) and path.name not in _SKIP_DIRS \
                            and not path.name.startswith("."):
                        try:
                            self._add_tree(path)
                        except InotifyUnavailable:
                            pass
                    continue
                if fname and not fname.startswith("."):
                    changed.add(path)
            # settle: once something arrived, drain until quiet
            wait = settle_s
            if changed and time.monotonic() > deadline + 5.0:
                break       # pathological event storm: hand back what we have
            if not changed and time.monotonic() > deadline:
                break
        return changed

    @property
    def overflowed(self) -> bool:
        """Kernel queue overflow seen — callers should run a full reconcile
        walk (events were lost)."""
        return self._n_overflow > 0

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass
