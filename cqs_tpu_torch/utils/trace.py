"""Tracing spans with close-time latency lines, an in-memory recorder, plus
opt-in telemetry.

Reference analog: ``tracing`` spans with ``FmtSpan::CLOSE`` so every hot-path
span emits a latency line (``src/main.rs:29-37``), span-per-query in the
daemon, and the opt-in redacted telemetry JSONL (``src/cli/telemetry.rs``).

Log lines are controlled by ``CQST_LOG`` (module filter, e.g.
``search=debug``) and ``--verbose``. Spans nest; each close emits
``span{...} close elapsed_ms=..`` when the logger is on at that level.

While :func:`recording` is on, every span and counter of the process is also
kept in memory by one :class:`Recorder`: each span with its id, its parent's
(the span open below it on the same thread), the id of its root (shared by
every span of one request: a pull, a train step, a daemon command), its
thread, fields and ``time.time_ns()`` bounds, the clock ``torch.profiler``'s
device trace is put on; and by name, the count, total and self seconds
(the duration less the part its child spans cover). Nothing synchronises a
device inside a span: a span around enqueued device work ends when the host
has enqueued it, and the device wait shows where the program already blocks
(a copy to the host, a loss read).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

_LOGGER_NAME = "cqs_tpu"
_LOG = logging.getLogger(_LOGGER_NAME)


def get_tracer(module: str = "") -> logging.Logger:
    name = _LOGGER_NAME + ("." + module if module else "")
    return logging.getLogger(name)


def configure(verbose: int = 0) -> None:
    level = logging.WARNING
    if verbose == 1:
        level = logging.INFO
    elif verbose >= 2:
        level = logging.DEBUG
    env = os.environ.get("CQST_LOG")
    if env:
        mapping = {"trace": logging.DEBUG, "debug": logging.DEBUG, "info": logging.INFO,
                   "warn": logging.WARNING, "error": logging.ERROR}
        level = min(level, mapping.get(env.split("=")[-1].lower(), level))
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(name)s %(message)s"))
        root.addHandler(h)
    root.setLevel(level)


# --------------------------------------------------------------------------
# Spans, counters and the in-memory recorder
# --------------------------------------------------------------------------

class SpanRecord:
    """One recorded span. ``parent`` is None for a root; ``root`` is the
    root's ``id`` (its own for a root)."""

    __slots__ = ("id", "parent", "root", "name", "thread", "fields", "start_ns", "end_ns",
                 "child_ns")

    def __init__(self, id_: int, parent: int | None, root: int, name: str, fields: dict):
        self.id, self.parent, self.root, self.name = id_, parent, root, name
        self.thread = threading.get_ident()
        self.fields = fields
        self.start_ns = self.end_ns = 0
        #: the time this span's closed children took (they run one after
        #: another on its thread, so their sum is the part they cover)
        self.child_ns = 0


class Recorder:
    """Spans and counters recorded while :func:`recording` is on: per-name
    ``totals`` (name -> [count, total seconds, self seconds]), ``counters``
    (name -> sum), and the first :data:`MAX_SPANS` spans themselves
    (``spans``, in order of closing; ``dropped`` counts the rest)."""

    def __init__(self):
        self.totals: dict[str, list] = {}
        self.counters: dict[str, int] = defaultdict(int)
        self.spans: list[SpanRecord] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def _close(self, s: SpanRecord) -> None:
        dur = s.end_ns - s.start_ns
        with self._lock:
            t = self.totals.get(s.name)
            if t is None:
                t = self.totals[s.name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += dur / 1e9
            t[2] += (dur - s.child_ns) / 1e9
            if len(self.spans) < MAX_SPANS:
                self.spans.append(s)
            else:
                self.dropped += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def seconds_within(self, name: str, ancestor: str) -> float:
        """Total seconds of the recorded spans called ``name`` that have an
        ancestor called ``ancestor``."""
        by_id = {s.id: s for s in self.spans}
        total = 0
        for s in self.spans:
            if s.name != name:
                continue
            p = by_id.get(s.parent)
            while p is not None and p.name != ancestor:
                p = by_id.get(p.parent)
            if p is not None:
                total += s.end_ns - s.start_ns
        return total / 1e9

    def summary(self) -> dict:
        """Per-name aggregates and counters as plain data: ``{"spans": {name:
        {"count", "total_s", "self_s"}}, "counters": {name: n}, "dropped"}``."""
        with self._lock:
            return {"spans": {k: {"count": c, "total_s": tot, "self_s": own}
                              for k, (c, tot, own) in self.totals.items()},
                    "counters": dict(self.counters), "dropped": self.dropped}

    def marks(self) -> list[tuple[int, int, str]]:
        """The recorded spans as ``(start_ns, end_ns, name)`` on
        ``time.time_ns()``'s clock."""
        return [(s.start_ns, s.end_ns, s.name) for s in self.spans]


#: spans a recorder keeps whole (a minute of index pulls or training steps
#: records a few thousand)
MAX_SPANS = 1 << 18
#: the recorder while :func:`recording` is on, else None
_RECORDER: Recorder | None = None
#: per thread, the recorded spans open on it (innermost last)
_OPEN = threading.local()
#: span ids, unique in the process
_IDS = itertools.count(1)


def recorder() -> Recorder | None:
    """The recorder that is on, or None: callers whose counts cost work
    compute them only when it is on."""
    return _RECORDER


@contextlib.contextmanager
def recording():
    """Record every span and counter of the process in a new
    :class:`Recorder` until the block ends; one recorder at a time."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a recorder is already on")
    rec = Recorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a recorder is on."""
    rec = _RECORDER
    if rec is not None:
        rec.count(name, n)


class _Span:
    __slots__ = ("name", "fields", "rec", "record", "up", "t0")

    def __init__(self, name: str, fields: dict):
        self.name, self.fields = name, fields

    def __enter__(self):
        rec = self.rec = _RECORDER
        if rec is None:
            self.record = None
            self.t0 = time.perf_counter()
            return self
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        up = self.up = stack[-1] if stack else None
        i = next(_IDS)
        s = self.record = SpanRecord(i, up.id if up else None, up.root if up else i, self.name,
                                     self.fields)
        stack.append(s)
        s.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        s = self.record
        if s is None:
            ms = (time.perf_counter() - self.t0) * 1e3
        else:
            s.end_ns = time.time_ns()
            stack = _OPEN.stack
            if stack[-1] is s:
                stack.pop()
            else:
                # closed out of order (a generator suspended inside a span)
                stack.remove(s)
            if self.up is not None:
                self.up.child_ns += s.end_ns - s.start_ns
            self.rec._close(s)
            ms = (s.end_ns - s.start_ns) / 1e6
        lvl = logging.INFO if ms > 100.0 else logging.DEBUG
        if _LOG.isEnabledFor(lvl):
            kv = " ".join(f"{k}={v}" for k, v in self.fields.items())
            _LOG.log(lvl, "span{%s %s} close elapsed_ms=%.2f", self.name, kv, ms)


def span(name: str, **fields) -> _Span:
    """Timed span; on close emits a latency line at DEBUG (INFO for slow
    >100ms), and records itself while a recorder is on."""
    return _Span(name, fields)


# --------------------------------------------------------------------------
# Telemetry (opt-in JSONL, query text redacted to a hash + length)
# --------------------------------------------------------------------------

_TELEMETRY_MAX_BYTES = 10 * 1024 * 1024


def telemetry_enabled() -> bool:
    return os.environ.get("CQST_TELEMETRY", "") in ("1", "true", "on")


def record_telemetry(index_dir: Path, command: str, query: str | None, result_count: int) -> None:
    if not telemetry_enabled():
        return
    from cqs_tpu_torch.utils.hashing import content_hash

    path = index_dir / "telemetry.jsonl"
    try:
        index_dir.mkdir(parents=True, exist_ok=True)
        if path.exists() and path.stat().st_size > _TELEMETRY_MAX_BYTES:
            path.rename(path.with_suffix(f".jsonl.{int(time.time())}.old"))
        rec = {
            "ts": time.time(),
            "command": command,
            "query_hash": content_hash(query) if query else None,
            "query_len": len(query) if query else 0,
            "result_count": result_count,
        }
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass
