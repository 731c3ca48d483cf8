"""Tracing spans with close-time latency lines, plus opt-in telemetry.

Reference analog: ``tracing`` spans with ``FmtSpan::CLOSE`` so every hot-path
span emits a latency line (``src/main.rs:29-37``), span-per-query in the
daemon, and the opt-in redacted telemetry JSONL (``src/cli/telemetry.rs``).

Controlled by ``CQST_LOG`` (module filter, e.g. ``search=debug``) and
``--verbose``. Spans nest; each close emits ``span{...} close elapsed_ms=..``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from pathlib import Path

_LOGGER_NAME = "cqs_tpu"


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


@contextlib.contextmanager
def span(name: str, **fields):
    """Timed span; on close emits a latency line at DEBUG (INFO for slow >100ms)."""
    log = get_tracer()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        lvl = logging.INFO if ms > 100.0 else logging.DEBUG
        log.log(lvl, "span{%s %s} close elapsed_ms=%.2f", name, kv, ms)


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
