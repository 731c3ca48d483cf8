"""Daemon client: CLI auto-forward to a live daemon.

Reference analog: ``try_daemon_query`` (``src/cli/dispatch.rs:593``) + the
pure argv->request translation (``src/daemon_translate.rs``). When the socket
answers, the CLI gets warm-daemon latency; otherwise it runs in-process.
"""

from __future__ import annotations

import socket
from pathlib import Path

from cqs_tpu_torch.daemon.protocol import read_json_line, socket_path, write_json_line


def request(index_dir: str | Path, command: str, args: dict,
            timeout: float = 30.0) -> dict | None:
    """One round trip; None when no daemon is live."""
    path = socket_path(index_dir)
    if not path.exists():
        return None
    try:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(str(path))
        write_json_line(sock, {"command": command, "args": args})
        resp = read_json_line(sock, timeout=timeout)
        sock.close()
        return resp
    except (ConnectionError, socket.timeout, OSError, ValueError):
        return None


def ping(index_dir: str | Path) -> bool:
    resp = request(index_dir, "ping", {}, timeout=2.0)
    return bool(resp and resp.get("results", {}).get("pong"))


def translate_args(command: str, args) -> dict:
    """argv namespace -> daemon request args (the daemon_translate analog —
    kept pure so the two-path equivalence is testable)."""
    mapping = {
        "search": lambda a: {"query": a.query, "limit": a.limit, "lang": a.lang,
                             "filter": a.path_filter, "alpha": a.alpha,
                             "rerank": a.rerank, "body": a.body},
        "callers": lambda a: {"name": a.name},
        "callees": lambda a: {"name": a.name},
        "impact": lambda a: {"name": a.name, "depth": a.depth},
        "trace": lambda a: {"src": a.src, "dst": a.dst},
        "test-map": lambda a: {"name": a.name},
        "dead": lambda a: {},
        "stats": lambda a: {},
        "status": lambda a: {},
        "gather": lambda a: {"query": a.query, "depth": a.depth, "limit": a.limit},
        "similar": lambda a: {"name": a.name, "limit": a.limit},
        "notes": lambda a: {"target": getattr(a, "target", None)},
        "read": lambda a: {"name": a.name},
    }
    fn = mapping.get(command)
    if fn is None:
        return {}
    return {k: v for k, v in fn(args).items() if v is not None}


FORWARDABLE = {"search", "callers", "callees", "impact", "trace", "test-map",
               "dead", "stats", "status", "gather", "similar", "notes", "read"}
