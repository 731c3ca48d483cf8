"""Daemon wire protocol: JSON lines over a Unix domain socket.

Reference analog: the watch daemon socket (``src/cli/watch/socket.rs:82``) —
``.cqs/watch.sock``, one JSON request line ``{"command": ..., "args": ...}``
per connection round, same grammar as batch mode; oversized-frame guard and
slow-client limits (the adversarial-socket test surface).
"""

from __future__ import annotations

import json
import socket
from pathlib import Path

from cqs_tpu_torch.config import limits as default_limits

SOCKET_NAME = "watch.sock"


def socket_path(index_dir: str | Path) -> Path:
    return Path(index_dir) / SOCKET_NAME


def read_json_line(sock: socket.socket, max_bytes: int | None = None,
                   timeout: float | None = None) -> dict | None:
    """Read one newline-terminated JSON object with an oversized-frame guard.

    Tolerates transient EAGAIN under connection floods (retries within the
    deadline) — a loaded kernel can surface spurious wakeups even on
    blocking sockets with timeouts.
    """
    import time as _time

    max_bytes = max_bytes or default_limits.daemon_recv_max_bytes
    deadline = _time.monotonic() + (timeout or default_limits.daemon_request_timeout_s)
    buf = bytearray()
    while len(buf) < max_bytes:
        remaining = deadline - _time.monotonic()
        if remaining <= 0:
            raise socket.timeout("read_json_line deadline")
        sock.settimeout(min(remaining, 5.0))
        try:
            chunk = sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            continue
        except socket.timeout:
            continue
        if not chunk:
            break
        buf.extend(chunk)
        if b"\n" in chunk:
            break
    if not buf:
        return None
    if len(buf) >= max_bytes:
        raise ValueError(f"frame exceeds {max_bytes} bytes")
    line = bytes(buf).split(b"\n", 1)[0]
    return json.loads(line)


def write_json_line(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode() + b"\n"
    sock.sendall(data)
