"""Unix-socket daemon server.

Port of ``cqs_tpu/daemon/server.py``: an accept loop plus one thread per
client with a connection cap, over the port's ``BatchContext``. A client
sends JSON lines ``{"command": ..., "args": {...}}`` and reads one JSON line
back per request. Warm handles (open store, indexes resident on the device,
the micro-batcher) save every query the cold start of a CLI process.
:meth:`DaemonServer.stop` also joins the accept thread.
"""

from __future__ import annotations

import socket
import threading
from pathlib import Path

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.daemon.dispatch import BatchContext
from cqs_tpu_torch.daemon.protocol import read_json_line, socket_path, write_json_line
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("daemon")


class DaemonServer:
    def __init__(self, bctx: BatchContext, index_dir: Path):
        self.bctx = bctx
        self.path = socket_path(index_dir)
        self._stop = threading.Event()
        self._clients = threading.Semaphore(default_limits.daemon_max_clients)
        self._listener: socket.socket | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            # stale socket from a dead daemon: probe, then reclaim
            try:
                probe = socket.socket(socket.AF_UNIX)
                probe.settimeout(1.0)
                probe.connect(str(self.path))
                probe.close()
                raise RuntimeError(f"daemon already live on {self.path}")
            except (ConnectionRefusedError, socket.timeout, FileNotFoundError, OSError):
                self.path.unlink(missing_ok=True)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(str(self.path))
        self._listener.listen(256)
        self._listener.settimeout(1.0)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="cqst-daemon-accept")
        self._thread.start()
        log.info("daemon listening on %s", self.path)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            if not self._clients.acquire(blocking=False):
                try:
                    write_json_line(conn, {"error": "too many clients", "code": 429})
                    conn.close()
                except OSError:
                    pass
                continue
            t = threading.Thread(target=self._serve_client, args=(conn,), daemon=True)
            t.start()

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = read_json_line(conn)
                except ValueError as e:
                    write_json_line(conn, {"error": str(e), "code": 413})
                    return
                except (socket.timeout, ConnectionError):
                    return
                except Exception:
                    # malformed JSON from a hostile client: drop the conn
                    return
                if req is None:
                    return
                command = req.get("command", "")
                args = req.get("args", {}) or {}
                resp = self.bctx.dispatch(command, args)
                write_json_line(conn, resp)
        except (BrokenPipeError, ConnectionError, OSError):
            pass
        finally:
            self._clients.release()
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=3.0)
        self.path.unlink(missing_ok=True)
