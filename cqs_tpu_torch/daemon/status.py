"""Watch freshness snapshots + the --wait gate.

Reference analog: ``src/watch_status.rs`` — the daemon publishes freshness
snapshots (last reconcile, in-flight state, per-slot freshness) to a JSON
file that ``cqs status --watch`` renders and ``--watch-fresh --wait`` blocks
on.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

STATUS_NAME = "watch_status.json"


def status_path(index_dir: str | Path) -> Path:
    return Path(index_dir) / STATUS_NAME


def publish(index_dir: str | Path, **fields) -> None:
    p = status_path(index_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    snapshot = {"ts": time.time(), "pid": os.getpid(), **fields}
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(snapshot))
    tmp.rename(p)


def read(index_dir: str | Path) -> dict | None:
    p = status_path(index_dir)
    if not p.is_file():
        return None
    try:
        return json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return None


def wait_fresh(index_dir: str | Path, timeout: float = 60.0,
               poll: float = 0.25) -> bool:
    """Block until the watch daemon reports a clean reconcile newer than now
    minus its interval — the ``--watch-fresh --wait`` gate. Returns False on
    timeout or when no daemon is publishing."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = read(index_dir)
        if snap and snap.get("fresh") and snap.get("ts", 0) > time.time() - 300:
            return True
        time.sleep(poll)
    return False
