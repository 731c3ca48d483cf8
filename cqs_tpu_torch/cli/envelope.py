"""Versioned JSON output envelope.

Reference analog: ``src/cli/json_envelope.rs`` — v1 envelope with ``_meta``
(staleness, worktree flags) on every JSON response.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

ENVELOPE_VERSION = 1


def envelope(command: str, results: Any, meta: dict | None = None, **extra) -> dict:
    out = {
        "v": ENVELOPE_VERSION,
        "command": command,
        "results": results,
        "_meta": {"generated_at": time.time(), **(meta or {})},
    }
    out.update(extra)
    return out


def emit(data: dict, json_mode: bool, render=None) -> None:
    if json_mode or render is None:
        json.dump(data, sys.stdout, indent=None, separators=(",", ":"))
        sys.stdout.write("\n")
    else:
        render(data)


def staleness_meta(store, root) -> dict:
    """Post-query staleness probe: compare a sample of registered fingerprints
    against disk mtimes (ref: src/cli/staleness.rs warnings)."""
    import os

    stale = 0
    checked = 0
    for origin, fp in list(store.registered_origins().items())[:50]:
        checked += 1
        try:
            st = os.stat(root / origin)
            if not fp.matches_stat(st):
                stale += 1
        except OSError:
            stale += 1
    return {"stale_sampled": stale, "sampled": checked}
