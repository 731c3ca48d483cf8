"""Slot management: side-by-side full indexes with atomic promotion.

Reference analog: ``src/slot/mod.rs`` — layout ``.cqs-tpu/slots/<name>/``
(own index.db + dense/sparse artifacts), resolution precedence
``--slot`` > ``CQST_SLOT`` env > ``active_slot`` file > ``"default"``,
and atomic promote by rewriting the active_slot pointer.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

ACTIVE_SLOT_FILE = "active_slot"
DEFAULT_SLOT = "default"


def resolve_slot(index_dir: str | Path, explicit: str | None = None) -> str:
    if explicit:
        return explicit
    env = os.environ.get("CQST_SLOT")
    if env:
        return env
    p = Path(index_dir) / ACTIVE_SLOT_FILE
    if p.is_file():
        name = p.read_text().strip()
        if name:
            return name
    return DEFAULT_SLOT


def slot_dir(index_dir: str | Path, slot: str) -> Path:
    return Path(index_dir) / "slots" / slot


def list_slots(index_dir: str | Path) -> list[str]:
    base = Path(index_dir) / "slots"
    if not base.is_dir():
        return []
    return sorted(d.name for d in base.iterdir() if d.is_dir() and (d / "index.db").exists())


def promote_slot(index_dir: str | Path, slot: str) -> None:
    """Atomically make ``slot`` the active slot (tmp-write + rename)."""
    base = Path(index_dir)
    base.mkdir(parents=True, exist_ok=True)
    if not (slot_dir(index_dir, slot) / "index.db").exists():
        raise FileNotFoundError(f"slot {slot!r} has no index")
    tmp = base / (ACTIVE_SLOT_FILE + ".tmp")
    tmp.write_text(slot + "\n")
    tmp.rename(base / ACTIVE_SLOT_FILE)


def delete_slot(index_dir: str | Path, slot: str) -> None:
    if slot == resolve_slot(index_dir):
        raise ValueError(f"cannot delete the active slot {slot!r}")
    d = slot_dir(index_dir, slot)
    if d.is_dir():
        shutil.rmtree(d)
