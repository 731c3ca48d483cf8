"""Worktree overlay: query-time ephemeral index of dirty files.

Port of ``cqs_tpu/store/overlay.py``: the ephemeral index is the port's
``DenseIndex`` (``pad_multiple=128``) on an explicit device; the rest is the
reference's code.

Reference analog: ``src/worktree_overlay.rs`` — when the working tree has
uncommitted edits, queries build an ephemeral index of the dirty delta,
MASK the parent index's hits from those origins (their content is stale), and
merge overlay hits in; with 2x over-fetch while the overlay is active and an
LRU keyed on the delta fingerprint (the loom-modeled cache).

The overlay is a small in-memory DenseIndex (device tensors over just the
dirty chunks); stale parent rows are masked by origin in the engine's host
stage (``SearchEngine._merge_overlay``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.index import DenseIndex, Stamp
from cqs_tpu_torch.nl import generate_nl
from cqs_tpu_torch.parser import parse_file
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.store.store import ChunkRow
from cqs_tpu_torch.utils.hashing import content_hash, fingerprint_file
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("overlay")


@dataclass
class OverlayEntry:
    fingerprint: str
    index: DenseIndex
    rows: dict[str, ChunkRow]       # chunk id -> synthetic row
    dirty_origins: set[str]
    built_at: float


class WorktreeOverlay:
    """Detects dirty files (store fingerprint vs disk) and serves an
    ephemeral index over their current content."""

    def __init__(self, root: Path, store: Store, embedder, cache_entries: int = 4, *,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.store = store
        self.embedder = embedder
        self._cache: dict[str, OverlayEntry] = {}
        self._cap = cache_entries

    def dirty_origins(self) -> dict[str, Path]:
        """Origins whose on-disk content differs from the indexed fingerprint
        (modified or deleted files; new files are picked up too)."""
        import os

        out: dict[str, Path] = {}
        for origin, fp in self.store.registered_origins().items():
            p = self.root / origin
            try:
                st = os.stat(p)
                if not fp.matches_stat(st) and fingerprint_file(p).digest != fp.digest:
                    out[origin] = p
            except OSError:
                out[origin] = p          # deleted -> mask only
        return out

    def delta_fingerprint(self, dirty: dict[str, Path]) -> str:
        parts = []
        for origin in sorted(dirty):
            p = dirty[origin]
            try:
                parts.append(f"{origin}:{fingerprint_file(p).digest}")
            except OSError:
                parts.append(f"{origin}:gone")
        return content_hash("|".join(parts))

    def current(self) -> OverlayEntry | None:
        """Build (or reuse) the overlay for the current dirty state. Returns
        None when the tree is clean."""
        dirty = self.dirty_origins()
        if not dirty:
            return None
        fp = self.delta_fingerprint(dirty)
        hit = self._cache.get(fp)
        if hit is not None:
            return hit
        entry = self._build(dirty, fp)
        self._cache[fp] = entry
        while len(self._cache) > self._cap:
            oldest = min(self._cache, key=lambda k: self._cache[k].built_at)
            del self._cache[oldest]
        return entry

    def _build(self, dirty: dict[str, Path], fp: str) -> OverlayEntry:
        chunks = []
        rows: dict[str, ChunkRow] = {}
        for origin, p in dirty.items():
            if not p.exists():
                continue
            r = parse_file(p, root=self.root)
            if r is None:
                continue
            for c in r.chunks:
                chunks.append(c)
        nls = [generate_nl(c, self.embedder.max_seq_len) for c in chunks]
        vecs = self.embedder.embed_documents(nls) if chunks else np.zeros(
            (0, self.embedder.dim), np.float32)
        ids = [c.id for c in chunks]
        for c, nl in zip(chunks, nls):
            rows[c.id] = ChunkRow(
                rowid=-1, id=c.id, origin=c.origin, name=c.name,
                parent_name=c.parent_name, chunk_type=c.chunk_type.value,
                language=c.language, line_start=c.line_start, line_end=c.line_end,
                signature=c.signature, doc=c.doc, body=c.body,
                is_test=c.is_test, parent_id=c.parent_id, window_idx=c.window_idx,
                nl=nl, nl_base=nl)
        stamp = Stamp(model_fingerprint=self.embedder.fingerprint,
                      dim=self.embedder.dim, chunk_count=len(ids),
                      generation=-1, kind="overlay")
        index = DenseIndex(ids, vecs, stamp, pad_multiple=128, device=self.device)
        log.info("worktree overlay: %d dirty files -> %d chunks", len(dirty), len(ids))
        return OverlayEntry(fingerprint=fp, index=index, rows=rows,
                            dirty_origins=set(dirty), built_at=time.time())


def merge_overlay_hits(parent_hits: list, overlay_hits: list, limit: int) -> list:
    """Deterministic merge by (score desc, id) after parent-origin masking has
    already removed stale parent rows."""
    merged = list(parent_hits) + list(overlay_hits)
    merged.sort(key=lambda h: (-h.score, h.row.id))
    return merged[:limit]
