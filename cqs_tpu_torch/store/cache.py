"""Embedding and query caches.

Reference analog: ``src/cache/embedding_cache.rs`` (project-scoped SQLite,
content-hash x model-fingerprint keyed, size-capped eviction) and
``src/cache/query_cache.rs`` + the in-process LRU inside the Embedder.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.store.schema import CACHE_SCHEMA


class EmbeddingCache:
    """Persistent (canonical_hash, model_fingerprint) -> embedding cache with
    size-capped LRU eviction by last_used_at."""

    def __init__(self, path: str | Path, max_mb: int | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.db = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.executescript(CACHE_SCHEMA)
        self.db.commit()
        self.max_bytes = (max_mb or default_limits.embed_cache_max_mb) * 1024 * 1024
        self._lock = threading.Lock()

    def get(self, canonical_hash: str, fingerprint: str) -> np.ndarray | None:
        with self._lock:
            r = self.db.execute(
                "SELECT embedding FROM embedding_cache WHERE canonical_hash = ? "
                "AND model_fingerprint = ?", (canonical_hash, fingerprint)).fetchone()
            if r is None:
                return None
            self.db.execute(
                "UPDATE embedding_cache SET last_used_at = ? WHERE canonical_hash = ? "
                "AND model_fingerprint = ?", (time.time(), canonical_hash, fingerprint))
            self.db.commit()
            return np.frombuffer(r[0], dtype="<f4")

    def get_batch(self, hashes: list[str], fingerprint: str) -> dict[str, np.ndarray]:
        """One SELECT + one touch-commit for a whole batch — the per-call
        get() commits per lookup, which at 100k pending chunks is 100k fsyncs
        before the first embed batch even runs."""
        out: dict[str, np.ndarray] = {}
        if not hashes:
            return out
        now = time.time()
        with self._lock:
            CH = 500
            for s in range(0, len(hashes), CH):
                batch = hashes[s : s + CH]
                q = ",".join("?" * len(batch))
                for h, blob in self.db.execute(
                        f"SELECT canonical_hash, embedding FROM embedding_cache "
                        f"WHERE model_fingerprint = ? AND canonical_hash IN ({q})",
                        (fingerprint, *batch)):
                    out[h] = np.frombuffer(blob, dtype="<f4")
            if out:
                CH = 500
                hits = list(out)
                for s in range(0, len(hits), CH):
                    batch = hits[s : s + CH]
                    q = ",".join("?" * len(batch))
                    self.db.execute(
                        f"UPDATE embedding_cache SET last_used_at = ? "
                        f"WHERE model_fingerprint = ? AND canonical_hash IN ({q})",
                        (now, fingerprint, *batch))
                self.db.commit()
        return out

    def put(self, canonical_hash: str, fingerprint: str, vec: np.ndarray) -> None:
        now = time.time()
        with self._lock:
            self.db.execute(
                "INSERT OR REPLACE INTO embedding_cache VALUES (?,?,?,?,?)",
                (canonical_hash, fingerprint, np.asarray(vec, dtype="<f4").tobytes(), now, now))
            self.db.commit()

    def put_batch(self, items: list[tuple[str, str, np.ndarray]]) -> None:
        now = time.time()
        with self._lock:
            self.db.executemany(
                "INSERT OR REPLACE INTO embedding_cache VALUES (?,?,?,?,?)",
                [(h, f, np.asarray(v, dtype="<f4").tobytes(), now, now) for h, f, v in items])
            self.db.commit()
            self._evict_locked()

    def _evict_locked(self) -> None:
        (total,) = self.db.execute(
            "SELECT COALESCE(SUM(LENGTH(embedding)), 0) FROM embedding_cache").fetchone()
        if total <= self.max_bytes:
            return
        # drop least-recently-used rows until under the cap
        excess = total - self.max_bytes
        freed = 0
        doomed = []
        for h, f, n in self.db.execute(
                "SELECT canonical_hash, model_fingerprint, LENGTH(embedding) "
                "FROM embedding_cache ORDER BY last_used_at ASC"):
            doomed.append((h, f))
            freed += n
            if freed >= excess:
                break
        self.db.executemany(
            "DELETE FROM embedding_cache WHERE canonical_hash = ? AND model_fingerprint = ?",
            doomed)
        self.db.commit()

    # -- management surface (ref: `cqs cache` — src/cli/commands/infra/
    # cache_cmd.rs: stats/clear/prune/compact over the embeddings cache) ----

    def stats(self, per_model: bool = False) -> dict:
        """Entry counts, byte sizes, model fingerprints, timestamp range;
        bytes is the canonical unit (the text renderer shows MB)."""
        with self._lock:
            total, size, models, oldest, newest = self.db.execute(
                "SELECT COUNT(*), COALESCE(SUM(LENGTH(embedding)), 0), "
                "COUNT(DISTINCT model_fingerprint), MIN(created_at), "
                "MAX(created_at) FROM embedding_cache").fetchone()
            out = {
                "cache_path": str(self.path),
                "total_entries": int(total),
                "total_size_bytes": int(size),
                "unique_models": int(models),
                "oldest_timestamp": oldest,
                "newest_timestamp": newest,
            }
            if per_model:
                out["per_model"] = [
                    {"model": m, "entries": int(n), "size_bytes": int(b)}
                    for m, n, b in self.db.execute(
                        "SELECT model_fingerprint, COUNT(*), "
                        "SUM(LENGTH(embedding)) FROM embedding_cache "
                        "GROUP BY model_fingerprint ORDER BY 3 DESC")]
            return out

    def clear(self, model: str | None = None) -> int:
        """Delete all cached embeddings, or only one model fingerprint's."""
        with self._lock:
            if model is not None:
                cur = self.db.execute(
                    "DELETE FROM embedding_cache WHERE model_fingerprint = ?",
                    (model,))
            else:
                cur = self.db.execute("DELETE FROM embedding_cache")
            self.db.commit()
            return cur.rowcount

    def prune(self, days: float | None = None, model: str | None = None) -> int:
        """Remove entries older than ``days`` (by last use), OR every entry
        for ``model`` — mutually exclusive, as in the reference."""
        if (days is None) == (model is None):
            raise ValueError("prune takes exactly one of days / model")
        with self._lock:
            if model is not None:
                cur = self.db.execute(
                    "DELETE FROM embedding_cache WHERE model_fingerprint = ?",
                    (model,))
            else:
                cutoff = time.time() - days * 86400.0
                cur = self.db.execute(
                    "DELETE FROM embedding_cache WHERE last_used_at < ?",
                    (cutoff,))
            self.db.commit()
            return cur.rowcount

    def compact(self) -> int:
        """VACUUM to reclaim pages after large deletes; returns bytes freed."""
        with self._lock:
            before = self.path.stat().st_size if self.path.exists() else 0
            self.db.execute("VACUUM")
            self.db.commit()
            after = self.path.stat().st_size if self.path.exists() else 0
            return max(0, before - after)

    def close(self) -> None:
        self.db.close()


class QueryCache:
    """Two-tier query-embedding cache: in-process LRU over a persistent
    SQLite table (ref: QueryCache + Embedder LRU)."""

    def __init__(self, path: str | Path, lru_entries: int | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.db = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.executescript(CACHE_SCHEMA)
        self.db.commit()
        self._lru: OrderedDict[tuple[str, str], np.ndarray] = OrderedDict()
        self._cap = lru_entries if lru_entries is not None else default_limits.query_cache_entries
        self._lock = threading.Lock()

    def get(self, query: str, fingerprint: str) -> np.ndarray | None:
        key = (query, fingerprint)
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return self._lru[key]
            r = self.db.execute(
                "SELECT embedding FROM query_cache WHERE query_text = ? AND model_fingerprint = ?",
                key).fetchone()
            if r is None:
                return None
            vec = np.frombuffer(r[0], dtype="<f4")
            self._remember(key, vec)
            return vec

    def put(self, query: str, fingerprint: str, vec: np.ndarray) -> None:
        now = time.time()
        key = (query, fingerprint)
        with self._lock:
            self.db.execute(
                "INSERT OR REPLACE INTO query_cache VALUES (?,?,?,?,?)",
                (query, fingerprint, np.asarray(vec, dtype="<f4").tobytes(), now, now))
            self.db.commit()
            self._remember(key, np.asarray(vec, dtype=np.float32))

    def _remember(self, key, vec) -> None:
        if self._cap <= 0:
            return
        self._lru[key] = vec
        self._lru.move_to_end(key)
        while len(self._lru) > self._cap:
            self._lru.popitem(last=False)

    def close(self) -> None:
        self.db.close()
