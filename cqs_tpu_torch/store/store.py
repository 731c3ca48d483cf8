"""The SQLite metadata store.

Reference analog: ``src/store/`` — ``Store<Mode>`` typestate with a
process-global write lock (src/store/mod.rs:41-56), WAL + busy timeout, chunk
CRUD, FTS, call-graph queries, staleness fingerprints, and migrations.

Embedding BLOBs here are the canonical ground truth; the device-resident
dense index is built from them (and stamped against this store's counts and
generation) by ``cqs_tpu/index/dense.py``.
"""

from __future__ import annotations

import json
import sqlite3
import struct
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from cqs_tpu_torch.parser.types import PARSER_VERSION, Chunk, ChunkType
from cqs_tpu_torch.store.schema import CACHE_SCHEMA, SCHEMA, SCHEMA_VERSION
from cqs_tpu_torch.utils.hashing import Fingerprint
from cqs_tpu_torch.utils.text import normalize_for_fts

# FTS body cap: BM25 over full code bodies matches the reference's `content`
# column (src/schema.sql:153); the cap bounds index size on giant chunks.
_FTS_BODY_CAP = 8000

# Process-global write serialization (ref: WRITE_LOCK, src/store/mod.rs:41-56).
_WRITE_LOCK = threading.RLock()


def _to_blob(vec: np.ndarray) -> bytes:
    return np.asarray(vec, dtype="<f4").tobytes()


def _from_blob(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<f4")


@dataclass
class ChunkRow:
    """Hydrated chunk row (the search/analysis view of a chunk)."""

    rowid: int
    id: str
    origin: str
    name: str
    parent_name: str | None
    chunk_type: str
    language: str
    line_start: int
    line_end: int
    signature: str
    doc: str
    body: str
    is_test: bool
    parent_id: str | None
    window_idx: int | None
    nl: str
    nl_base: str

    @property
    def qualified_name(self) -> str:
        return f"{self.parent_name}.{self.name}" if self.parent_name else self.name


_CHUNK_COLS = ("rowid, id, origin, name, parent_name, chunk_type, language, "
               "line_start, line_end, signature, doc, body, is_test, parent_id, "
               "window_idx, nl, nl_base")

# meta-only hydration: heavy text columns replaced by '' (same column order)
_CHUNK_META_COLS = ("rowid, id, origin, name, parent_name, chunk_type, language, "
                    "line_start, line_end, signature, doc, '', is_test, parent_id, "
                    "window_idx, '', ''")


def _row_to_chunk(r) -> ChunkRow:
    return ChunkRow(
        rowid=r[0], id=r[1], origin=r[2], name=r[3], parent_name=r[4],
        chunk_type=r[5], language=r[6], line_start=r[7], line_end=r[8],
        signature=r[9], doc=r[10], body=r[11], is_test=bool(r[12]),
        parent_id=r[13], window_idx=r[14], nl=r[15], nl_base=r[16],
    )


class Store:
    """SQLite-backed metadata store. ``readonly=True`` opens in query mode
    (no write lock taken; safe for concurrent daemon readers)."""

    def __init__(self, path: str | Path, readonly: bool = False):
        self.path = Path(path)
        self.readonly = readonly
        if readonly:
            uri = f"file:{self.path}?mode=ro"
            self.db = sqlite3.connect(uri, uri=True, timeout=30.0, check_same_thread=False)
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.db = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA synchronous=NORMAL")
        self.db.execute("PRAGMA mmap_size=268435456")
        self.db.execute("PRAGMA foreign_keys=ON")
        self._lock = threading.RLock()
        self._vocab_ready: set[str] = set()
        # per-generation document-frequency cache for the FTS df-filter
        self._df_cache: dict[tuple[str, str], int] = {}
        self._df_cache_gen: int | None = None
        self._note_count_cache: tuple[int, int] | None = None   # (generation, count)
        # per-generation meta-row cache (see get_chunks_by_ids); cleared on
        # every local write txn — cross-process writers only produce the
        # ALLOWED kind of staleness (meta text), never wrong content: body
        # changes mint new content-addressed ids
        self._meta_rows: dict[str, ChunkRow] = {}
        self._meta_row_gen: int | None = None
        # Thread-local READ connections: one sqlite3 connection must not run
        # cursors from several threads at once (the daemon batcher's parallel
        # hydrate hit "bad parameter or other API misuse"). Reads from
        # non-home threads go through a per-thread read-only clone; WAL gives
        # each a consistent snapshot. Writes stay on the home connection,
        # serialized by write_txn.
        self._home_thread = threading.get_ident()
        self._tlocal = threading.local()
        self._write_epoch = 0
        if not readonly:
            from cqs_tpu_torch.store.migrations import migrate

            migrate(self.db, self.path)       # older stores step up first
            with self.write_txn():
                self.db.executescript(SCHEMA)
                self._init_metadata()

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def open(cls, index_dir: str | Path, slot: str = "default", readonly: bool = False) -> "Store":
        """Open the store for a slot under the project index dir
        (layout: ``.cqs-tpu/slots/<slot>/index.db``, ref: src/slot/mod.rs)."""
        p = Path(index_dir) / "slots" / slot / "index.db"
        return cls(p, readonly=readonly)

    def _read_db(self) -> sqlite3.Connection:
        """The connection to READ from in the calling thread: the home
        connection on the thread that opened the store, else that thread's
        own read-only connection (WAL gives it the last committed snapshot).
        A worker thread is never handed the home connection: two threads that
        run the same SQL text on one connection share its cached prepared
        statement, and one thread's step takes the other's row. The open is
        retried; when it still fails, the error is raised."""
        if threading.get_ident() == self._home_thread:
            return self.db
        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            for attempt in range(3):
                try:
                    conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True,
                                           timeout=30.0)
                    conn.execute("PRAGMA mmap_size=268435456")
                    break
                except sqlite3.OperationalError:
                    if attempt == 2:
                        raise
                    time.sleep(0.05 * (attempt + 1))
            self._tlocal.conn = conn
        return conn

    def close(self) -> None:
        self.db.close()

    def __enter__(self) -> "Store":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- transactions ------------------------------------------------------

    class _Txn:
        """Reentrant write transaction: only the OUTERMOST scope commits (or
        rolls back), so a helper that opens its own write_txn inside a larger
        one cannot commit the caller's work early."""

        def __init__(self, store: "Store"):
            self.store = store
            self._outermost = False

        def __enter__(self):
            _WRITE_LOCK.acquire()
            self.store._lock.acquire()
            if not self.store.db.in_transaction:
                self.store.db.execute("BEGIN IMMEDIATE")
                self._outermost = True
            return self.store.db

        def __exit__(self, et, ev, tb):
            try:
                if self._outermost:
                    if et is None:
                        self.store.db.commit()
                    else:
                        self.store.db.rollback()
                    self.store._meta_rows = {}
                    self.store._meta_row_gen = None
                    # own writes don't move PRAGMA data_version on this
                    # connection — the epoch keeps coherence_token honest
                    self.store._write_epoch += 1
            finally:
                self.store._lock.release()
                _WRITE_LOCK.release()
            return False

    def write_txn(self) -> "_Txn":
        if self.readonly:
            raise RuntimeError("store opened read-only")
        return Store._Txn(self)

    # -- metadata ----------------------------------------------------------

    def _init_metadata(self) -> None:
        self.db.execute(
            "INSERT OR IGNORE INTO metadata(key, value) VALUES ('schema_version', ?)",
            (str(SCHEMA_VERSION),))
        self.db.execute(
            "INSERT OR IGNORE INTO metadata(key, value) VALUES ('splade_generation', '0')")
        self.db.execute(
            "INSERT OR IGNORE INTO metadata(key, value) VALUES ('created_at', ?)",
            (str(time.time()),))

    def get_meta(self, key: str, default: str | None = None) -> str | None:
        row = self._read_db().execute(
            "SELECT value FROM metadata WHERE key = ?", (key,)).fetchone()
        return row[0] if row else default

    def set_meta(self, key: str, value: str) -> None:
        with self.write_txn():
            self.db.execute(
                "INSERT INTO metadata(key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value", (key, value))

    @property
    def generation(self) -> int:
        return self.coherence_token()[0]

    def coherence_token(self) -> tuple[int, int]:
        """(generation, MAX(chunk rowid)) — the pair every staleness-keyed
        cache should key on: generation moves on chunk DELETEs (schema
        trigger), MAX(rowid) on appends. Cached per thread behind
        ``PRAGMA data_version`` (which moves when ANOTHER connection commits)
        plus an own-write epoch (own commits don't move data_version), so the
        warm serving path pays one cheap PRAGMA instead of two SELECTs per
        lookup — measured as a top lock-contention source under daemon load
        (store.generation alone was ~4 SQL round trips per request)."""
        db = self._read_db()
        try:
            dv = db.execute("PRAGMA data_version").fetchone()[0]
        except sqlite3.OperationalError:
            dv = -1
        key = (id(db), dv, self._write_epoch)
        cached = getattr(self._tlocal, "coherence", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        gen = int(self.get_meta("splade_generation", "0") or 0)
        try:
            mx = db.execute("SELECT MAX(rowid) FROM chunks").fetchone()[0] or 0
        except sqlite3.OperationalError:
            mx = 0
        try:
            # notes feed score boosts: full-result caches keyed on this token
            # must invalidate when notes change (count catches deletes, max
            # id catches adds; the table is tiny)
            nc, nmx = db.execute(
                "SELECT COUNT(*), COALESCE(MAX(id), 0) FROM notes").fetchone()
        except sqlite3.OperationalError:
            nc, nmx = 0, 0
        tok = (gen, int(mx), int(nc), int(nmx))
        self._tlocal.coherence = (key, tok)
        return tok

    def chunk_count(self) -> int:
        return self._read_db().execute("SELECT COUNT(*) FROM chunks").fetchone()[0]

    # -- chunk CRUD --------------------------------------------------------

    def upsert_chunks(self, chunks: Sequence[Chunk], nls: Sequence[str] | None = None,
                      nls_base: Sequence[str] | None = None) -> list[str]:
        """Insert or replace chunks (by content-addressed id). Returns ids.

        New rows get ``needs_embedding=1``; rows whose id already exists keep
        their embeddings (content-addressed id == identical content).
        """
        ids: list[str] = []
        with self.write_txn() as db:
            for i, c in enumerate(chunks):
                nl = nls[i] if nls else ""
                nl_base = nls_base[i] if nls_base else nl
                existing = db.execute(
                    "SELECT rowid FROM chunks WHERE id = ?", (c.id,)).fetchone()
                if existing:
                    # Same content-addressed id, but parser-derived metadata
                    # (name, parent, type, doc) may have changed across parser
                    # versions — refresh it. A changed base NL means the stored
                    # embedding no longer matches what we'd embed: requeue it.
                    rowid = existing[0]
                    old = db.execute(
                        "SELECT nl_base FROM chunks WHERE id = ?", (c.id,)).fetchone()
                    nl_changed = bool(nl_base) and old is not None and old[0] != nl_base
                    db.execute(
                        "UPDATE chunks SET nl = COALESCE(NULLIF(?, ''), nl), "
                        "nl_base = COALESCE(NULLIF(?, ''), nl_base), "
                        "name = ?, parent_name = ?, chunk_type = ?, signature = ?, "
                        "doc = ?, parser_version = ?, "
                        "needs_embedding = CASE WHEN ? THEN 1 ELSE needs_embedding END, "
                        "enrichment_hash = CASE WHEN ? THEN NULL ELSE enrichment_hash END "
                        "WHERE id = ?",
                        (nl, nl_base, c.name, c.parent_name, c.chunk_type.value,
                         c.signature, c.doc, PARSER_VERSION,
                         int(nl_changed), int(nl_changed), c.id))
                    if nl_changed:
                        db.execute("DELETE FROM sparse_vectors WHERE chunk_id = ?", (c.id,))
                    # FTS rows are rowid-aligned with chunks (schema v3):
                    # deleting by the UNINDEXED id column is a FULL FTS SCAN
                    # per chunk — O(N^2) on a reindex (measured 838 GB of
                    # reads before one 66k-row reindex got 1/4 through)
                    db.execute("DELETE FROM chunks_fts WHERE rowid = ?", (rowid,))
                    db.execute(
                        "INSERT INTO chunks_fts (rowid, id, name_norm, nl_norm, doc_norm) VALUES (?,?,?,?,?)",
                        (rowid, c.id, normalize_for_fts(c.qualified_name),
                         normalize_for_fts(nl or c.name), normalize_for_fts(c.doc)))
                    db.execute("DELETE FROM chunks_fts_body WHERE rowid = ?", (rowid,))
                    db.execute(
                        "INSERT INTO chunks_fts_body (rowid, id, sig_norm, body_norm) VALUES (?,?,?,?)",
                        (rowid, c.id, normalize_for_fts(c.signature),
                         normalize_for_fts(c.body[:_FTS_BODY_CAP])))
                    ids.append(c.id)
                    continue
                cur = db.execute(
                    "INSERT INTO chunks (id, origin, name, parent_name, chunk_type, "
                    "language, line_start, line_end, signature, doc, body, body_hash, "
                    "canonical_hash, return_type, is_test, parent_id, window_idx, nl, "
                    "nl_base, needs_embedding, parser_version) "
                    "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,1,?)",
                    (c.id, c.origin, c.name, c.parent_name, c.chunk_type.value,
                     c.language, c.line_start, c.line_end, c.signature, c.doc,
                     c.body, c.body_hash, c.canonical, c.return_type,
                     int(c.is_test), c.parent_id, c.window_idx, nl, nl_base,
                     PARSER_VERSION))
                rowid = cur.lastrowid
                db.execute(
                    "INSERT INTO chunks_fts (rowid, id, name_norm, nl_norm, doc_norm) VALUES (?,?,?,?,?)",
                    (rowid, c.id, normalize_for_fts(c.qualified_name),
                     normalize_for_fts(nl or c.name), normalize_for_fts(c.doc)))
                db.execute(
                    "INSERT INTO chunks_fts_body (rowid, id, sig_norm, body_norm) VALUES (?,?,?,?)",
                    (rowid, c.id, normalize_for_fts(c.signature),
                     normalize_for_fts(c.body[:_FTS_BODY_CAP])))
                for call in c.calls:
                    db.execute(
                        "INSERT INTO function_calls (caller_id, callee_name, line, kind, receiver) "
                        "VALUES (?,?,?,?,?)",
                        (c.id, call.callee, call.line, call.kind.value, call.receiver))
                for ref in c.type_refs:
                    db.execute(
                        "INSERT INTO type_edges (chunk_id, type_name, role, line) VALUES (?,?,?,?)",
                        (c.id, ref.name, ref.role, ref.line))
                ids.append(c.id)
        return ids

    def delete_chunks_for_origin(self, origin: str, keep_ids: set[str] | None = None) -> int:
        """Delete chunks of a file (incremental reindex drops stale rows).
        ``keep_ids`` preserves rows whose content survived the edit."""
        with self.write_txn() as db:
            rows = db.execute("SELECT id, rowid FROM chunks WHERE origin = ?", (origin,)).fetchall()
            doomed = [(r[0], r[1]) for r in rows if not keep_ids or r[0] not in keep_ids]
            for cid, rowid in doomed:
                db.execute("DELETE FROM chunks_fts WHERE rowid = ?", (rowid,))
                db.execute("DELETE FROM chunks_fts_body WHERE rowid = ?", (rowid,))
                db.execute("DELETE FROM chunks WHERE id = ?", (cid,))
            return len(doomed)

    def get_chunk(self, chunk_id: str) -> ChunkRow | None:
        r = self._read_db().execute(
            f"SELECT {_CHUNK_COLS} FROM chunks WHERE id = ?", (chunk_id,)).fetchone()
        return _row_to_chunk(r) if r else None

    def get_chunks_by_ids(self, ids: Sequence[str],
                          meta_only: bool = False) -> list[ChunkRow]:
        """Hydrate rows by id. ``meta_only`` skips the heavy text columns
        (body/nl/nl_base -> empty strings): candidate scoring needs only the
        metadata, and the pool is ~500 rows per query — hydrating full text
        for all of them costs more than the whole scoring pass."""
        if not ids:
            return []
        cols = _CHUNK_META_COLS if meta_only else _CHUNK_COLS
        cache: dict[str, ChunkRow] | None = None
        if meta_only:
            # Per-generation meta-row cache: candidate pools re-hydrate the
            # same popular rows on every query (~500 ids, measured 5.6 ms/
            # query of the warm serving path at 31k chunks). Rows are
            # immutable per generation; a reindex bumps the generation and
            # drops the cache wholesale.
            gen = self.generation
            if self._meta_row_gen != gen or len(self._meta_rows) > 200_000:
                self._meta_rows = {}
                self._meta_row_gen = gen
            cache = self._meta_rows
            todo = [cid for cid in ids if cid not in cache]
        else:
            todo = list(ids)
        fetched: list[ChunkRow] = []
        db = self._read_db()
        for i in range(0, len(todo), 500):
            batch = list(todo[i : i + 500])
            q = ",".join("?" * len(batch))
            rows = db.execute(
                f"SELECT {cols} FROM chunks WHERE id IN ({q})", batch).fetchall()
            fetched.extend(_row_to_chunk(r) for r in rows)
        if cache is not None:
            for r in fetched:
                cache[r.id] = r
            out = [cache[cid] for cid in dict.fromkeys(ids) if cid in cache]
            return out
        out = fetched
        order = {cid: i for i, cid in enumerate(ids)}
        out.sort(key=lambda c: order.get(c.id, 1 << 30))
        return out

    def find_by_name(self, name: str, exact: bool = True) -> list[ChunkRow]:
        if exact:
            rows = self._read_db().execute(
                f"SELECT {_CHUNK_COLS} FROM chunks WHERE name = ? ORDER BY origin, line_start",
                (name,)).fetchall()
        else:
            rows = self._read_db().execute(
                f"SELECT {_CHUNK_COLS} FROM chunks WHERE name LIKE ? ORDER BY origin, line_start",
                (f"%{name}%",)).fetchall()
        return [_row_to_chunk(r) for r in rows]

    def iter_chunks(self, where: str = "", params: tuple = ()) -> Iterable[ChunkRow]:
        sql = f"SELECT {_CHUNK_COLS} FROM chunks"
        if where:
            sql += f" WHERE {where}"
        sql += " ORDER BY rowid"
        for r in self._read_db().execute(sql, params):
            yield _row_to_chunk(r)

    def all_origins(self) -> list[str]:
        return [r[0] for r in self._read_db().execute("SELECT DISTINCT origin FROM chunks ORDER BY origin")]

    # -- embeddings --------------------------------------------------------

    def pending_embeddings(self, limit: int = 0) -> list[tuple[str, str, str]]:
        """Rows needing embedding: (id, nl, nl_base)."""
        sql = "SELECT id, nl, nl_base FROM chunks WHERE needs_embedding = 1 ORDER BY rowid"
        if limit:
            sql += f" LIMIT {int(limit)}"
        return list(self._read_db().execute(sql))

    def put_embeddings(self, ids: Sequence[str], vecs: np.ndarray,
                       vecs_base: np.ndarray | None = None) -> None:
        with self.write_txn() as db:
            for i, cid in enumerate(ids):
                base_blob = _to_blob(vecs_base[i]) if vecs_base is not None else None
                db.execute(
                    "UPDATE chunks SET embedding = ?, embedding_base = COALESCE(?, embedding_base), "
                    "needs_embedding = 0 WHERE id = ?",
                    (_to_blob(vecs[i]), base_blob, cid))

    def load_embeddings(self, base: bool = False) -> tuple[list[str], np.ndarray]:
        """All embedded rows in rowid order -> (ids, [N, D] f32 matrix).
        The rowid order is the dense-index row order contract."""
        col = "embedding_base" if base else "embedding"
        ids: list[str] = []
        vecs: list[np.ndarray] = []
        for cid, blob in self._read_db().execute(
                f"SELECT id, {col} FROM chunks WHERE {col} IS NOT NULL ORDER BY rowid"):
            ids.append(cid)
            vecs.append(_from_blob(blob))
        if not vecs:
            return [], np.zeros((0, 0), dtype=np.float32)
        return ids, np.stack(vecs)

    def get_embedding_by_canonical(self, canonical: str) -> np.ndarray | None:
        """Canonical-hash embedding reuse: a formatting-only edit produces a
        new chunk id but the same canonical hash (ref: schema v28 reuse)."""
        r = self._read_db().execute(
            "SELECT embedding FROM chunks WHERE canonical_hash = ? AND embedding IS NOT NULL "
            "LIMIT 1", (canonical,)).fetchone()
        return _from_blob(r[0]) if r else None

    # -- sparse vectors ----------------------------------------------------

    def put_sparse(self, chunk_id: str, token_ids: np.ndarray, weights: np.ndarray) -> None:
        with self.write_txn() as db:
            db.execute(
                "INSERT OR REPLACE INTO sparse_vectors (chunk_id, token_ids, weights, nnz) "
                "VALUES (?,?,?,?)",
                (chunk_id, np.asarray(token_ids, dtype="<i4").tobytes(),
                 _to_blob(weights), int(len(token_ids))))

    def put_sparse_batch(self, items: Sequence[tuple[str, np.ndarray, np.ndarray]]) -> None:
        with self.write_txn() as db:
            db.executemany(
                "INSERT OR REPLACE INTO sparse_vectors (chunk_id, token_ids, weights, nnz) "
                "VALUES (?,?,?,?)",
                [(cid, np.asarray(t, dtype="<i4").tobytes(), _to_blob(w), int(len(t)))
                 for cid, t, w in items])

    def load_sparse(self) -> list[tuple[str, np.ndarray, np.ndarray]]:
        out = []
        for cid, tb, wb in self._read_db().execute(
                "SELECT sv.chunk_id, sv.token_ids, sv.weights FROM sparse_vectors sv "
                "JOIN chunks c ON c.id = sv.chunk_id ORDER BY c.rowid"):
            out.append((cid, np.frombuffer(tb, dtype="<i4"), _from_blob(wb)))
        return out

    def missing_sparse(self) -> list[tuple[str, str]]:
        return list(self._read_db().execute(
            "SELECT c.id, c.nl FROM chunks c LEFT JOIN sparse_vectors sv "
            "ON sv.chunk_id = c.id WHERE sv.chunk_id IS NULL ORDER BY c.rowid"))

    # -- FTS ---------------------------------------------------------------

    def fts_search(self, query: str, limit: int = 50,
                   synonyms: dict[str, list[str]] | None = None,
                   scope: str = "meta",
                   require_all: bool = False,
                   column: str | None = None,
                   stems: str = "zero-df") -> list[tuple[str, float]]:
        """FTS5 search; returns (chunk_id, bm25) with LOWER bm25 = better
        (sqlite convention), negated to score-like. ``synonyms`` overlays the
        builtin expansion table (ref: synonyms.rs OR-group expansion);
        ``scope`` picks the column-weight profile (meta vs body).
        ``require_all`` ANDs the term groups instead of ORing them — the
        high-precision structural leg (every structural token must appear in
        the chunk); the df-filter is skipped there because frequent tokens
        like TEXT/async ARE the signal and the AND-intersection bounds the
        posting walk."""
        from cqs_tpu_torch.search.synonyms import expand_words

        q = normalize_for_fts(query)
        terms = [t for t in q.split() if t]
        if not terms:
            return []
        table = "chunks_fts_body" if scope == "body" else "chunks_fts"
        db = self._read_db()
        # df-filter: terms whose posting list covers most of the corpus add
        # scan time (the OR-union walks every posting) and contribute near-
        # zero bm25 — drop them before the MATCH (measured ~19 ms/leg at 35k
        # chunks with common words like "table"/"function"). Always keep the
        # 3 most selective so a stopword-only query still answers.
        all_terms = terms
        dfs = {} if require_all else self._fts_term_df(table, terms)
        n = max(self.chunk_count(), 1)
        from cqs_tpu_torch.config import limits as _lim
        cutoff = max(200, int(_lim.fts_df_cutoff * n))
        keep = {t for t in terms if dfs.get(t, 0) <= cutoff}
        if not keep:
            # floor: a stopword-only query still answers — but ONLY when no
            # selective term survives (unconditionally keeping the 3 most
            # selective re-admitted a full-corpus posting walk per leg:
            # measured 60 ms vs 11 ms on the 31k bench corpus)
            by_df = sorted(terms, key=lambda t: dfs.get(t, 0))
            keep = set(by_df[:3])
        terms = [t for t in terms if t in keep]
        groups = expand_words(terms, overlay=synonyms)
        # Morphological rescue: stems as FTS5 prefix variants connect the
        # inflection gaps the unicode61 tokenizer can't ('embeds' ->
        # embed_batch, 'classification' -> classify, 'migration' ->
        # migrate_v12_to_v13). ``stems`` policy:
        #   "zero-df"  — only terms whose exact form never occurs in this
        #                table (pure rescue; terms that already match keep
        #                their precise bm25 — unconditional stemming measured
        #                -0.9 pp dev R@5 from dilution)
        #   "all"      — every stemmable term (the dedicated low-weight stem
        #                rescue leg uses this)
        #   "off"      — none
        if stems != "off":
            from cqs_tpu_torch.search.synonyms import stem_prefix

            stem_dfs = (dfs if dfs else self._fts_term_df(table, terms)) \
                if stems == "zero-df" else {}
            # fts_stem_df_max widens the zero-df rescue to near-zero df:
            # a term can occur in unrelated prose (df 1-2) while its
            # morphological family holds the gold ('watcher' -> watch_*)
            stem_df_max = _lim.fts_stem_df_max if stems == "zero-df" else 0
            for t, g in groups.items():
                if stems == "all" or stem_dfs.get(t, 0) <= stem_df_max:
                    sp = stem_prefix(t)
                    if sp is not None:
                        g.append(sp + "*")
        # Abbreviation rescue (fts_abbrev): a spelled-out query term ORs its
        # identifier abbreviation into its group when that token exists in
        # this table ('statistics about the embedding cache' -> stats ->
        # embedding_cache.rs:stats). Reverse of the name-boost table —
        # query-side, bm25-weighted, so a df-heavy abbreviation can't
        # dominate (targets the r4 dev-triage vocab class: miss 35).
        if _lim.fts_abbrev and not require_all:
            from cqs_tpu_torch.search.scoring import reverse_abbrev

            rev = reverse_abbrev()
            cands = {t: rev[t] for t in groups if t in rev}
            if cands:
                flat = [a for alist in cands.values() for a in alist]
                adf = self._fts_term_df(table, flat)
                for t, alist in cands.items():
                    g = groups[t]
                    for a in alist:
                        if 0 < adf.get(a, 0) <= cutoff and a not in g:
                            g.append(a)
        # Acronym rescue: a spelled-out 3/4-word phrase ORs its initials
        # into the first word's group when that token exists in this table
        # ('reciprocal rank fusion' -> rrf -> rrf_fuse). Computed over the
        # PRE-df-filter term sequence (adjacency matters; a dropped common
        # word like 'rank' still contributes its initial).
        if _lim.fts_acronym and not require_all:
            from cqs_tpu_torch.search.synonyms import acronyms

            for first, acrs in acronyms(all_terms).items():
                g = groups.get(first)
                if g is None:
                    continue
                adf = self._fts_term_df(table, acrs)
                for a in acrs:
                    if 0 < adf.get(a, 0) <= cutoff and a not in g:
                        g.append(a)
        joiner = " AND " if require_all else " OR "
        # ``column`` restricts every term to one FTS column (FTS5
        # ``col : term`` syntax) — the signature-precision structural leg
        # matches sig_norm only, so body prose can't dilute the AND.
        pre = f"{column} : " if column else ""

        def _tok(s: str) -> str:
            # trailing-* group members are stem-prefix variants (synonyms.
            # expand_words): FTS5 prefix phrase syntax is `"stem" *`
            if s.endswith("*"):
                return f'{pre}"{s[:-1]}" *'
            return f'{pre}"{s}"'

        match = joiner.join(
            _tok(g[0]) if len(g) == 1
            else "(" + " OR ".join(_tok(s) for s in g) + ")"
            for _t, g in groups.items())
        try:
            rows = db.execute(
                f"SELECT id, bm25({table}) AS s "
                f"FROM {table} WHERE {table} MATCH ? "
                "ORDER BY s LIMIT ?", (match, limit)).fetchall()
        except sqlite3.OperationalError:
            return []
        return [(r[0], -float(r[1])) for r in rows]

    def _fts_term_df(self, table: str, terms: list[str]) -> dict[str, int]:
        """Per-term document frequency via an fts5vocab shadow table (created
        lazily, persisted in the db). Unknown terms -> df 0."""
        vocab = f"{table}_vocab"
        rdb = self._read_db()
        if vocab not in self._vocab_ready:
            exists = rdb.execute(
                "SELECT 1 FROM sqlite_master WHERE name = ?", (vocab,)).fetchone()
            if not exists:
                if threading.get_ident() != self._home_thread or self.readonly:
                    return {}   # only the home (writable) connection creates
                try:
                    self.db.execute(
                        f"CREATE VIRTUAL TABLE IF NOT EXISTS {vocab} "
                        f"USING fts5vocab({table}, 'row')")
                except sqlite3.OperationalError:
                    return {}
            self._vocab_ready.add(vocab)
        # Point lookups, one term at a time: fts5vocab's xBestIndex serves
        # ``term = ?`` as an indexed probe, but ``term IN (...)`` degrades to
        # a full vocab scan (measured 61 ms/call at 31k chunks vs <1 ms).
        # Results cache per store generation — query legs re-ask the same
        # handful of words every search.
        gen = self.generation
        if self._df_cache_gen != gen:
            self._df_cache = {}
            self._df_cache_gen = gen
        out: dict[str, int] = {}
        for t in terms:
            tl = t.lower()
            ck = (vocab, tl)
            df = self._df_cache.get(ck)
            if df is None:
                try:
                    row = rdb.execute(
                        f"SELECT doc FROM {vocab} WHERE term = ?", (tl,)).fetchone()
                except sqlite3.OperationalError:
                    return out
                # fts5vocab rows can surface malformed under concurrent
                # writers — a bad row just means "no df info for that term"
                try:
                    df = int(row[0]) if row else 0
                except (TypeError, ValueError):
                    df = 0
                self._df_cache[ck] = df
            if df:
                out[t] = df
        return out

    def search_by_name_fts(self, name: str, limit: int = 25) -> list[ChunkRow]:
        """Name-first FTS lookup (the NameOnly strategy short-circuit).

        Ordering: exact normalized-name matches first, then code chunks
        (a function literally named X must beat a doc section whose long
        title merely mentions X), bm25 within each group."""
        q = normalize_for_fts(name)
        terms = [t for t in q.split() if t]
        if not terms:
            return []
        match = " AND ".join(f'"{t}"' for t in terms)
        try:
            rows = self._read_db().execute(
                "SELECT id FROM chunks_fts WHERE name_norm MATCH ? "
                "ORDER BY bm25(chunks_fts) LIMIT ?", (match, limit * 4)).fetchall()
        except sqlite3.OperationalError:
            return []
        chunks = self.get_chunks_by_ids([r[0] for r in rows])
        prose = ("section", "window", "config")
        chunks.sort(key=lambda r: (normalize_for_fts(r.name.split("#w")[0]) != q,
                                   r.chunk_type in prose))
        return chunks[:limit]

    # -- file registry / staleness ----------------------------------------

    def get_fingerprint(self, origin: str) -> Fingerprint | None:
        r = self._read_db().execute(
            "SELECT mtime_ns, size, digest FROM file_registry WHERE origin = ?",
            (origin,)).fetchone()
        return Fingerprint(mtime_ns=r[0], size=r[1], digest=r[2]) if r else None

    def put_fingerprint(self, origin: str, fp: Fingerprint, chunk_count: int,
                        errors: list[str] | None = None) -> None:
        with self.write_txn() as db:
            db.execute(
                "INSERT OR REPLACE INTO file_registry "
                "(origin, mtime_ns, size, digest, chunk_count, parse_errors, parser_version) "
                "VALUES (?,?,?,?,?,?,?)",
                (origin, fp.mtime_ns, fp.size, fp.digest, chunk_count,
                 json.dumps(errors) if errors else None, PARSER_VERSION))

    def registered_origins(self) -> dict[str, Fingerprint]:
        return {r[0]: Fingerprint(mtime_ns=r[1], size=r[2], digest=r[3])
                for r in self._read_db().execute(
                    "SELECT origin, mtime_ns, size, digest FROM file_registry")}

    def remove_origin(self, origin: str) -> None:
        with self.write_txn() as db:
            for (rowid,) in db.execute("SELECT rowid FROM chunks WHERE origin = ?", (origin,)):
                db.execute("DELETE FROM chunks_fts WHERE rowid = ?", (rowid,))
                db.execute("DELETE FROM chunks_fts_body WHERE rowid = ?", (rowid,))
            db.execute("DELETE FROM chunks WHERE origin = ?", (origin,))
            db.execute("DELETE FROM file_registry WHERE origin = ?", (origin,))

    def stale_parser_origins(self) -> list[str]:
        """Origins indexed with an older parser version (drift requeue)."""
        return [r[0] for r in self._read_db().execute(
            "SELECT origin FROM file_registry WHERE parser_version < ? AND fail_count < 3",
            (PARSER_VERSION,))]

    # -- call graph --------------------------------------------------------

    def callers_of(self, name: str) -> list[tuple[ChunkRow, int, str]]:
        """Chunks that call ``name``: (caller_chunk, line, kind). Meta-only
        hydration: every consumer reads identity/position fields, and a
        high-fanout symbol has thousands of callers — dragging body/nl for
        each measured 26 ms/call at 3k callers on the 31k bench corpus
        (9 ms meta-only)."""
        rows = self._read_db().execute(
            f"SELECT {_CHUNK_META_COLS}, fc.line, fc.kind FROM function_calls fc "
            "JOIN chunks ON chunks.id = fc.caller_id WHERE fc.callee_name = ? "
            "ORDER BY chunks.origin, chunks.line_start", (name,)).fetchall()
        return [(_row_to_chunk(r[:17]), r[17], r[18]) for r in rows]

    def callees_of(self, chunk_id: str) -> list[tuple[str, int, str]]:
        return list(self._read_db().execute(
            "SELECT callee_name, line, kind FROM function_calls WHERE caller_id = ? "
            "ORDER BY line", (chunk_id,)))

    def call_edges(self, fanout_cap: int | None = None) -> list[tuple[str, str]]:
        """All resolved (caller_id, callee_chunk_id) edges, name-resolved
        against chunk names (ref: CallGraph adjacency in src/store/helpers/).

        Resolution prefers a definition in the CALLER'S OWN FILE (local
        symbols shadow — a file-local ``make_helper`` must not link to every
        same-named helper corpus-wide); names without a local definition
        resolve globally only while unambiguous enough (<= ``fanout_cap``
        definitions — a name defined in 100 files carries no signal, and the
        naive name join exploded |calls| x |defs| on such corpora: measured
        9.3 s per impact call at 31k chunks)."""
        from cqs_tpu_torch.config import limits as _lim

        cap = fanout_cap if fanout_cap is not None else _lim.callgraph_fanout_cap
        defs: dict[str, list[tuple[str, str]]] = {}
        for cid, name, origin in self._read_db().execute(
                "SELECT id, name, origin FROM chunks"):
            defs.setdefault(name, []).append((origin, cid))
        edges: list[tuple[str, str]] = []
        for caller_id, callee_name, caller_origin in self._read_db().execute(
                "SELECT DISTINCT fc.caller_id, fc.callee_name, c1.origin "
                "FROM function_calls fc JOIN chunks c1 ON c1.id = fc.caller_id"):
            targets = defs.get(callee_name)
            if not targets:
                continue
            local = [cid for o, cid in targets
                     if o == caller_origin and cid != caller_id]
            if local:
                edges.extend((caller_id, cid) for cid in local)
            elif len(targets) <= cap:
                edges.extend((caller_id, cid) for o, cid in targets
                             if cid != caller_id)
        return edges

    def type_users(self, type_name: str) -> list[ChunkRow]:
        # meta-only: consumers read identity/position fields (see callers_of)
        rows = self._read_db().execute(
            f"SELECT DISTINCT {_CHUNK_META_COLS} FROM type_edges te "
            "JOIN chunks ON chunks.id = te.chunk_id WHERE te.type_name = ? "
            "ORDER BY chunks.origin, chunks.line_start", (type_name,)).fetchall()
        return [_row_to_chunk(r) for r in rows]

    # -- notes -------------------------------------------------------------

    def add_note(self, target: str, text: str, sentiment: str = "neutral") -> int:
        self._note_count_cache = None     # invalidate the fast-path cache
        with self.write_txn() as db:
            cur = db.execute(
                "INSERT INTO notes (target, text, sentiment, created_at) VALUES (?,?,?,?)",
                (target, text, sentiment, time.time()))
            note_id = cur.lastrowid
            db.execute(
                "INSERT INTO notes_fts (note_id, target, text) VALUES (?,?,?)",
                (note_id, normalize_for_fts(target), normalize_for_fts(text)))
            return note_id

    def update_note(self, note_id: int, text: str, sentiment: str | None = None) -> bool:
        with self.write_txn() as db:
            row = db.execute("SELECT target, sentiment FROM notes WHERE id = ?",
                             (note_id,)).fetchone()
            if row is None:
                return False
            db.execute("UPDATE notes SET text = ?, sentiment = ? WHERE id = ?",
                       (text, sentiment or row[1], note_id))
            db.execute("UPDATE notes_fts SET text = ? WHERE note_id = ?",
                       (normalize_for_fts(text), note_id))
            return True

    def remove_note(self, note_id: int) -> bool:
        with self.write_txn() as db:
            cur = db.execute("DELETE FROM notes WHERE id = ?", (note_id,))
            db.execute("DELETE FROM notes_fts WHERE note_id = ?", (note_id,))
            return cur.rowcount > 0

    def notes_for(self, target: str | None = None) -> list[tuple[int, str, str, str]]:
        if target:
            return list(self._read_db().execute(
                "SELECT id, target, text, sentiment FROM notes WHERE target = ? "
                "ORDER BY created_at DESC", (target,)))
        return list(self._read_db().execute(
            "SELECT id, target, text, sentiment FROM notes ORDER BY created_at DESC"))

    def note_mentions(self, words: Iterable[str]) -> dict[str, int]:
        """Map of note target -> mention count for any of the words (used for
        the note score boost)."""
        out: dict[str, int] = {}
        # fast path: no notes at all (the common case) — skip the FTS round
        # trip every search would otherwise pay; cache keyed on generation
        gen = self.generation
        if self._note_count_cache is None or self._note_count_cache[0] != gen:
            try:
                n = self._read_db().execute("SELECT COUNT(*) FROM notes").fetchone()[0]
            except sqlite3.OperationalError:
                n = 0
            self._note_count_cache = (gen, int(n))
        if self._note_count_cache[1] == 0:
            return out
        terms = [t for w in words for t in normalize_for_fts(w).split()]
        if not terms:
            return out
        match = " OR ".join(f'"{t}"' for t in terms)
        try:
            for (target,) in self._read_db().execute(
                    "SELECT target FROM notes_fts WHERE notes_fts MATCH ?", (match,)):
                out[target] = out.get(target, 0) + 1
        except sqlite3.OperationalError:
            pass
        return out

    # -- summaries ---------------------------------------------------------

    def put_summary(self, chunk_id: str, summary: str | None, hyde: str | None,
                    model: str = "") -> None:
        with self.write_txn() as db:
            db.execute(
                "INSERT OR REPLACE INTO llm_summaries (chunk_id, summary, hyde, model) "
                "VALUES (?,?,?,?)", (chunk_id, summary, hyde, model))

    def get_summaries(self) -> dict[str, tuple[str | None, str | None]]:
        return {r[0]: (r[1], r[2]) for r in self._read_db().execute(
            "SELECT chunk_id, summary, hyde FROM llm_summaries")}

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        c = self._read_db()
        return {
            "chunks": self.chunk_count(),
            "files": c.execute("SELECT COUNT(*) FROM file_registry").fetchone()[0],
            "embedded": c.execute(
                "SELECT COUNT(*) FROM chunks WHERE embedding IS NOT NULL").fetchone()[0],
            "sparse": c.execute("SELECT COUNT(*) FROM sparse_vectors").fetchone()[0],
            "calls": c.execute("SELECT COUNT(*) FROM function_calls").fetchone()[0],
            "notes": c.execute("SELECT COUNT(*) FROM notes").fetchone()[0],
            "languages": dict(c.execute(
                "SELECT language, COUNT(*) FROM chunks GROUP BY language ORDER BY 2 DESC")),
            "generation": self.generation,
            "schema_version": int(self.get_meta("schema_version", "0") or 0),
        }
