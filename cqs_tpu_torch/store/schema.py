"""SQLite schema for the metadata store.

Reference analog: ``src/schema.sql`` (schema v32: 12 tables incl. FTS5, call
graph, type edges, notes with sentiment grid, sparse_vectors with the
generation-bump delete trigger). Embeddings here are canonical ground truth
(f32 LE BLOBs, like the reference); the *device* dense index is a separate
padded artifact built from these rows (see ``cqs_tpu/index/dense.py``) — the
TPU-native replacement for the reference's HNSW files.

``splade_generation`` is bumped by a delete trigger on chunks so sparse/dense
index artifacts can detect staleness exactly like the reference's
``src/schema.sql:268-283`` trigger.
"""

SCHEMA_VERSION = 3

SCHEMA = r"""
CREATE TABLE IF NOT EXISTS metadata (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS chunks (
    rowid           INTEGER PRIMARY KEY,
    id              TEXT NOT NULL UNIQUE,       -- {origin}:{line_start}:{body_hash}
    origin          TEXT NOT NULL,
    name            TEXT NOT NULL,
    parent_name     TEXT,
    chunk_type      TEXT NOT NULL,
    language        TEXT NOT NULL,
    line_start      INTEGER NOT NULL,
    line_end        INTEGER NOT NULL,
    signature       TEXT NOT NULL DEFAULT '',
    doc             TEXT NOT NULL DEFAULT '',
    body            TEXT NOT NULL,
    body_hash       TEXT NOT NULL,
    canonical_hash  TEXT NOT NULL,
    return_type     TEXT,
    is_test         INTEGER NOT NULL DEFAULT 0,
    parent_id       TEXT,                        -- window chunks: parent chunk id
    window_idx      INTEGER,
    nl              TEXT NOT NULL DEFAULT '',    -- enriched NL (what embeds)
    nl_base         TEXT NOT NULL DEFAULT '',    -- base NL (dual-index leg)
    embedding       BLOB,                        -- f32 LE, enriched NL embedding
    embedding_base  BLOB,                        -- f32 LE, base NL embedding
    needs_embedding INTEGER NOT NULL DEFAULT 1,
    enrichment_hash TEXT,                        -- idempotence for the 2nd pass
    parser_version  INTEGER NOT NULL DEFAULT 0,
    umap_x          REAL,
    umap_y          REAL
);
CREATE INDEX IF NOT EXISTS idx_chunks_origin ON chunks(origin);
CREATE INDEX IF NOT EXISTS idx_chunks_name ON chunks(name);
CREATE INDEX IF NOT EXISTS idx_chunks_canonical ON chunks(canonical_hash);
CREATE INDEX IF NOT EXISTS idx_chunks_parent_id ON chunks(parent_id);

CREATE VIRTUAL TABLE IF NOT EXISTS chunks_fts USING fts5(
    id UNINDEXED, name_norm, nl_norm, doc_norm,
    tokenize='unicode61'
);

-- BM25-over-code leg (ref indexes signature+content in the same table,
-- src/schema.sql:149-156; kept SEPARATE here so code-token document
-- frequencies cannot perturb the name/NL leg's IDF)
CREATE VIRTUAL TABLE IF NOT EXISTS chunks_fts_body USING fts5(
    id UNINDEXED, sig_norm, body_norm,
    tokenize='unicode61'
);

CREATE TABLE IF NOT EXISTS file_registry (
    origin         TEXT PRIMARY KEY,
    mtime_ns       INTEGER NOT NULL,
    size           INTEGER NOT NULL,
    digest         TEXT NOT NULL,
    chunk_count    INTEGER NOT NULL DEFAULT 0,
    parse_errors   TEXT,
    parser_version INTEGER NOT NULL DEFAULT 0,
    fail_count     INTEGER NOT NULL DEFAULT 0   -- drift-requeue loop breaker
);

CREATE TABLE IF NOT EXISTS function_calls (
    caller_id   TEXT NOT NULL,
    callee_name TEXT NOT NULL,
    line        INTEGER NOT NULL,
    kind        TEXT NOT NULL DEFAULT 'call',
    receiver    TEXT,
    FOREIGN KEY (caller_id) REFERENCES chunks(id) ON DELETE CASCADE
);
CREATE INDEX IF NOT EXISTS idx_calls_caller ON function_calls(caller_id);
CREATE INDEX IF NOT EXISTS idx_calls_callee ON function_calls(callee_name);

CREATE TABLE IF NOT EXISTS type_edges (
    chunk_id  TEXT NOT NULL,
    type_name TEXT NOT NULL,
    role      TEXT NOT NULL DEFAULT 'use',
    line      INTEGER NOT NULL,
    FOREIGN KEY (chunk_id) REFERENCES chunks(id) ON DELETE CASCADE
);
CREATE INDEX IF NOT EXISTS idx_type_edges_name ON type_edges(type_name);

CREATE TABLE IF NOT EXISTS sparse_vectors (
    chunk_id  TEXT PRIMARY KEY,
    token_ids BLOB NOT NULL,     -- int32 LE
    weights   BLOB NOT NULL,     -- f32 LE
    nnz       INTEGER NOT NULL,
    FOREIGN KEY (chunk_id) REFERENCES chunks(id) ON DELETE CASCADE
);

CREATE TABLE IF NOT EXISTS notes (
    id         INTEGER PRIMARY KEY,
    target     TEXT NOT NULL,            -- chunk name / path the note is about
    text       TEXT NOT NULL,
    sentiment  TEXT NOT NULL DEFAULT 'neutral'
        CHECK (sentiment IN ('positive','negative','neutral','warning','todo')),
    created_at REAL NOT NULL
);
CREATE VIRTUAL TABLE IF NOT EXISTS notes_fts USING fts5(
    note_id UNINDEXED, target, text, tokenize='unicode61'
);

CREATE TABLE IF NOT EXISTS llm_summaries (
    chunk_id TEXT PRIMARY KEY,
    summary  TEXT,
    hyde     TEXT,
    model    TEXT,
    FOREIGN KEY (chunk_id) REFERENCES chunks(id) ON DELETE CASCADE
);

-- Bump the generation counter on any chunk delete so persisted index
-- artifacts (dense npz / splade npz) can detect staleness.
CREATE TRIGGER IF NOT EXISTS chunks_delete_generation
AFTER DELETE ON chunks
BEGIN
    INSERT INTO metadata(key, value) VALUES ('splade_generation', '1')
    ON CONFLICT(key) DO UPDATE SET value = CAST(CAST(value AS INTEGER) + 1 AS TEXT);
END;
"""

CACHE_SCHEMA = r"""
CREATE TABLE IF NOT EXISTS embedding_cache (
    canonical_hash    TEXT NOT NULL,
    model_fingerprint TEXT NOT NULL,
    embedding         BLOB NOT NULL,
    created_at        REAL NOT NULL,
    last_used_at      REAL NOT NULL,
    PRIMARY KEY (canonical_hash, model_fingerprint)
);

CREATE TABLE IF NOT EXISTS query_cache (
    query_text        TEXT NOT NULL,
    model_fingerprint TEXT NOT NULL,
    embedding         BLOB NOT NULL,
    created_at        REAL NOT NULL,
    last_used_at      REAL NOT NULL,
    PRIMARY KEY (query_text, model_fingerprint)
);
"""
