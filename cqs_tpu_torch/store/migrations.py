"""Schema migrations: ordered, idempotent, backup-gated.

Reference analog: ``src/store/migrations.rs`` (the v1 -> v32 chain; each step
is a function, applied in order inside one transaction per step, with an
optional pre-migration backup and legacy-layout moves).

Adding a migration:
  1. bump ``SCHEMA_VERSION`` in ``schema.py``
  2. append ``@migration(N)`` with the DDL/data transform from N-1 to N
New stores are created at the CURRENT schema (schema.py), so migrations only
run for stores created by older builds.
"""

from __future__ import annotations

import shutil
import sqlite3
from pathlib import Path
from typing import Callable

from cqs_tpu_torch.store.schema import SCHEMA_VERSION
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("migrations")

_MIGRATIONS: dict[int, Callable[[sqlite3.Connection], None]] = {}


def migration(to_version: int):
    def wrap(fn):
        assert to_version not in _MIGRATIONS, f"duplicate migration {to_version}"
        _MIGRATIONS[to_version] = fn
        return fn
    return wrap


class MigrationError(Exception):
    pass


def current_version(db: sqlite3.Connection) -> int:
    try:
        row = db.execute("SELECT value FROM metadata WHERE key = 'schema_version'").fetchone()
        return int(row[0]) if row else 0
    except sqlite3.OperationalError:
        return 0


def migrate(db: sqlite3.Connection, db_path: str | Path | None = None,
            backup: bool = True) -> int:
    """Bring the store to SCHEMA_VERSION. Returns steps applied."""
    v = current_version(db)
    if v >= SCHEMA_VERSION:
        return 0
    if v == 0:
        # fresh/pre-metadata store: schema.py DDL owns creation
        return 0
    missing = [step for step in range(v + 1, SCHEMA_VERSION + 1)
               if step not in _MIGRATIONS]
    if missing:
        raise MigrationError(
            f"no migration path for steps {missing} (store v{v} -> v{SCHEMA_VERSION})")
    if backup and db_path is not None:
        src = Path(db_path)
        if src.exists():
            dst = src.with_suffix(f".v{v}.bak")
            if not dst.exists():
                shutil.copy2(src, dst)
                log.info("migration backup: %s", dst)
    applied = 0
    for step in range(v + 1, SCHEMA_VERSION + 1):
        fn = _MIGRATIONS[step]
        log.info("migrating store v%d -> v%d (%s)", step - 1, step, fn.__name__)
        try:
            db.execute("BEGIN IMMEDIATE")
            fn(db)
            db.execute(
                "UPDATE metadata SET value = ? WHERE key = 'schema_version'", (str(step),))
            db.commit()
            applied += 1
        except Exception as e:
            db.rollback()
            raise MigrationError(f"migration to v{step} failed: {e}") from e
    return applied


# --------------------------------------------------------------------------
# The chain. v1 is the initial schema (schema.py).
# --------------------------------------------------------------------------


@migration(2)
def _v2_fts_body_leg(db: sqlite3.Connection) -> None:
    """Adds the BM25-over-code leg: a SEPARATE chunks_fts_body FTS table over
    signature + body (the reference indexes signature/content in its FTS,
    src/schema.sql:149-156; separate here so code-token document frequencies
    cannot perturb the name/NL leg's IDF). No re-embed required."""
    from cqs_tpu_torch.utils.text import normalize_for_fts

    db.execute("DROP TABLE IF EXISTS chunks_fts_body")
    db.execute(
        "CREATE VIRTUAL TABLE chunks_fts_body USING fts5("
        "id UNINDEXED, sig_norm, body_norm, tokenize='unicode61')")
    rows = db.execute("SELECT id, signature, body FROM chunks").fetchall()
    for cid, sig, body in rows:
        db.execute(
            "INSERT INTO chunks_fts_body (id, sig_norm, body_norm) VALUES (?,?,?)",
            (cid, normalize_for_fts(sig or ""), normalize_for_fts((body or "")[:8000])))


@migration(3)
def _v3_fts_rowid_alignment(db: sqlite3.Connection) -> None:
    """Aligns both FTS tables' rowids with chunks.rowid so per-row FTS
    deletes address by rowid (O(log N)) instead of the UNINDEXED id column
    (a full FTS scan per delete — O(N^2) across a reindex)."""
    from cqs_tpu_torch.utils.text import normalize_for_fts

    for tbl in ("chunks_fts", "chunks_fts_body"):
        db.execute(f"DROP TABLE IF EXISTS {tbl}")
        db.execute(f"DROP TABLE IF EXISTS {tbl}_vocab")
    db.execute(
        "CREATE VIRTUAL TABLE chunks_fts USING fts5("
        "id UNINDEXED, name_norm, nl_norm, doc_norm, tokenize='unicode61')")
    db.execute(
        "CREATE VIRTUAL TABLE chunks_fts_body USING fts5("
        "id UNINDEXED, sig_norm, body_norm, tokenize='unicode61')")
    rows = db.execute(
        "SELECT rowid, id, parent_name, name, nl, doc, signature, body "
        "FROM chunks").fetchall()
    for rowid, cid, pname, name, nl, doc, sig, body in rows:
        qual = f"{pname}.{name}" if pname else name
        db.execute(
            "INSERT INTO chunks_fts (rowid, id, name_norm, nl_norm, doc_norm) "
            "VALUES (?,?,?,?,?)",
            (rowid, cid, normalize_for_fts(qual or ""),
             normalize_for_fts(nl or name or ""), normalize_for_fts(doc or "")))
        db.execute(
            "INSERT INTO chunks_fts_body (rowid, id, sig_norm, body_norm) "
            "VALUES (?,?,?,?)",
            (rowid, cid, normalize_for_fts(sig or ""),
             normalize_for_fts((body or "")[:8000])))
