"""Quality analyses: health report, structural patterns, semantic diff, drift.

Reference analogs: ``src/health.rs`` (stats+stale+hotspots+dead+notes
composite), ``src/structural.rs`` (error-swallow/async/mutex/unsafe matchers
per language), ``src/diff.rs`` (embedding-distance diff of two versions),
``src/drift.rs`` (doc-vs-code drift detection).
"""

from __future__ import annotations

import re
from collections import Counter
from pathlib import Path

import numpy as np

from cqs_tpu_torch.analysis.callgraph import find_dead_code
from cqs_tpu_torch.store import Store

# ---------------------------------------------------------------------------
# structural patterns
# ---------------------------------------------------------------------------

_STRUCTURAL_PATTERNS: dict[str, list[tuple[str, re.Pattern]]] = {
    "python": [
        ("error_swallow", re.compile(r"except[^\n:]*:\s*\n\s*pass\b")),
        ("bare_except", re.compile(r"except\s*:")),
        ("mutable_default", re.compile(r"def \w+\([^)]*=\s*(\[\]|\{\})")),
        ("blocking_in_async", re.compile(r"async def[\s\S]{0,400}?\btime\.sleep\(")),
    ],
    "rust": [
        ("unwrap_chain", re.compile(r"\.unwrap\(\)[\s\S]{0,40}\.unwrap\(\)")),
        ("error_swallow", re.compile(r"\.ok\(\);|let _ =.*\?;|unwrap_or_default\(\)")),
        ("unsafe_block", re.compile(r"\bunsafe\s*\{")),
        ("lock_unwrap", re.compile(r"\.lock\(\)\s*\.unwrap\(\)")),
    ],
    "go": [
        ("error_swallow", re.compile(r"_\s*=\s*err|if err != nil\s*\{\s*\}")),
        ("ignored_error", re.compile(r",\s*_\s*:?=\s*\w+\(")),
    ],
    "javascript": [
        ("error_swallow", re.compile(r"catch\s*(\([^)]*\))?\s*\{\s*\}")),
        ("promise_no_catch", re.compile(r"\.then\([^)]*\)(?!\s*\.catch)")),
    ],
    "typescript": [
        ("error_swallow", re.compile(r"catch\s*(\([^)]*\))?\s*\{\s*\}")),
        ("any_cast", re.compile(r"as any\b")),
    ],
    "java": [
        ("error_swallow", re.compile(r"catch\s*\([^)]+\)\s*\{\s*\}")),
        ("sync_method", re.compile(r"\bsynchronized\b")),
    ],
}


# The reference's named structural patterns (src/structural.rs:80-87:
# builder / error_swallow / async / mutex / unsafe / recursion) — usable as
# a `search --pattern` filter and through `structural --pattern`. Generic
# heuristics with language awareness, mirroring its matches_* fallbacks.

def _m_builder(body: str, name: str, lang: str) -> bool:
    return ("-> Self" in body or "-> &Self" in body or "-> &mut Self" in body
            or "return self" in body or "return this" in body
            or (".set" in body and "return" in body))


def _m_error_swallow(body: str, name: str, lang: str) -> bool:
    pats = {
        "python": r"except[^\n:]*:\s*\n\s*pass\b",
        "rust": r"\.ok\(\);|let _ =.*\?;|unwrap_or_default\(\)",
        "go": r"_\s*=\s*err|if err != nil\s*\{\s*\}",
    }
    rx = pats.get(lang, r"catch\s*(\([^)]*\))?\s*\{\s*\}")
    return re.search(rx, body) is not None


def _m_async(body: str, name: str, lang: str) -> bool:
    return re.search(r"\basync\b|\bawait\b|\.then\(|Promise\.|tokio::|"
                     r"asyncio\.", body) is not None


def _m_mutex(body: str, name: str, lang: str) -> bool:
    return re.search(r"\bMutex\b|\bRwLock\b|\.lock\(\)|threading\.Lock|"
                     r"sync\.Mutex|synchronized\b|ReentrantLock", body) is not None


def _m_unsafe(body: str, name: str, lang: str) -> bool:
    return re.search(r"\bunsafe\b", body) is not None


def _m_recursion(body: str, name: str, lang: str) -> bool:
    base = name.rsplit(".", 1)[-1].split("#w")[0]
    if not base:
        return False
    # the first `foo(` match is usually the definition header — require a
    # second call-pattern match. Assigned/arrow functions (`const foo = (n)
    # => ... foo(n-1)`) have no `foo(` in their header, so one call-pattern
    # match plus an assignment-shaped header already proves recursion.
    calls = len(re.findall(rf"\b{re.escape(base)}\s*\(", body))
    if calls >= 2:
        return True
    header = body.split("\n", 1)[0]
    return calls == 1 and re.search(rf"\b{re.escape(base)}\s*=", header) is not None


NAMED_PATTERNS = {
    "builder": _m_builder,
    "error_swallow": _m_error_swallow,
    "async": _m_async,
    "mutex": _m_mutex,
    "unsafe": _m_unsafe,
    "recursion": _m_recursion,
}


def match_pattern(pattern: str, body: str, name: str, language: str) -> bool:
    """True when the chunk matches the named structural pattern (aliases:
    error-swallow == error_swallow, as in the reference)."""
    fn = NAMED_PATTERNS.get(pattern.replace("-", "_"))
    return bool(fn and fn(body or "", name or "", language or ""))


def structural_scan(store: Store, pattern_filter: str | None = None) -> list[dict]:
    out: list[dict] = []
    named = (pattern_filter or "").replace("-", "_")
    use_named = named in NAMED_PATTERNS
    for row in store.iter_chunks("chunk_type IN ('function','method','test')"):
        if use_named:
            if match_pattern(named, row.body, row.name, row.language):
                out.append({"pattern": named, "name": row.qualified_name,
                            "origin": row.origin, "line": row.line_start})
            continue
        patterns = _STRUCTURAL_PATTERNS.get(row.language, [])
        for name, rx in patterns:
            if pattern_filter and pattern_filter != name:
                continue
            m = rx.search(row.body)
            if m:
                line = row.line_start + row.body[: m.start()].count("\n")
                out.append({"pattern": name, "name": row.qualified_name,
                            "origin": row.origin, "line": line})
    return out


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

def health_report(store: Store, root: Path) -> dict:
    import os

    stats = store.stats()
    stale = []
    for origin, fp in store.registered_origins().items():
        try:
            st = os.stat(root / origin)
            if not fp.matches_stat(st):
                stale.append(origin)
        except OSError:
            stale.append(origin)
    hotspots = store._read_db().execute(
        "SELECT callee_name, COUNT(DISTINCT caller_id) AS n FROM function_calls "
        "GROUP BY callee_name ORDER BY n DESC LIMIT 10").fetchall()
    dead = find_dead_code(store)
    notes = store.notes_for()
    warnings = [n for n in notes if n[3] in ("warning", "negative", "todo")]
    errors = store._read_db().execute(
        "SELECT origin, parse_errors FROM file_registry WHERE parse_errors IS NOT NULL"
    ).fetchall()
    return {
        "stats": stats,
        "stale_files": stale[:20],
        "stale_count": len(stale),
        "hotspots": [{"name": n, "callers": c} for n, c in hotspots],
        "dead_count": len(dead),
        "dead_top": dead[:10],
        "open_notes": [{"target": t, "text": x, "sentiment": s}
                       for _, t, x, s in warnings[:10]],
        "parse_error_files": [o for o, _ in errors],
    }


# ---------------------------------------------------------------------------
# semantic diff + drift
# ---------------------------------------------------------------------------

def semantic_diff(store_a: Store, store_b: Store, threshold: float = 0.15) -> list[dict]:
    """Embedding-distance diff of two indexed versions: which functions moved
    semantically (vs just textually)?"""
    ids_a, mat_a = store_a.load_embeddings()
    ids_b, mat_b = store_b.load_embeddings()
    key_a = {}
    for i, cid in enumerate(ids_a):
        row = store_a.get_chunk(cid)
        if row:
            key_a[(row.origin, row.qualified_name)] = i
    out = []
    for j, cid in enumerate(ids_b):
        row = store_b.get_chunk(cid)
        if row is None:
            continue
        key = (row.origin, row.qualified_name)
        i = key_a.get(key)
        if i is None:
            out.append({"name": row.qualified_name, "origin": row.origin,
                        "change": "added", "distance": 1.0})
            continue
        a = mat_a[i] / max(np.linalg.norm(mat_a[i]), 1e-12)
        b = mat_b[j] / max(np.linalg.norm(mat_b[j]), 1e-12)
        dist = float(1.0 - a @ b)
        if dist > threshold:
            out.append({"name": row.qualified_name, "origin": row.origin,
                        "change": "semantic_shift", "distance": round(dist, 4)})
        seen = key_a.pop(key, None)
    for (origin, name), _ in key_a.items():
        out.append({"name": name, "origin": origin, "change": "removed", "distance": 1.0})
    out.sort(key=lambda d: -d["distance"])
    return out


def drift_report(store: Store, embedder, threshold: float = 0.55) -> list[dict]:
    """Doc-vs-code drift: chunks whose doc comment no longer matches what the
    code does (doc embedding far from body embedding)."""
    candidates = [r for r in store.iter_chunks(
        "chunk_type IN ('function','method') AND doc != ''")
        if len(r.doc) > 40]
    if not candidates:
        return []
    doc_vecs = embedder.embed_documents([r.doc for r in candidates])
    body_vecs = embedder.embed_documents([r.body[:2000] for r in candidates])
    sims = (doc_vecs * body_vecs).sum(axis=1)
    out = []
    for r, s in zip(candidates, sims):
        if s < threshold:
            out.append({"name": r.qualified_name, "origin": r.origin,
                        "line_start": r.line_start, "doc_code_sim": round(float(s), 4)})
    out.sort(key=lambda d: d["doc_code_sim"])
    return out
