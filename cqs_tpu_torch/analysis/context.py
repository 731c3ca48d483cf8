"""Context-assembly commands: scout, task, onboard, where-to-add, related,
suggest, plan, kind routing.

Reference analogs: ``src/scout.rs`` (pre-investigation dashboard),
``src/task.rs`` (scout+gather+impact+placement composite), ``src/onboard.rs``
(repo tour), ``src/where_to_add.rs`` (placement suggestion), ``src/related.rs``
(related-function finder), ``src/suggest.rs`` (refactor suggestions),
``src/plan.rs`` (task template -> checklist), ``src/kind.rs`` (bare-name kind
classification for polymorphic command routing).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

from cqs_tpu_torch.analysis.callgraph import CallGraph, analyze_impact
from cqs_tpu_torch.analysis.gather import gather
from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.parser.types import ChunkType
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.utils.text import tokenize_identifier

# ---------------------------------------------------------------------------
# kind routing
# ---------------------------------------------------------------------------

_TYPE_KINDS = {"class", "struct", "enum", "trait", "type_alias"}


def classify_kind(store: Store, name: str) -> str:
    """Classify a bare name against the corpus: function | type | const |
    module | unknown (ref: src/kind.rs — lets `callers`/`deps` auto-switch)."""
    rows = store.find_by_name(name)
    if not rows:
        # type_edges may know it even if we don't index its definition
        if store.type_users(name):
            return "type"
        return "unknown"
    counts = Counter(
        "type" if r.chunk_type in _TYPE_KINDS
        else "module" if r.chunk_type == "module"
        else "const" if r.chunk_type == "const"
        else "function"
        for r in rows)
    return counts.most_common(1)[0][0]


# ---------------------------------------------------------------------------
# scout
# ---------------------------------------------------------------------------

#: Minimum relative gap between consecutive scores to split ModifyTarget from
#: Dependency (ref: src/scout.rs MIN_GAP_RATIO). Below this, all non-test
#: chunks cluster together and only the top result is a modify target.
_SCOUT_GAP_RATIO = 0.10


def _scout_roles(hits) -> dict[str, str]:
    """Role classification by score-gap clustering (ref: ScoutChunk.role):
    test chunks -> test_coverage; the head cluster above the first >=10%
    relative score gap -> modify_target; the rest -> dependency."""
    roles: dict[str, str] = {}
    scored = [(h.row.id, h.score) for h in hits if not h.row.is_test]
    for h in hits:
        if h.row.is_test:
            roles[h.row.id] = "test_coverage"
    split = 1
    for i in range(1, len(scored)):
        prev, cur = scored[i - 1][1], scored[i][1]
        if prev > 0 and (prev - cur) / prev >= _SCOUT_GAP_RATIO:
            split = i
            break
    else:
        split = 1 if scored else 0
    for i, (cid, _) in enumerate(scored):
        roles[cid] = "modify_target" if i < split else "dependency"
    return roles


def scout(engine, query: str, limit: int = 8) -> dict:
    """Pre-investigation dashboard (ref: src/scout.rs ScoutResult): top
    chunks with ROLE classification (modify_target / dependency /
    test_coverage by score-gap clustering), caller and reaching-test counts,
    file groups with aggregate relevance + staleness, key types, entry
    paths, notes, and a summary."""
    store: Store = engine.store
    res = engine.search(query, limit=limit * 2)
    hits = [h for h in res.hits if h.score >= 0.0]
    files = Counter(h.row.origin for h in hits)
    types_used: Counter[str] = Counter()
    for h in hits[:limit]:
        for (tname,) in store._read_db().execute(
                "SELECT type_name FROM type_edges WHERE chunk_id = ?", (h.row.id,)):
            types_used[tname] += 1
    graph = CallGraph.for_store(store)
    roles = _scout_roles(hits[:limit])
    entry_hits = []
    chunk_rows = []
    for h in hits[:limit]:
        dist = graph.bfs(h.row.id, reverse=True, depth=4, node_cap=50)
        roots = [cid for cid in dist if cid not in graph.rev or not graph.rev.get(cid)]
        for cid in roots[:2]:
            row = store.get_chunk(cid)
            if row:
                entry_hits.append({"entry": row.qualified_name, "origin": row.origin,
                                   "reaches": h.row.qualified_name})
        test_count = 0
        for cid in dist:
            r = store.get_chunk(cid)
            if r is not None and r.is_test:
                test_count += 1
        d = h.to_dict()
        d["role"] = roles.get(h.row.id, "dependency")
        d["caller_count"] = len(graph.rev.get(h.row.id, ()))
        d["test_count"] = test_count
        chunk_rows.append((h, d))
    # file groups with aggregate relevance + staleness (ref: FileGroup)
    stale_origins: set[str] = set()
    if engine.root is not None:
        import os as _os

        for origin, fp in store.registered_origins().items():
            if origin not in files:
                continue
            try:
                if not fp.matches_stat(_os.stat(engine.root / origin)):
                    from cqs_tpu_torch.utils.hashing import fingerprint_file

                    if fingerprint_file(engine.root / origin).digest != fp.digest:
                        stale_origins.add(origin)
            except OSError:
                stale_origins.add(origin)
    groups: dict[str, dict] = {}
    for h, d in chunk_rows:
        g = groups.setdefault(h.row.origin, {
            "file": h.row.origin, "relevance_score": 0.0,
            "is_stale": h.row.origin in stale_origins, "chunks": []})
        g["relevance_score"] = round(g["relevance_score"] + h.score, 4)
        g["chunks"].append(d)
    file_groups = sorted(groups.values(), key=lambda g: -g["relevance_score"])
    untested = sum(1 for _, d in chunk_rows
                   if d["test_count"] == 0 and d["role"] != "test_coverage")
    notes = store.note_mentions(query.split())
    return {
        "query": query,
        "top_chunks": [d for _, d in chunk_rows],
        "file_groups": file_groups,
        "files": [{"origin": o, "hits": c} for o, c in files.most_common(8)],
        "key_types": [{"type": t, "uses": c} for t, c in types_used.most_common(8)],
        "entry_paths": entry_hits[:8],
        "notes": [{"target": t, "mentions": c} for t, c in notes.items()],
        "summary": {
            "total_files": len(files),
            "total_functions": len(chunk_rows),
            "untested_count": untested,
            "stale_count": len(stale_origins),
        },
    }


# ---------------------------------------------------------------------------
# where-to-add (placement)
# ---------------------------------------------------------------------------

_IMPORT_PREFIXES = ("use ", "import ", "from ", "require(", "#include", "using ")


def _local_patterns(store: Store, origin: str, max_imports: int = 5) -> dict:
    """The file's local conventions for the new code to follow (ref:
    where_to_add.rs LocalPatterns): imports, error-handling style, naming
    convention, visibility, inline tests."""
    bodies, names, has_test = [], [], False
    for r in store.iter_chunks("origin = ?", (origin,)):
        bodies.append(r.body or "")
        if r.chunk_type in ("function", "method"):
            names.append(r.name)
        has_test = has_test or bool(r.is_test)
    text = "\n".join(bodies)
    imports: list[str] = []
    for ln in text.splitlines():
        st = ln.strip()
        if st.startswith(_IMPORT_PREFIXES) and st not in imports:
            imports.append(st)
            if len(imports) >= max_imports:
                break
    err = ""
    for marker, label in (("anyhow", "anyhow"), ("thiserror", "thiserror"),
                          ("Result<", "Result<>"), ("except ", "try/except"),
                          ("catch (", "try/catch"), ("catch(", "try/catch"),
                          ("if err != nil", "err != nil")):
        if marker in text:
            err = label
            break
    snake = sum(1 for n in names if "_" in n or n.islower())
    pascal = sum(1 for n in names if n[:1].isupper())
    camel = len(names) - snake - pascal
    naming = ("snake_case" if snake >= max(camel, pascal)
              else "PascalCase" if pascal >= camel else "camelCase") if names else ""
    pub = text.count("pub fn") + text.count("pub struct") + text.count("public ")
    crate = text.count("pub(crate)")
    vis = ("pub(crate)" if crate > pub else "pub") if (pub or crate) else "private"
    return {"imports": imports, "error_handling": err,
            "naming_convention": naming, "visibility": vis,
            "has_inline_tests": has_test or "#[cfg(test)]" in text}


def suggest_placement(engine, description: str, limit: int = 5) -> list[dict]:
    """Where should new functionality live? (ref: src/where_to_add.rs
    FileSuggestion) — rank files by semantic affinity, suggest an insertion
    point after the best-matching chunk, and report the file's local
    patterns (imports, error style, naming, visibility, inline tests)."""
    res = engine.search(description, limit=30)
    by_file: dict[str, list] = defaultdict(list)
    for h in res.hits:
        by_file[h.row.origin].append(h)
    ranked = sorted(by_file.items(),
                    key=lambda kv: -(sum(h.score for h in kv[1]) + 0.1 * len(kv[1])))
    store = engine.store
    out = []
    for origin, hs in ranked[:limit]:
        best = max(hs, key=lambda h: h.score)
        scores = [h.score for h in hs]
        reason = (f"{len(hs)} related chunk(s); strongest match "
                  f"'{best.row.qualified_name}' (score {best.score:.3f})")
        out.append({
            "origin": origin,
            "language": best.row.language,
            "affinity": round(sum(scores), 4),
            "matching_chunks": len(scores),
            # insert right after the nearest related function, not at EOF
            "insertion_line": best.row.line_end + 1,
            "near_function": best.row.qualified_name,
            "append_after_line": store._read_db().execute(
                "SELECT MAX(line_end) FROM chunks WHERE origin = ?",
                (origin,)).fetchone()[0] or 0,
            "reason": reason,
            "patterns": _local_patterns(store, origin),
        })
    return out


# ---------------------------------------------------------------------------
# related
# ---------------------------------------------------------------------------

def find_related(store: Store, name: str, limit: int = 10) -> list[dict]:
    """Functions related by shared callees, shared callers, shared types, and
    name-token overlap (ref: src/related.rs — batch co-occurrence queries;
    common stdlib types are excluded from the type dimension via the
    per-language common_types registry, ref: src/focused_read.rs COMMON_TYPES).

    Three batched SQL aggregations instead of per-chunk probes: the previous
    per-row callees_of/callers_of/type scans cost ~3 SQL queries per corpus
    function (~26k queries on the reference corpus)."""
    from cqs_tpu_torch.parser.registry import get_language

    targets = store.find_by_name(name)
    if not targets:
        return []
    target = targets[0]
    t_base = target.name.split("#w")[0]
    db = store._read_db()

    def q(sql, params):
        return db.execute(sql, list(params)).fetchall()

    scores: dict[str, float] = {}
    reasons: dict[str, list[str]] = {}

    def add(cid: str, s: float, why: str):
        if cid == target.id:
            return
        scores[cid] = scores.get(cid, 0.0) + s
        reasons.setdefault(cid, []).append(why)

    # 1. shared callees: other callers of the functions the target calls.
    # Utility callees (Ok/Err/len/format — called from everywhere) relate
    # nothing: the same doc-frequency cutoff the NL enrichment uses
    # (callee_df_cutoff) drops them before the overlap count.
    from cqs_tpu_torch.config import limits as _limits

    (n_funcs,) = db.execute(
        "SELECT COUNT(*) FROM chunks WHERE chunk_type IN "
        "('function','method','test') AND parent_id IS NULL").fetchone()
    df_cap = max(2, int(_limits.callee_df_cutoff * max(n_funcs, 1)))
    t_callees = [c for (c, n) in q(
        "SELECT fc.callee_name, (SELECT COUNT(DISTINCT caller_id) FROM "
        "function_calls WHERE callee_name = fc.callee_name) "
        "FROM function_calls fc WHERE fc.caller_id = ? "
        "GROUP BY fc.callee_name", (target.id,)) if n <= df_cap]
    if t_callees:
        ph = ",".join("?" * len(t_callees))
        for cid, n, names in q(
                f"SELECT caller_id, COUNT(DISTINCT callee_name), "
                f"GROUP_CONCAT(DISTINCT callee_name) FROM function_calls "
                f"WHERE callee_name IN ({ph}) GROUP BY caller_id",
                t_callees):
            add(cid, 0.4 * min(n, 3),
                f"shares callees: {', '.join(sorted(names.split(','))[:3])}")

    # 2. shared callers: the other functions the target's callers also call
    t_caller_ids = [c.id for c, _, _ in store.callers_of(t_base)]
    if t_caller_ids:
        ph = ",".join("?" * len(t_caller_ids))
        sibling_names = [nm for (nm,) in q(
            f"SELECT DISTINCT callee_name FROM function_calls "
            f"WHERE caller_id IN ({ph})", t_caller_ids) if nm != t_base]
        if sibling_names:
            ph2 = ",".join("?" * len(sibling_names))
            for cid in [r[0] for r in q(
                    f"SELECT id FROM chunks WHERE name IN ({ph2}) "
                    f"AND chunk_type IN ('function','method')", sibling_names)]:
                add(cid, 0.5, "called from the same places")

    # 3. shared types — common stdlib types excluded (they'd relate most of
    # the codebase: String/Vec/Result in Rust, str/dict in Python)
    lang = get_language(target.language)
    common = lang.common_types if lang else frozenset()
    t_types = [t for (t,) in q(
        "SELECT DISTINCT type_name FROM type_edges WHERE chunk_id = ?",
        (target.id,)) if t not in common]
    if t_types:
        ph = ",".join("?" * len(t_types))
        for cid, n, names in q(
                f"SELECT chunk_id, COUNT(DISTINCT type_name), "
                f"GROUP_CONCAT(DISTINCT type_name) FROM type_edges "
                f"WHERE type_name IN ({ph}) GROUP BY chunk_id", t_types):
            add(cid, 0.3 * min(n, 3),
                f"shares types: {', '.join(sorted(names.split(','))[:3])}")

    # 4. name-token overlap over the current candidates only (cheap, avoids
    # a full-corpus tokenize pass; a name-only relation is weak by itself)
    t_tokens = set(tokenize_identifier(t_base))
    ranked_ids = [cid for cid, _ in
                  sorted(scores.items(), key=lambda kv: -kv[1])[: limit * 4]]
    rows = {r.id: r for r in store.get_chunks_by_ids(ranked_ids, meta_only=True)}
    for cid, row in rows.items():
        tok = t_tokens & set(tokenize_identifier(row.name))
        if tok:
            scores[cid] += 0.2 * len(tok)
            reasons[cid].append("similar name")

    out = []
    for cid, s in sorted(scores.items(), key=lambda kv: -kv[1]):
        row = rows.get(cid) or store.get_chunk(cid)
        if row is None or row.chunk_type not in ("function", "method", "test"):
            continue
        out.append({"name": row.qualified_name, "origin": row.origin,
                    "line_start": row.line_start, "score": round(s, 2),
                    "reasons": reasons[cid]})
        if len(out) >= limit:
            break
    return out


# ---------------------------------------------------------------------------
# suggest (refactor candidates)
# ---------------------------------------------------------------------------

def suggest_refactors(store: Store, limit: int = 20) -> list[dict]:
    """Refactor suggestions: oversized functions, high fan-out, duplicate
    bodies (canonical-hash collisions), wide files."""
    out: list[dict] = []
    for row in store.iter_chunks("chunk_type IN ('function','method')"):
        span = row.line_end - row.line_start + 1
        if span > 120:
            out.append({"kind": "long_function", "name": row.qualified_name,
                        "origin": row.origin, "line_start": row.line_start,
                        "detail": f"{span} lines — consider splitting"})
    fanout = Counter()
    for caller_id, in store._read_db().execute(
            "SELECT caller_id FROM function_calls"):
        fanout[caller_id] += 1
    for cid, n in fanout.most_common(10):
        if n >= 15:
            row = store.get_chunk(cid)
            if row:
                out.append({"kind": "high_fanout", "name": row.qualified_name,
                            "origin": row.origin, "line_start": row.line_start,
                            "detail": f"calls {n} distinct sites — high coupling"})
    dupes = store._read_db().execute(
        "SELECT canonical_hash, COUNT(*), GROUP_CONCAT(name) FROM chunks "
        "WHERE chunk_type IN ('function','method') AND LENGTH(body) > 120 "
        "GROUP BY canonical_hash HAVING COUNT(*) > 1").fetchall()
    for h, n, names in dupes:
        out.append({"kind": "duplicate_body", "name": names.split(",")[0],
                    "origin": "", "line_start": 0,
                    "detail": f"{n} identical bodies: {names}"})
    return out[:limit]


# ---------------------------------------------------------------------------
# onboard
# ---------------------------------------------------------------------------

def onboard(store: Store, limit: int = 10) -> dict:
    """Repo tour: language mix, biggest modules, entry points, most-called
    functions, key types, doc sections."""
    stats = store.stats()
    file_sizes = Counter()
    for (origin, n) in store._read_db().execute(
            "SELECT origin, COUNT(*) FROM chunks GROUP BY origin"):
        file_sizes[origin] = n
    most_called = store._read_db().execute(
        "SELECT callee_name, COUNT(DISTINCT caller_id) AS n FROM function_calls "
        "GROUP BY callee_name ORDER BY n DESC LIMIT ?", (limit,)).fetchall()
    key_types = store._read_db().execute(
        "SELECT type_name, COUNT(*) AS n FROM type_edges GROUP BY type_name "
        "ORDER BY n DESC LIMIT ?", (limit,)).fetchall()
    graph = CallGraph.for_store(store)
    # per-language entry-point registry (ref: LanguageDef entry points) —
    # a name is an entry when its OWN language declares it one and nothing
    # in the corpus calls it
    from cqs_tpu_torch.parser.registry import get_language

    entries = []
    for row in store.iter_chunks("chunk_type IN ('function','method')"):
        lang = get_language(row.language)
        lang_entries = lang.entry_points if lang else ("main",)
        if row.name in lang_entries and row.id not in graph.rev:
            entries.append({"name": row.qualified_name, "origin": row.origin,
                            "language": row.language})
    # HTTP/RPC endpoints: chunks whose body carries a language's endpoint
    # marker (ref: LanguageDef endpoint markers)
    endpoints = []
    langs_present = {r[0] for r in store._read_db().execute(
        "SELECT DISTINCT language FROM chunks")}
    for lname in sorted(langs_present):
        lang = get_language(lname)
        if not lang or not lang.endpoint_markers:
            continue
        conds = " OR ".join("body LIKE ?" for _ in lang.endpoint_markers)
        rows = store._read_db().execute(
            f"SELECT name, origin, line_start FROM chunks WHERE language = ? "
            f"AND chunk_type IN ('function','method') AND ({conds}) "
            f"ORDER BY origin, line_start LIMIT ?",
            (lname, *[f"%{m}%" for m in lang.endpoint_markers], limit * 2)).fetchall()
        endpoints += [{"name": n, "origin": o, "line": l, "language": lname}
                      for n, o, l in rows]
    docs = [{"name": r.name, "origin": r.origin}
            for r in store.iter_chunks("chunk_type = 'section'")][:limit]
    return {
        "stats": {k: stats[k] for k in ("chunks", "files", "languages")},
        "largest_files": [{"origin": o, "chunks": n} for o, n in file_sizes.most_common(limit)],
        "entry_points": entries[:limit],
        "endpoints": endpoints[:limit * 2],
        "most_called": [{"name": n, "callers": c} for n, c in most_called
                        if store.find_by_name(n)],
        "key_types": [{"type": t, "uses": n} for t, n in key_types],
        "docs": docs,
    }


def onboard_concept(engine, concept: str, depth: int = 3,
                    max_callees: int | None = None,
                    max_callers: int | None = None,
                    max_key_types: int | None = None,
                    direction: str = "callees") -> dict:
    """Guided tour of a CONCEPT: ordered reading list entry point -> call
    chain -> callers -> key types -> tests, with explicit truncation
    counters so a capped list is never read as complete (ref:
    src/onboard.rs:148 — scout, pick the top modify-target, BFS callees to
    depth, callers at depth 1, type deps through the COMMON_TYPES filter,
    tests via reverse BFS, summary block with *_truncated).

    ``direction`` picks which side of the call graph gets the full-depth
    BFS (ref onboard.rs:144-147): ``callees`` (default) walks what the
    entry calls with callers at depth 1; ``callers`` the reverse;
    ``both`` walks both sides at the requested depth."""
    if direction not in ("callees", "callers", "both"):
        raise ValueError(f"direction must be callees|callers|both, got {direction!r}")
    from cqs_tpu_torch.analysis.callgraph import analyze_impact
    from cqs_tpu_torch.parser.registry import get_language

    lim = default_limits
    max_callees = max_callees if max_callees is not None else lim.onboard_callee_fetch
    max_callers = max_callers if max_callers is not None else lim.onboard_caller_fetch
    max_key_types = max_key_types if max_key_types is not None else lim.onboard_key_types
    store: Store = engine.store
    res = engine.search(concept, limit=8)
    entry_hit = next((h for h in res.hits
                      if ChunkType(h.row.chunk_type).is_callable), None)
    if entry_hit is None:
        return {"concept": concept, "error": "no callable entry point found",
                "top_hits": [{"name": h.row.qualified_name, "origin": h.row.origin}
                             for h in res.hits[:5]]}
    entry = entry_hit.row
    graph = CallGraph.for_store(store)

    def _entry_dict(row, dist):
        return {"name": row.qualified_name, "origin": row.origin,
                "line": row.line_start, "depth": dist,
                "signature": row.signature}

    # callee chain: BFS to `depth` in discovery order (the reading order);
    # the non-favored side walks one hop only (ref onboard.rs direction)
    callee_depth = depth if direction in ("callees", "both") else 1
    caller_depth = depth if direction in ("callers", "both") else 1
    dist = graph.bfs(entry.id, reverse=False, depth=callee_depth)
    chain_ids = [cid for cid, d0 in sorted(dist.items(), key=lambda t: t[1])
                 if cid != entry.id]
    callees_truncated = max(0, len(chain_ids) - max_callees)
    chain_rows = {r.id: r for r in store.get_chunks_by_ids(
        chain_ids[:max_callees], meta_only=True)}
    call_chain = [_entry_dict(chain_rows[c], dist[c])
                  for c in chain_ids[:max_callees] if c in chain_rows]

    # callers: reverse BFS (depth 1 unless this side is the favored one)
    rdist = graph.bfs(entry.id, reverse=True, depth=caller_depth)
    caller_ids = [cid for cid, d0 in sorted(rdist.items(), key=lambda t: t[1])
                  if cid != entry.id]
    callers_truncated = max(0, len(caller_ids) - max_callers)
    caller_rows = {r.id: r for r in store.get_chunks_by_ids(
        caller_ids[:max_callers], meta_only=True)}
    callers = [_entry_dict(caller_rows[c], rdist[c])
               for c in caller_ids[:max_callers] if c in caller_rows]

    # key types used by the entry + chain, through the common-type filter
    scope_ids = [entry.id] + chain_ids[:max_callees]
    lang = get_language(entry.language)
    common = lang.common_types if lang else frozenset()
    type_counts = Counter()
    # chunked IN lists: full counts (no silent SQL cap — the summary's
    # key_types_truncated must be the only truncation) and safely under
    # SQLite's parameter limit for large max_callees
    for lo in range(0, len(scope_ids), 500):
        part = scope_ids[lo:lo + 500]
        q = ",".join("?" * len(part))
        for (tname,) in store._read_db().execute(
                f"SELECT type_name FROM type_edges WHERE chunk_id IN ({q})",
                part):
            if tname not in common:
                type_counts[tname] += 1
    types_all = type_counts.most_common()
    key_types_truncated = max(0, len(types_all) - max_key_types)
    key_types = [{"type": t, "uses": n} for t, n in types_all[:max_key_types]]

    rep = analyze_impact(store, entry.name.split(".")[-1], graph=graph)
    tests = [{"name": t.qualified_name, "origin": t.origin}
             for t in (rep.affected_tests if rep else [])][:20]

    files = {entry.origin} | {c["origin"] for c in call_chain} \
        | {c["origin"] for c in callers}
    out = {
        "concept": concept,
        "entry_point": _entry_dict(entry, 0),
        "call_chain": call_chain,
        "callers": callers,
        "key_types": key_types,
        "tests": tests,
        "summary": {
            "total_items": 1 + len(call_chain) + len(callers) + len(tests),
            "files_covered": len(files),
            "direction": direction,
            "callee_depth": callee_depth,
            "tests_found": len(tests),
            "callees_truncated": callees_truncated,
            "callers_truncated": callers_truncated,
            "key_types_truncated": key_types_truncated,
        },
    }
    return out


# ---------------------------------------------------------------------------
# brief
# ---------------------------------------------------------------------------

def brief_file(store: Store, path: str) -> dict:
    """One-line-per-function summary for a file: name, type, line, caller
    count, transitive test count (ref: ``cqs brief`` —
    src/cli/commands/io/brief.rs: chunks deduped by name, caller counts,
    test coverage via the same call-graph BFS as test-map)."""
    from cqs_tpu_torch.analysis.callgraph import test_map

    norm = path.replace("\\", "/")
    rows = list(store.iter_chunks("origin = ?", (norm,)))
    if not rows:
        raise FileNotFoundError(
            f"No indexed chunks found for '{path}'. Is the file indexed?")
    seen: set[str] = set()
    chunks = []
    for r in sorted(rows, key=lambda r: (r.line_start, r.window_idx or 0)):
        base = r.name.split("#w")[0]
        if base in seen:
            continue           # window rows collapse to one entry
        seen.add(base)
        chunks.append(r)
    graph = CallGraph.for_store(store)
    functions = []
    for r in chunks:
        callers = len(graph.rev.get(r.id, ()))
        tests = len(test_map(store, r.name.split("#w")[0], graph=graph)) \
            if r.chunk_type in ("function", "method") else 0
        functions.append({
            "name": r.name.split("#w")[0],
            "chunk_type": r.chunk_type,
            "line_start": r.line_start,
            "callers": callers,
            "tests": tests,
        })
    return {"file": norm, "functions": functions, "total": len(functions)}


# ---------------------------------------------------------------------------
# task + plan
# ---------------------------------------------------------------------------

#: Task templates (ref: src/plan.rs TEMPLATES — name + description +
#: checklist + patterns, selected by WEIGHTED keyword scoring; the
#: reference's checklists are hard-coded to its own repo layout, so the
#: analog here is checklists phrased as tool-driven workflows over THIS
#: CLI's commands, which generalize to any indexed repo).
TASK_TEMPLATES: dict[str, dict] = {
    "add_feature": {
        "description": "Add new functionality or extend existing behavior",
        "keywords": [("implement", 2.0), ("add", 1.5), ("create", 1.5),
                     ("support", 1.0), ("new", 1.0), ("feature", 2.0),
                     ("extend", 1.5)],
        "checklist": [
            "`where '<description>'` — pick the target file from the placement suggestions",
            "`related <nearest function>` — study sibling functions for conventions",
            "Follow the file's local patterns (imports, error style, naming — in the placement output)",
            "Implement behind the existing interfaces; avoid new entry points unless required",
            "Add tests mirroring the sibling tests (`test-map <neighbor>` shows where they live)",
            "`impact <touched function>` — check callers and affected tests before finishing",
        ],
        "patterns": [
            "New code belongs next to its closest semantic neighbor, not in a new file",
            "Match the target file's naming convention and visibility defaults",
        ],
    },
    "fix_bug": {
        "description": "Something produces wrong results, crashes, or misbehaves",
        "keywords": [("bug", 2.0), ("fix", 1.5), ("broken", 2.0), ("fails", 1.5),
                     ("error", 0.5), ("crash", 2.0), ("wrong", 1.5),
                     ("incorrect", 1.5), ("regression", 1.5), ("panic", 2.0)],
        "checklist": [
            "Reproduce: pin down input -> actual -> expected before touching code",
            "`scout '<symptom>'` — locate the responsible code",
            "`callers <function>` — who reaches the buggy path?",
            "`test-map <function>` — does any test cover the failing case?",
            "Fix minimally in the library layer, not the surface layer",
            "Add the regression test that would have caught this",
            "`impact <function>` — did the fix change behavior for other callers?",
        ],
        "patterns": [
            "Fix where the invariant is owned, not where the symptom appears",
            "A bug without a regression test will come back",
        ],
    },
    "refactor": {
        "description": "Restructure code without changing behavior",
        "keywords": [("refactor", 2.5), ("clean", 1.0), ("restructure", 2.0),
                     ("simplify", 1.5), ("extract", 1.5), ("split", 1.0),
                     ("rename", 1.5), ("move", 0.5)],
        "checklist": [
            "`callers <target>` — map every caller before moving anything",
            "`test-map <target>` — confirm coverage; add tests FIRST if thin",
            "Apply the refactor in small, individually green steps",
            "`dead` — verify no orphaned code is left behind",
            "`impact <target>` — re-check the blast radius at the end",
        ],
        "patterns": [
            "Behavior-preserving: the test suite is the spec — keep it green at every step",
        ],
    },
    "optimize": {
        "description": "Make something faster or lighter",
        "keywords": [("slow", 2.0), ("optimize", 2.5), ("performance", 2.0),
                     ("faster", 2.0), ("speed", 1.5), ("latency", 2.0),
                     ("memory", 1.0), ("throughput", 2.0)],
        "checklist": [
            "Measure first — record the baseline number you are trying to move",
            "`callers <slow function>` / `trace` — find the real hot path",
            "Optimize only the measured hot path; leave the rest alone",
            "Re-measure with the same method; keep the delta with the change",
            "`impact <function>` — confirm the optimization kept semantics",
        ],
        "patterns": [
            "No measurement, no optimization: a before/after number per change",
        ],
    },
    "test": {
        "description": "Add or improve test coverage",
        "keywords": [("test", 2.0), ("coverage", 2.5), ("spec", 1.5),
                     ("untested", 2.5), ("flaky", 2.0)],
        "checklist": [
            "`test-map <function>` — what already covers the target?",
            "`scout '<area>'` — the untested_count in the summary shows the gaps",
            "Mirror the structure of the nearest existing tests",
            "Cover the failure paths, not just the happy path",
        ],
        "patterns": [
            "Tests live where their siblings live; follow the existing fixture tier",
        ],
    },
    "document": {
        "description": "Write or update documentation",
        "keywords": [("document", 2.0), ("docs", 2.0), ("readme", 2.5),
                     ("comment", 1.0), ("docstring", 2.0), ("explain", 0.5)],
        "checklist": [
            "`scout '<topic>'` — find the code the docs must describe",
            "`drift` — find docs already contradicting the code",
            "Document behavior and invariants, not line-by-line mechanics",
            "Link docs to the symbols they describe so drift is detectable",
        ],
        "patterns": [
            "Docs that restate the code go stale silently; document the WHY",
        ],
    },
    "upgrade": {
        "description": "Upgrade a dependency, migrate an API, or deprecate",
        "keywords": [("upgrade", 2.5), ("update", 1.0), ("bump", 2.0),
                     ("migrate", 2.0), ("migration", 2.0), ("deprecate", 2.5),
                     ("version", 1.0)],
        "checklist": [
            "`search '<old API>'` — enumerate every use site before changing one",
            "`impact <central function>` — rank sites by blast radius",
            "Migrate in compatibility order: leaves first, core last",
            "`dead` — remove the old path once no caller remains",
        ],
        "patterns": [
            "Dual-running old+new beats a big-bang switch when call sites are many",
        ],
    },
    "security": {
        "description": "Harden inputs, auth, or data handling",
        "keywords": [("security", 2.5), ("vulnerability", 2.5), ("sanitize", 2.0),
                     ("injection", 2.5), ("auth", 1.5), ("secret", 1.5),
                     ("untrusted", 2.0)],
        "checklist": [
            "`scout '<input surface>'` — map where untrusted data enters",
            "`trace <entry> <sink>` — follow the data to its sinks",
            "Validate at the boundary; keep the core assuming clean data",
            "Add adversarial tests (oversized, malformed, hostile inputs)",
            "`callers <validator>` — confirm every entry path goes through it",
        ],
        "patterns": [
            "One validation chokepoint beats scattered ad-hoc checks",
        ],
    },
    "integrate": {
        "description": "Connect to an external system or API",
        "keywords": [("integrate", 2.5), ("connect", 1.5), ("api", 1.0),
                     ("webhook", 2.5), ("external", 1.5), ("provider", 1.5),
                     ("client", 1.0)],
        "checklist": [
            "`related <existing client>` — find the established integration pattern",
            "Wrap the external surface behind one local interface",
            "Handle the failure modes first: timeout, retry, malformed response",
            "Test against a mock/fake of the external system, not the real one",
        ],
        "patterns": [
            "The rest of the codebase should never import the external SDK directly",
        ],
    },
    "configure": {
        "description": "Add or change a config knob, flag, or env var",
        "keywords": [("config", 2.0), ("settings", 1.5), ("flag", 2.0),
                     ("option", 1.0), ("env", 1.5), ("knob", 2.5),
                     ("default", 1.0)],
        "checklist": [
            "`search 'config registry'` — find the central knob registry; add there, not inline",
            "Clamp/validate the value at parse time with a safe default",
            "Document the knob where its siblings are documented",
            "`impact <consumer>` — check what behavior the knob gates",
            "Add a test for the non-default value",
        ],
        "patterns": [
            "Every knob needs: default, bounds, doc line, and one test",
        ],
    },
    "investigate": {
        "description": "Understand how or why something works",
        "keywords": [("investigate", 2.0), ("why", 1.5), ("how", 1.0),
                     ("understand", 2.0), ("explain", 1.5), ("where", 0.5)],
        "checklist": [
            "`scout '<question>'` — the dashboard's entry paths show where to start reading",
            "`gather '<question>'` — assemble the reading order",
            "`trace <entry> <target>` — confirm the suspected call path",
            "Write down what you learned where the next person will look",
        ],
        "patterns": [
            "Read breadth-first from entry points; depth-first reading rabbit-holes",
        ],
    },
}


def classify_task(description: str) -> str:
    """Weighted keyword scoring over the template registry (ref:
    src/plan.rs TemplateEntry.keywords — weighted, substring-matched so
    multi-word keys and prefixes like 'migrat(e|ion)' hit)."""
    text = description.lower()
    words = set(text.replace(",", " ").replace(".", " ").split())
    best, score = "investigate", 0.0
    for template, spec in TASK_TEMPLATES.items():
        s = sum(w for kw, w in spec["keywords"]
                if (kw in text if " " in kw else kw in words))
        if s > score:
            best, score = template, s
    return best


def plan_task(engine, description: str) -> dict:
    """Task plan: template -> scout -> checklist + conventions to follow
    (ref: src/plan.rs PlanResult — template, description, checklist,
    patterns, scout)."""
    template = classify_task(description)
    spec = TASK_TEMPLATES[template]
    sc = scout(engine, description, limit=5)
    return {"template": template,
            "template_description": spec["description"],
            "scout": sc,
            "checklist": spec["checklist"],
            "patterns": spec["patterns"]}


def task_brief(engine, description: str) -> dict:
    """The composite task command: scout → gather → impact → placement
    (ref: src/task.rs:104 TaskResult). Impact runs per MODIFY TARGET (the
    scout role, ref task.rs:363 extract_modify_targets) — not per top hit:
    a dependency's blast radius is not the task's risk. Affected tests are
    deduped across targets into a top-level section, and the summary block
    carries the counts an agent triages by (ref task.rs:374
    compute_summary: modify_targets, high_risk_count, test_count,
    stale_count)."""
    sc = scout(engine, description, limit=5)
    items = gather(engine, description, depth=1, limit=10)
    placement = suggest_placement(engine, description, limit=3)
    targets = [c for c in sc["top_chunks"] if c.get("role") == "modify_target"]
    if not targets:                       # scout found no clear target:
        targets = sc["top_chunks"][:3]    # fall back to the top hits
    impacts = []
    tests_seen: dict[str, dict] = {}
    for c in targets[:5]:
        name = c["name"].split(".")[-1]
        rep = analyze_impact(engine.store, name)
        if rep:
            impacts.append({"name": name, "risk": rep.risk,
                            "callers": len(rep.callers),
                            "tests": len(rep.affected_tests)})
            for t in rep.affected_tests:
                tests_seen.setdefault(t.id, {"name": t.qualified_name,
                                             "origin": t.origin})
    high_risk = sum(1 for i in impacts if str(i["risk"]).lower() == "high")
    return {
        "description": description,
        "template": classify_task(description),
        "scout": sc,
        "reading_order": [it.as_dict() for it in items],
        "placement": placement,
        "impact": impacts,
        "tests": sorted(tests_seen.values(), key=lambda t: (t["origin"], t["name"])),
        "summary": {
            "total_files": sc["summary"]["total_files"],
            "total_functions": sc["summary"]["total_functions"],
            "modify_targets": len(targets),
            "high_risk_count": high_risk,
            "test_count": len(tests_seen),
            "stale_count": sc["summary"]["stale_count"],
        },
    }
