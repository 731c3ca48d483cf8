"""CLI command handlers of the port.

Port of the part of ``cqs_tpu/cli/commands.py`` that the port serves: each
``cmd_<name>(ctx, args) -> int`` is the reference's handler over the port's
``CommandContext`` (store, models and engine on an explicit device). Text
rendering is compact; ``--json`` emits the versioned envelope
(``cli/envelope.py``). ``HANDLERS`` at the end is the table ``cli/main.py``
dispatches through: every command of the reference's CLI. Where the reference
names its own program (the pre-push hook's command, the shell completions,
the chat banner, the "run ... index" hints), the port names its own, and
``doctor``'s device rows read ``torch.cuda``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.envelope import emit, envelope, staleness_meta
from cqs_tpu_torch.utils.trace import record_telemetry


def _print(s: str = "") -> None:
    sys.stdout.write(s + "\n")


# ---------------------------------------------------------------------------
# index / search
# ---------------------------------------------------------------------------

def cmd_index(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.pipeline import run_index_pipeline
    from cqs_tpu_torch.store.lock import IndexLock, IndexLocked

    try:
        lock = IndexLock(ctx.index_dir).acquire()
    except IndexLocked as e:
        _print(str(e))
        return 1
    last = [0.0]

    def progress(stats):
        if time.time() - last[0] > 2.0:
            last[0] = time.time()
            print(f"  ... {stats.files_parsed} files, {stats.chunks_upserted} chunks",
                  file=sys.stderr)

    try:
        stats = run_index_pipeline(
            ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(), config=ctx.config,
            force=args.force, with_enrichment=not args.no_enrich, progress=progress)
    finally:
        lock.release()
    _ = ctx.engine       # build + persist the device indexes so the first query is warm
    if args.json:
        emit(envelope("index", stats.as_dict()), True)
    else:
        _print(f"indexed {stats.files_parsed} files ({stats.files_skipped} unchanged, "
               f"{stats.files_removed} removed) -> {stats.chunks_upserted} chunks, "
               f"{stats.embedded} embedded ({stats.embed_reused} reused), "
               f"{stats.enriched} enriched, {stats.sparse_encoded} sparse "
               f"in {stats.elapsed_s:.1f}s")
    return 0


def _parse_chunk_types(args):
    """--type/--exclude-type -> an include list (None = code-only default);
    the reference's rules (``cqs_tpu/cli/commands.py::_parse_chunk_types``).
    Raises ValueError on an unknown type."""
    from cqs_tpu_torch.parser.types import ChunkType

    types, excl = args.types, args.exclude_types
    if not types and not excl:
        return None
    valid = {t.value for t in ChunkType}
    bad = [n for n in (types or []) + (excl or []) if n not in valid]
    if bad:
        raise ValueError(f"invalid chunk type {bad[0]!r}. Valid: {', '.join(sorted(valid))}")
    if types:
        include = [ChunkType(t) for t in types]
    elif args.include_docs:
        include = [t for t in ChunkType if t is not ChunkType.WINDOW]
    else:
        include = [t for t in ChunkType if t.is_code and t is not ChunkType.WINDOW]
    drop = {ChunkType(t) for t in excl or []}
    return [t for t in include if t not in drop]


def cmd_search(ctx: CommandContext, args) -> int:
    if args.projects:
        # other registered projects, each opened on this command's device
        from cqs_tpu_torch.store.projects import cross_project_search

        results = cross_project_search(args.projects, args.query, limit=args.limit,
                                       device=ctx.device)
        if args.json:
            emit(envelope("search", results, meta={"device": str(ctx.device)}), True)
        else:
            for h in results:
                _print(f"{h['score']:6.3f}  [{h['project']}] {h['origin']}:{h['line_start']}  "
                       f"{h['name']}")
        return 0
    if not Path(ctx.index_dir).exists() or ctx.store.chunk_count() == 0:
        msg = "no index found — run `python -m cqs_tpu_torch index` first"
        if args.json:
            emit(envelope("search", [], error=msg), True)
        else:
            _print(msg)
        return 2
    try:
        chunk_types = _parse_chunk_types(args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.name_only:
        # the forced FTS name lookup: the store alone, no device program
        rows = ctx.store.search_by_name_fts(args.query, limit=args.limit)
        if args.json:
            emit(envelope("search", [{"name": r.qualified_name, "origin": r.origin,
                                      "line_start": r.line_start,
                                      "chunk_type": r.chunk_type}
                                     for r in rows]), True)
        else:
            for r in rows:
                _print(f"{r.origin}:{r.line_start}  {r.qualified_name}  [{r.chunk_type}]")
        return 0
    eng = ctx.engine
    knob_env = {}
    if args.threshold is not None:
        knob_env["CQST_SCORE_THRESHOLD"] = str(args.threshold)
    if args.no_demote:
        for k in ("TEST_DEMOTION", "VENDORED_DEMOTION", "DATA_DEMOTION", "DOC_DEMOTION"):
            knob_env[f"CQST_{k}"] = "0"
    fetch = args.limit * 3 if args.pattern else args.limit   # the pattern filter's over-fetch
    prior = {k: os.environ.get(k) for k in knob_env}
    os.environ.update(knob_env)
    try:
        if args.rrf:
            res = eng.search_with_rrf(args.query, limit=fetch, path_filter=args.path_filter,
                                      lang_filter=args.lang, chunk_types=chunk_types,
                                      include_docs=args.include_docs)
        else:
            res = eng.search(args.query, limit=fetch, path_filter=args.path_filter,
                             lang_filter=args.lang, alpha_override=args.alpha,
                             chunk_types=chunk_types, rerank=args.rerank,
                             use_overlay=args.worktree, include_docs=args.include_docs)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if args.pattern:
        from cqs_tpu_torch.analysis.quality import match_pattern
        from cqs_tpu_torch.search.engine import SearchResult

        kept = [h for h in res.hits
                if match_pattern(args.pattern, h.row.body, h.row.name,
                                 h.row.language)][: args.limit]
        # a fresh result: res.hits may be the engine's cached list
        res = SearchResult(kept, res.category, res.strategy, res.alpha,
                           res.elapsed_ms, dict(res.meta, pattern=args.pattern))
    # --expand-parent: each hit's containing type or module, resolved by name
    # within the hit's own file, once per (file, parent) in the batch
    parents: dict[str, dict] = {}
    if args.expand_parent:
        cache: dict[tuple[str, str], dict | None] = {}
        for h in res.hits:
            pn = h.row.parent_name
            if not pn:
                continue
            key = (h.row.origin, pn)
            if key not in cache:
                cache[key] = None
                for prow in ctx.store.find_by_name(pn):
                    if prow.origin == h.row.origin and not prow.parent_id:
                        cache[key] = {"name": prow.qualified_name,
                                      "chunk_type": prow.chunk_type,
                                      "line_start": prow.line_start,
                                      "signature": prow.signature}
                        break
            if cache[key] is not None:
                parents[h.row.id] = cache[key]
    record_telemetry(ctx.index_dir, "search", args.query, len(res.hits))
    if args.json:
        emit(envelope("search", [h.to_dict(include_body=args.body) for h in res.hits],
                      meta={**staleness_meta(ctx.store, ctx.root),
                            "category": res.category, "strategy": res.strategy,
                            "alpha": res.alpha, "elapsed_ms": round(res.elapsed_ms, 2),
                            "device": str(ctx.device)},
                      **({"parents": parents} if parents else {})), True)
        return 0
    _print(f"# {res.category} / {res.strategy} / alpha={res.alpha:.2f} "
           f"({res.elapsed_ms:.0f} ms, {ctx.device})")
    if args.budget:
        _pack_budget(ctx, [(h.row, h.score) for h in res.hits], args.budget)
        return 0
    for h in res.hits:
        _print(f"{h.score:6.3f}  {h.row.origin}:{h.row.line_start}  "
               f"{h.row.qualified_name}  [{h.row.chunk_type}]")
        p = parents.get(h.row.id)
        if p:
            _print(f"        in {p['chunk_type']} {p['name']} (line {p['line_start']})")
        if args.body:
            for line in h.row.body.splitlines()[:20]:
                _print(f"        {line}")
    if not res.hits:
        _print("(no results)")
    return 0


def _pack_budget(ctx: CommandContext, rows_scores: list, budget: int) -> None:
    """Token-budget packing: whole bodies best-first until the budget runs
    out, then signatures only (``cqs_tpu/cli/commands.py:2102-2121``)."""
    used = 0
    count = ctx.embedder.token_count
    for row, score in rows_scores:
        header = (f"== {score:6.3f} {row.origin}:{row.line_start}-{row.line_end}  "
                  f"{row.qualified_name}")
        cost = count(row.body) + 10
        if used + cost <= budget:
            _print(header)
            _print(row.body)
            used += cost
        else:
            _print(f"{header}  [signature only — budget]")
            _print(f"   {row.signature}")
            used += count(row.signature) + 10
        if used >= budget:
            _print(f"(budget {budget} tokens reached)")
            break


# ---------------------------------------------------------------------------
# call graph and read commands (the daemon's dispatch table serves the same)
# ---------------------------------------------------------------------------

def cmd_callers(ctx: CommandContext, args) -> int:
    callers = ctx.store.callers_of(args.name)
    if args.json:
        emit(envelope("callers", [
            {"name": c.qualified_name, "origin": c.origin, "line": line, "kind": kind}
            for c, line, kind in callers]), True)
        return 0
    for c, line, kind in callers:
        _print(f"{c.origin}:{line}  {c.qualified_name}  [{kind}]")
    if not callers:
        _print(f"(no callers of {args.name!r} found)")
    return 0


def cmd_callees(ctx: CommandContext, args) -> int:
    rows = ctx.store.find_by_name(args.name)
    if not rows:
        _print(f"(unknown function {args.name!r})")
        return 1
    out = []
    for row in rows:
        for callee, line, kind in ctx.store.callees_of(row.id):
            resolved = ctx.store.find_by_name(callee)
            out.append({"name": callee, "line": line, "kind": kind,
                        "resolved": bool(resolved),
                        "origin": resolved[0].origin if resolved else None})
    if args.json:
        emit(envelope("callees", out), True)
        return 0
    for c in out:
        mark = "" if c["resolved"] else "  (external)"
        _print(f"L{c['line']}  {c['name']}  [{c['kind']}]{mark}")
    return 0


def _mermaid_escape(s: str) -> str:
    return s.replace('"', "'").replace("\n", " ")


def _mermaid_node(i: int) -> str:
    """B, C, ... Z, AA, AB ... (node A is the target)."""
    out, i = "", i + 1  # skip A
    while True:
        out = chr(ord("A") + i % 26) + out
        i = i // 26 - 1
        if i < 0:
            return out


def impact_to_mermaid(rep) -> str:
    """Mermaid flowchart of an impact report: callers as solid edges,
    affected tests as dashed diamond nodes."""
    lines = ["graph TD",
             f'    A["{_mermaid_escape(rep.target.qualified_name)}"]',
             "    style A fill:#f96"]
    idx = 0
    for c, d in rep.callers:
        n = _mermaid_node(idx)
        lines.append(f'    {n}["{_mermaid_escape(c.qualified_name)} '
                     f'({_mermaid_escape(c.origin)}:{c.line_start})"]')
        lines.append(f"    {n} --> A")
        idx += 1
    for t in rep.affected_tests:
        n = _mermaid_node(idx)
        lines.append(f'    {n}{{"{_mermaid_escape(t.qualified_name)}\\n'
                     f'{_mermaid_escape(t.origin)}"}}')
        lines.append(f"    {n} -.-> A")
        idx += 1
    return "\n".join(lines)


def cmd_impact(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.callgraph import analyze_impact

    rep = analyze_impact(ctx.store, args.name, depth=args.depth)
    if rep is None:
        _print(f"(unknown function {args.name!r})")
        return 1
    if args.mermaid:
        _print(impact_to_mermaid(rep))
        return 0
    if args.json:
        emit(envelope("impact", rep.as_dict()), True)
        return 0
    _print(f"impact of {rep.target.qualified_name} "
           f"({rep.target.origin}:{rep.target.line_start})  risk={rep.risk}")
    for c, d in rep.callers:
        _print(f"  d{d}  {c.origin}:{c.line_start}  {c.qualified_name}"
               + ("  [test]" if c.is_test else ""))
    _print(f"affected tests: {len(rep.affected_tests)}")
    return 0


def cmd_trace(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.callgraph import trace_path

    path = trace_path(ctx.store, args.src, args.dst)
    if path is None:
        _print(f"(no call path {args.src} -> {args.dst})")
        return 1
    if args.mermaid:
        lines = ["graph TD"]
        for i, r in enumerate(path):
            lines.append(f'    N{i}["{_mermaid_escape(r.qualified_name)} '
                         f'({_mermaid_escape(r.origin)}:{r.line_start})"]')
            if i:
                lines.append(f"    N{i - 1} --> N{i}")
        _print("\n".join(lines))
        return 0
    if args.json:
        emit(envelope("trace", [
            {"name": r.qualified_name, "origin": r.origin, "line_start": r.line_start}
            for r in path]), True)
        return 0
    for i, r in enumerate(path):
        _print(f"{'  ' * i}{r.qualified_name}  ({r.origin}:{r.line_start})")
    return 0


def cmd_dead(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.callgraph import find_dead_code

    dead = find_dead_code(ctx.store)
    if args.json:
        emit(envelope("dead", dead), True)
        return 0
    for d in dead:
        _print(f"{d['confidence']:6}  {d['origin']}:{d['line_start']}  {d['name']}")
    _print(f"({len(dead)} likely-dead functions)")
    return 0


def cmd_test_map(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.callgraph import test_map

    tests = test_map(ctx.store, args.name)
    if args.json:
        emit(envelope("test-map", [
            {"name": t.qualified_name, "origin": t.origin, "line_start": t.line_start}
            for t in tests]), True)
        return 0
    for t in tests:
        _print(f"{t.origin}:{t.line_start}  {t.qualified_name}")
    if not tests:
        _print(f"(no tests found covering {args.name!r})")
    return 0


def cmd_read(ctx: CommandContext, args) -> int:
    rows = ctx.store.find_by_name(args.name)
    if not rows:
        row = ctx.store.get_chunk(args.name)
        rows = [row] if row else []
    if not rows:
        _print(f"(no chunk named {args.name!r})")
        return 1
    for row in rows[:3]:
        _print(f"== {row.origin}:{row.line_start}-{row.line_end} "
               f"{row.qualified_name} [{row.chunk_type}]")
        _print(row.body)
    return 0


def cmd_similar(ctx: CommandContext, args) -> int:
    rows = ctx.store.find_by_name(args.name)
    if not rows:
        _print(f"(unknown chunk {args.name!r})")
        return 1
    res = ctx.engine.search(rows[0].nl or rows[0].body[:500], limit=args.limit + 1)
    hits = [h for h in res.hits if h.row.id != rows[0].id][: args.limit]
    if args.json:
        emit(envelope("similar", [h.to_dict() for h in hits]), True)
        return 0
    for h in hits:
        _print(f"{h.score:6.3f}  {h.row.origin}:{h.row.line_start}  {h.row.qualified_name}")
    return 0


def cmd_deps(ctx: CommandContext, args) -> int:
    users = ctx.store.type_users(args.name)
    if args.json:
        emit(envelope("deps", [
            {"name": u.qualified_name, "origin": u.origin, "line_start": u.line_start}
            for u in users]), True)
        return 0
    for u in users:
        _print(f"{u.origin}:{u.line_start}  {u.qualified_name}")
    if not users:
        _print(f"(no chunks reference type {args.name!r})")
    return 0


def cmd_neighbors(ctx: CommandContext, args) -> int:
    rows = ctx.store.find_by_name(args.name)
    if not rows:
        _print(f"(unknown chunk {args.name!r})")
        return 1
    row = rows[0]
    siblings = sorted(ctx.store.iter_chunks(
        "origin = ? AND chunk_type != 'window'", (row.origin,)),
        key=lambda r: r.line_start)
    idx = next((i for i, s in enumerate(siblings) if s.id == row.id), None)
    if idx is not None:
        for j in range(max(0, idx - 2), min(len(siblings), idx + 3)):
            s = siblings[j]
            _print(f"{'>' if j == idx else ' '} {s.origin}:{s.line_start}-{s.line_end}  "
                   f"{s.qualified_name} [{s.chunk_type}]")
    return 0


def cmd_note(ctx: CommandContext, args) -> int:
    nid = ctx.store.add_note(args.target, args.text, args.sentiment)
    _print(f"note #{nid} added on {args.target!r}")
    return 0


def cmd_notes(ctx: CommandContext, args) -> int:
    notes = ctx.store.notes_for(args.target)
    if args.json:
        emit(envelope("notes", [
            {"id": i, "target": t, "text": x, "sentiment": s} for i, t, x, s in notes]), True)
        return 0
    for i, t, x, s in notes:
        _print(f"#{i} [{s}] {t}: {x}")
    return 0


def cmd_gather(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.gather import gather

    items = gather(ctx.engine, args.query, depth=args.depth, limit=args.limit,
                   direction=args.direction, seed_limit=args.seed_limit,
                   seed_threshold=args.seed_threshold, decay=args.decay)
    if args.json:
        emit(envelope("gather", [it.as_dict() for it in items]), True)
        return 0
    if args.budget:
        _pack_budget(ctx, [(it.row, it.score) for it in items], args.budget)
        return 0
    for it in items:
        _print(f"{it.score:6.3f} [{it.via:9}] {it.row.origin}:{it.row.line_start}-"
               f"{it.row.line_end}  {it.row.qualified_name}")
    return 0


# ---------------------------------------------------------------------------
# context, analysis and diff commands: the analysis functions the daemon's
# dispatch table calls (``daemon/dispatch.py``), in-process
# ---------------------------------------------------------------------------

def _emit_or_render(args, command: str, data, render) -> int:
    if args.json:
        emit(envelope(command, data), True)
    else:
        render(data)
    return 0


def cmd_scout(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import scout

    data = scout(ctx.engine, args.query)

    def render(d):
        _print(f"# scout: {d['query']}")
        for c in d["top_chunks"]:
            marks = (f"[{c.get('role', '?'):13}] callers={c.get('caller_count', 0)} "
                     f"tests={c.get('test_count', 0)}")
            _print(f"  {c['score']:6.3f} {marks} {c['origin']}:{c['line_start']}  {c['name']}")
        s = d.get("summary")
        if s:
            _print(f"summary: {s['total_functions']} fns / {s['total_files']} files, "
                   f"{s['untested_count']} untested, {s['stale_count']} stale files")
        if d["key_types"]:
            _print("types: " + ", ".join(f"{t['type']}({t['uses']})" for t in d["key_types"]))
        if d["files"]:
            _print("files: " + ", ".join(f"{f['origin']}" for f in d["files"][:5]))
        for e in d["entry_paths"]:
            _print(f"entry: {e['entry']} -> {e['reaches']}")

    return _emit_or_render(args, "scout", data, render)


def cmd_task(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import task_brief

    data = task_brief(ctx.engine, args.description)

    def render(d):
        _print(f"# task [{d['template']}]: {d['description']}")
        _print("## reading order")
        for it in d["reading_order"]:
            _print(f"  {it['origin']}:{it['line_start']}-{it['line_end']}  {it['name']} "
                   f"[{it['via']}]")
        _print("## placement")
        for p in d["placement"]:
            _print(f"  {p['origin']}  affinity={p['affinity']}")
        _print("## impact")
        for i in d["impact"]:
            _print(f"  {i['name']}: risk={i['risk']} callers={i['callers']} tests={i['tests']}")

    return _emit_or_render(args, "task", data, render)


def cmd_onboard(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import onboard, onboard_concept

    if args.concept:
        data = onboard_concept(ctx.engine, args.concept, depth=args.depth,
                               direction=args.direction)
        if args.json:
            emit(envelope("onboard", data), True)
            return 0
        if "error" in data:
            _print(f"{data['error']}; closest hits:")
            for h in data.get("top_hits", []):
                _print(f"  {h['origin']}  {h['name']}")
            return 1
        e = data["entry_point"]
        _print(f"# concept tour: {data['concept']}")
        _print(f"entry point: {e['origin']}:{e['line']}  {e['name']}")
        _print(f"  {e['signature']}")
        _print(f"## call chain (depth {data['summary']['callee_depth']})")
        for c in data["call_chain"]:
            _print(f"  {'  ' * c['depth']}{c['origin']}:{c['line']}  {c['name']}")
        _print("## callers")
        for c in data["callers"]:
            _print(f"  {c['origin']}:{c['line']}  {c['name']}")
        if data["key_types"]:
            _print("## key types")
            for t in data["key_types"][:12]:
                _print(f"  {t['type']} ({t['uses']} uses)")
        if data["tests"]:
            _print("## tests")
            for t in data["tests"][:10]:
                _print(f"  {t['origin']}  {t['name']}")
        s = data["summary"]
        trunc = ", ".join(f"{k}={v}" for k, v in s.items()
                          if k.endswith("_truncated") and v)
        _print(f"{s['total_items']} items over {s['files_covered']} files"
               + (f" (truncated: {trunc})" if trunc else ""))
        return 0
    data = onboard(ctx.store)

    def render(d):
        _print(f"# repo tour: {d['stats']['chunks']} chunks / {d['stats']['files']} files")
        _print("languages: " + ", ".join(f"{k}({v})" for k, v in d["stats"]["languages"].items()))
        _print("## largest files")
        for f in d["largest_files"][:6]:
            _print(f"  {f['origin']} ({f['chunks']} chunks)")
        _print("## most-called")
        for m in d["most_called"][:6]:
            _print(f"  {m['name']} <- {m['callers']} callers")
        _print("## entry points")
        for e in d["entry_points"][:6]:
            _print(f"  {e['name']} ({e['origin']})")

    return _emit_or_render(args, "onboard", data, render)


def cmd_where(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import suggest_placement

    data = suggest_placement(ctx.engine, args.description)

    def render(d):
        for p in d:
            _print(f"{p['affinity']:7.3f}  {p['origin']}  "
                   f"({p['matching_chunks']} related chunks; insert after "
                   f"{p['near_function']} at L{p['insertion_line']})")
            pat = p.get("patterns") or {}
            bits = [b for b in (pat.get("error_handling"), pat.get("naming_convention"),
                                pat.get("visibility"),
                                "inline tests" if pat.get("has_inline_tests") else "") if b]
            if bits:
                _print("         conventions: " + ", ".join(bits))

    return _emit_or_render(args, "where", data, render)


def cmd_related(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import find_related

    data = find_related(ctx.store, args.name, limit=args.limit)

    def render(d):
        for r in d:
            _print(f"{r['score']:5.2f}  {r['origin']}:{r['line_start']}  {r['name']}")
            for reason in r["reasons"]:
                _print(f"        - {reason}")

    return _emit_or_render(args, "related", data, render)


def cmd_suggest(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import suggest_refactors

    data = suggest_refactors(ctx.store)

    def render(d):
        for s in d:
            loc = f"{s['origin']}:{s['line_start']}  " if s["origin"] else ""
            _print(f"[{s['kind']}] {loc}{s['name']}: {s['detail']}")

    return _emit_or_render(args, "suggest", data, render)


def cmd_plan(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import plan_task

    data = plan_task(ctx.engine, args.description)

    def render(d):
        _print(f"# plan [{d['template']}]: {d['template_description']}")
        for i, step in enumerate(d["checklist"], 1):
            _print(f"{i}. {step}")
        if d.get("patterns"):
            _print("## conventions")
            for p in d["patterns"]:
                _print(f"  - {p}")
        _print("## starting points")
        for c in d["scout"]["top_chunks"][:5]:
            _print(f"  {c['origin']}:{c['line_start']}  {c['name']}")

    return _emit_or_render(args, "plan", data, render)


def cmd_kind(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import classify_kind

    k = classify_kind(ctx.store, args.name)
    return _emit_or_render(args, "kind", {"name": args.name, "kind": k},
                           lambda d: _print(d["kind"]))


def cmd_explain(ctx: CommandContext, args) -> int:
    """Why a chunk ranked (or not) for a query: its rank, score and signals
    in the top-50 pool."""
    res = ctx.engine.search(args.query, limit=50)
    target = None
    for h in res.hits:
        if h.row.name == args.name or h.row.qualified_name == args.name:
            target = h
            break
    data = {"query": args.query, "category": res.category, "strategy": res.strategy,
            "alpha": res.alpha}
    if target is None:
        rows = ctx.store.find_by_name(args.name)
        data["found"] = False
        data["note"] = ("chunk exists but did not reach the top-50 pool"
                        if rows else "no chunk with that name")
        if rows:
            data["nl"] = rows[0].nl[:300]
    else:
        rank = next(i for i, h in enumerate(res.hits) if h is target)
        data.update({"found": True, "rank": rank, "score": target.score,
                     "signals": target.signals, "nl": target.row.nl[:300]})
    if args.json:
        emit(envelope("explain", data), True)
        return 0
    for k, v in data.items():
        _print(f"{k}: {v}")
    return 0


def _load_diff(ctx: CommandContext, args) -> str:
    from cqs_tpu_torch.analysis.diffs import git_diff

    if args.diff_file:
        return Path(args.diff_file).read_text()
    return git_diff(ctx.root, args.base)


def cmd_review(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.diffs import review_diff

    diff = _load_diff(ctx, args)
    if not diff.strip():
        _print("(no diff)")
        return 0
    data = review_diff(ctx.store, diff)

    def render(d):
        _print(f"# review: max risk {d['impact']['max_risk']}")
        for t in d["impact"]["touched"]:
            _print(f"  {t['risk']:6}  {t['origin']}:{t['line_start']}  {t['name']} "
                   f"({t['callers']} callers)")
        for f in d["findings"]:
            _print(f"! [{f['kind']}] {f['message']}")

    return _emit_or_render(args, "review", data, render)


def cmd_impact_diff(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.diffs import impact_of_diff

    diff = _load_diff(ctx, args)
    if not diff.strip():
        _print("(no diff)")
        return 0
    data = impact_of_diff(ctx.store, diff).as_dict()

    def render(d):
        _print(f"max risk: {d['max_risk']}")
        for t in d["touched"]:
            _print(f"  {t['risk']:6}  {t['origin']}:{t['line_start']}  {t['name']}")
            for test in t["suggested_tests"]:
                _print(f"          test: {test}")

    return _emit_or_render(args, "impact-diff", data, render)


def cmd_ci(ctx: CommandContext, args) -> int:
    """The CI gate on a diff's impact risk: exit 3 when it reaches
    ``--threshold``."""
    from cqs_tpu_torch.analysis.diffs import ci_gate

    code, data = ci_gate(ctx.store, _load_diff(ctx, args), threshold=args.threshold)
    if args.json:
        emit(envelope("ci", data), True)
    else:
        _print(data.get("gate", "PASS (empty diff)"))
        for t in data.get("touched", []):
            _print(f"  {t['risk']:6}  {t['name']}")
    return code


def cmd_affected(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.diffs import impact_of_diff

    data = impact_of_diff(ctx.store, _load_diff(ctx, args)).as_dict()
    tests = sorted({t for f in data["touched"] for t in f["suggested_tests"]})

    def render(_):
        for t in tests:
            _print(t)
        if not tests:
            _print("(no affected tests found)")

    return _emit_or_render(args, "affected", tests, render)


def cmd_health(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.quality import health_report

    data = health_report(ctx.store, ctx.root)

    def render(d):
        s = d["stats"]
        _print(f"# health: {s['chunks']} chunks, {s['embedded']} embedded, "
               f"{d['stale_count']} stale files, {d['dead_count']} dead functions")
        for h in d["hotspots"][:5]:
            _print(f"  hotspot: {h['name']} ({h['callers']} callers)")
        for n in d["open_notes"][:5]:
            _print(f"  note [{n['sentiment']}] {n['target']}: {n['text'][:60]}")
        if d["parse_error_files"]:
            _print(f"  parse errors in: {', '.join(d['parse_error_files'][:5])}")

    return _emit_or_render(args, "health", data, render)


def cmd_structural(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.quality import structural_scan

    data = structural_scan(ctx.store, pattern_filter=args.pattern)

    def render(d):
        for f in d:
            _print(f"[{f['pattern']}] {f['origin']}:{f['line']}  {f['name']}")
        _print(f"({len(d)} findings)")

    return _emit_or_render(args, "structural", data, render)


def cmd_drift(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.quality import drift_report

    data = drift_report(ctx.store, ctx.engine.embedder)

    def render(d):
        for f in d:
            _print(f"{f['doc_code_sim']:6.3f}  {f['origin']}:{f['line_start']}  {f['name']}")
        _print(f"({len(d)} drifted docs)")

    return _emit_or_render(args, "drift", data, render)


# ---------------------------------------------------------------------------
# the cross-project registry (``store/projects.py``)
# ---------------------------------------------------------------------------

def cmd_project(ctx: CommandContext, args) -> int:
    return _registry_action(args, kind="projects")


def cmd_ref(ctx: CommandContext, args) -> int:
    return _registry_action(args, kind="refs")


def _registry_action(args, kind: str) -> int:
    from cqs_tpu_torch.store.projects import add_project, list_projects, remove_project

    if args.action == "list":
        for name, root in list_projects(kind).items():
            _print(f"{name:20} {root}")
        return 0
    if not args.name:
        _print("name required")
        return 2
    if args.action == "add":
        if not args.root:
            _print("root path required")
            return 2
        add_project(args.name, args.root, kind)
        _print(f"registered {args.name!r} -> {args.root}")
        return 0
    ok = remove_project(args.name, kind)
    _print("removed" if ok else f"{args.name!r} not registered")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the eval gate and its sweeps (``eval/``), through the production search path
# ---------------------------------------------------------------------------

def cmd_eval(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.eval import diff_reports, load_query_set, run_eval

    queries = load_query_set(args.queries)
    eng = ctx.engine
    if args.triage:
        from cqs_tpu_torch.eval.triage import run_triage, summarize

        def tprog(done, total):
            if done % 10 == 0:
                print(f"  triage {done}/{total}", file=sys.stderr)

        rows = run_triage(eng, queries, category=args.category, progress=tprog)
        summary = summarize(rows)
        Path(args.triage).write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
        _print(json.dumps(summary))
        return 0

    def progress(done, total, rep):
        if done % 25 == 0:
            print(f"  {done}/{total}  r@5={rep.recall(5):.3f}", file=sys.stderr)

    data = run_eval(eng, queries, progress=progress, rerank=args.rerank).as_dict()
    if args.baseline:
        data["baseline_diff"] = diff_reports(data, json.loads(Path(args.baseline).read_text()))
    if args.save:
        Path(args.save).write_text(json.dumps(data, indent=2))
    if args.json:
        emit(envelope("eval", data, meta={"device": str(ctx.device)}), True)
        return 0
    r = data["recall"]
    _print(f"eval: {data['total']} scoreable ({data['skipped']} no-gold, "
           f"{data['skipped_missing']} gold-not-extracted)  "
           f"R@1={r['r@1']:.1%} R@5={r['r@5']:.1%} R@20={r['r@20']:.1%}  "
           f"p50={data['latency_ms']['p50']}ms ({ctx.device})")
    if data["skipped_missing"]:
        rs = data["recall_strict"]
        _print(f"  strict (missing-gold-as-miss): R@1={rs['r@1']:.1%} "
               f"R@5={rs['r@5']:.1%} R@20={rs['r@20']:.1%}")
    for cat, c in data["per_category"].items():
        _print(f"  {cat:20} n={c['total']:<4} R@5={c['r@5']:.1%}")
    for k, d in data.get("baseline_diff", {}).items():
        _print(f"  {k}: {d['current']:.3f} vs {d['baseline']:.3f} ({d['delta']:+.3f})")
    return 0


#: (knob, disabled value): every shipped-on recall lever with a clean off
#: state (``cqs_tpu/cli/commands.py::ABLATE_LEVERS``). ``sig_boost_kind_gate``
#: is off at 1.0 (no scaling), not 0.
ABLATE_LEVERS: list[tuple[str, object]] = [
    ("fts_acronym", 0), ("lang_hint_boost", 0.0), ("sig_struct_boost", 0.0),
    ("rescue_name_weight", 0.0), ("xlang_core_weight", 0.0), ("name_boost", 0.0),
    ("sig_boost", 0.0), ("type_boost", 0.0), ("path_affinity_boost", 0.0),
    ("doc_demotion", 0.0), ("negation_demotion", 0.0), ("same_name_collapse", 0),
    ("canonical_twin_collapse", 0), ("parent_boost", 0.0), ("sql_bridge", 0),
    ("sig_leg_weight", 0.0), ("router_verb_scaffold", 0), ("router_that_verb", 0),
    ("sig_boost_kind_gate", 1.0),
]


def cmd_ablate(ctx: CommandContext, args) -> int:
    """Disable each shipped lever in turn and re-run the eval split through
    the production pipeline (the result cache fingerprints the knob
    snapshot, so a flip cannot serve a stale ordering)."""
    from cqs_tpu_torch.eval import load_query_set, run_eval

    queries = load_query_set(args.queries)
    eng = ctx.engine
    levers = ABLATE_LEVERS
    if args.levers:
        levers = []
        for spec in args.levers.split(","):
            knob, _, off = spec.partition("=")
            levers.append((knob.strip(), off.strip() or "0"))

    def snapshot() -> dict:
        rep = run_eval(eng, queries).as_dict()
        return {k: round(rep["recall"][k] * 100, 1) for k in ("r@1", "r@5", "r@20")}

    base = snapshot()
    _print(f"baseline           R@1={base['r@1']:5.1f}  R@5={base['r@5']:5.1f}  "
           f"R@20={base['r@20']:5.1f}   ({len(queries)} queries)")
    rows = {"baseline": base}
    for knob, off in levers:
        env = f"CQST_{knob.upper()}"
        prior = os.environ.get(env)
        os.environ[env] = str(off)
        try:
            r = snapshot()
        finally:
            if prior is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = prior
        rows[knob] = r
        _print(f"-{knob:18} R@1={r['r@1']:5.1f}  R@5={r['r@5']:5.1f}  "
               f"R@20={r['r@20']:5.1f}   "
               f"(d5={r['r@5'] - base['r@5']:+.1f}, d20={r['r@20'] - base['r@20']:+.1f})")
    if args.save:
        Path(args.save).write_text(json.dumps(rows, indent=1))
    return 0


def cmd_sweep(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.eval.cv import load_labeled_pool, loco_sweep

    pool = load_labeled_pool(args.pool, exclude_paths=args.exclude)
    _print(f"pool: {len(pool)} labeled queries "
           f"({len({q.category for q in pool})} categories)")
    eng = ctx.engine

    def prog(v, cats):
        h = sum(x[0] for x in cats.values())
        t = sum(x[1] for x in cats.values())
        print(f"  {args.knob}={v}: R@{args.k} {h}/{t} = {h/t:.1%}", file=sys.stderr)

    result = loco_sweep(eng, args.knob, args.values, pool, k=args.k, progress=prog)
    if args.save:
        Path(args.save).write_text(json.dumps(result, indent=1))
    _print(json.dumps({k: v for k, v in result.items() if k != "per_value"}, indent=1))
    for v, d in result["per_value"].items():
        cats = " ".join(f"{c}={x['hits']}/{x['total']}"
                        for c, x in sorted(d["per_category"].items()))
        _print(f"  {v}: {d['overall']:.1%}  {cats}")
    return 0


# ---------------------------------------------------------------------------
# index state
# ---------------------------------------------------------------------------

def cmd_stats(ctx: CommandContext, args) -> int:
    s = ctx.store.stats()
    if args.json:
        emit(envelope("stats", s), True)
        return 0
    for k, v in s.items():
        _print(f"{k:16} {v}")
    return 0


def cmd_status(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon import status as watch_status

    if args.wait:
        ok = watch_status.wait_fresh(ctx.index_dir, timeout=args.timeout)
        _print("fresh" if ok else "timeout waiting for freshness")
        if not ok:
            return 1
    meta = staleness_meta(ctx.store, ctx.root)
    s = ctx.store.stats()
    data = {"slot": ctx.slot, "chunks": s["chunks"], "files": s["files"],
            "embedded": s["embedded"], "generation": s["generation"], **meta}
    if args.watch:
        snap = watch_status.read(ctx.index_dir)
        data["daemon"] = snap or "not publishing"
    if args.json:
        emit(envelope("status", data), True)
        return 0
    for k, v in data.items():
        _print(f"{k:16} {v}")
    if meta["stale_sampled"]:
        _print(f"warning: {meta['stale_sampled']}/{meta['sampled']} sampled files stale "
               "- run `python -m cqs_tpu_torch index`")
    return 0


# ---------------------------------------------------------------------------
# the daemon and the surfaces that share its dispatch table
# ---------------------------------------------------------------------------

def cmd_ping(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.client import ping

    alive = ping(ctx.index_dir)
    _print("daemon: " + ("live" if alive else "not running"))
    return 0 if alive else 1


def cmd_refresh(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.client import request

    resp = request(ctx.index_dir, "refresh", {})
    if resp is None:
        _print("no daemon running")
        return 1
    if "error" in resp:
        _print(f"daemon refresh failed: {resp['error']}")
        return 1
    _print("daemon indexes refreshed")
    return 0


def cmd_watch(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.watch import run_watch

    return run_watch(ctx, serve=args.serve, once=args.once)


def cmd_batch(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.batch import run_batch_loop

    return run_batch_loop(ctx, sys.stdin, sys.stdout)


def cmd_mcp(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.mcp import serve_stdio

    return serve_stdio(ctx)


def cmd_serve(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.dispatch import BatchContext
    from cqs_tpu_torch.daemon.serve import run_server

    bctx = BatchContext(ctx)
    bctx.warm()
    httpd, token = run_server(bctx, host=args.host, port=args.port)
    _print(f"serving on http://{args.host}:{args.port}/?token={token}")
    _print("Ctrl+C to stop")
    try:
        import signal
        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        bctx.close()
    return 0


def cmd_embed_2d(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.ops.project2d import store_projection

    n = store_projection(ctx.store, method=args.method, device=ctx.device)
    _print(f"projected {n} chunks to 2-D ({args.method})")
    return 0


# ---------------------------------------------------------------------------
# training (parallel/train.py on the context's device; one device, dp = tp = 1)
# ---------------------------------------------------------------------------

def cmd_train_data(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.train.data import (
        attach_engine_negatives, generate_pairs_from_store, mine_callgraph_pairs,
        mine_git_history, mine_labeled_queries, save_pairs,
    )

    pairs = []
    if args.source in ("git", "both", "all"):
        pairs += mine_git_history(ctx.root, ctx.store)
    if args.source in ("labeled", "all") and getattr(args, "labeled", None):
        pairs += mine_labeled_queries(ctx.store, args.labeled,
                                      exclude_paths=getattr(args, "exclude", []))
    if args.source in ("callgraph", "all"):
        pairs += mine_callgraph_pairs(ctx.store, max_pairs=max(0, args.max - len(pairs)))
    if args.source in ("store", "both", "all"):
        pairs += generate_pairs_from_store(ctx.store, max_pairs=args.max - len(pairs))
    pairs = pairs[: args.max]
    k = int(getattr(args, "engine_negatives", 0) or 0)
    if k > 0:
        got = attach_engine_negatives(ctx.engine, pairs, per=k)
        _print(f"engine negatives: {got}/{len(pairs)} pairs got serving-order negatives")
    save_pairs(pairs, args.out)
    _print(f"wrote {len(pairs)} training pairs to {args.out}")
    return 0


def _train_config(args, fields, mesh):
    """``TrainConfig`` defaults with the given flags that are set (0 = unset);
    ``--batch`` is the global batch, divided over the mesh's dp rows as the
    reference divides it."""
    import dataclasses

    from cqs_tpu_torch.parallel import TrainConfig

    cfg = TrainConfig()
    if getattr(args, "batch", 0):
        cfg = dataclasses.replace(cfg, batch_per_device=max(1, args.batch // mesh.shape["dp"]))
    for f in fields:
        v = getattr(args, f, None)
        if v:
            cfg = dataclasses.replace(cfg, **{f: v})
    return cfg


class _TrainLog:
    """``<out>/train_log.jsonl``: one JSON line a step (stage, step, loss and
    the step's metric), so a run's whole loss curve can be read back."""

    def __init__(self, out: Path):
        out.mkdir(parents=True, exist_ok=True)
        self._f = open(out / "train_log.jsonl", "w")

    def write(self, **row) -> None:
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()


def _save_trained(trainer, out: Path, extra: dict) -> None:
    """``params.pkl`` (the Flax-pathed numpy tree either package loads) and
    the native serving checkpoint (``Embedder("cqs-mini", model_path=out)``)."""
    import pickle

    from cqs_tpu_torch.models.loader import save_native_checkpoint

    cfg = trainer.cfg
    tree = trainer.params_tree()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    save_native_checkpoint(tree, out, {
        "family": cfg.family, "tokenizer": "hash",
        "hash_dim": cfg.hash_dim, "hash_seed": cfg.hash_seed,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position": cfg.seq_len, "pooling": "mean", **extra,
    })


def _encode_texts(trainer, tok, texts: list[str], prefix: str, seq_len: int):
    """The trainer's model over ``prefix + text``, 256 rows at a time, as
    host f32 unit vectors."""
    import numpy as np

    outs = []
    for s0 in range(0, len(texts), 256):
        es = [tok.encode(prefix + t, seq_len) for t in texts[s0:s0 + 256]]
        outs.append(trainer.encode(np.stack([e.ids for e in es]),
                                   np.stack([e.mask for e in es])))
    return np.concatenate(outs)


def cmd_train(ctx: CommandContext, args) -> int:
    import numpy as np

    from cqs_tpu_torch.parallel import ContrastiveTrainer, make_2d_mesh
    from cqs_tpu_torch.parallel.train import AdamW, make_pair_batch
    from cqs_tpu_torch.train.data import load_pairs

    pairs = load_pairs(args.pairs)
    if len(pairs) < 8:
        _print(f"need at least 8 pairs, have {len(pairs)}")
        return 1
    # every card of the device's kind (the CPU's one device), as the
    # reference trains over every JAX device
    mesh = make_2d_mesh(device=ctx.device)
    cfg = _train_config(args, ("lr", "seq_len", "hidden_size", "num_layers",
                               "intermediate_size", "family"), mesh)
    trainer = ContrastiveTrainer(cfg, mesh=mesh)
    tok = ctx.embedder.tokenizer
    B = trainer.global_batch
    rng = np.random.default_rng(0)
    _print(f"training on {len(pairs)} pairs, global batch {B}, mesh {dict(mesh.shape)}")
    use_hard = bool(getattr(args, "hard_negatives", True))
    # query/doc asymmetry: prefixes are trained in and stamped into the
    # checkpoint config; serving (Embedder) applies them automatically
    qp = getattr(args, "query_prefix", "q: ") or ""
    dp_pref = getattr(args, "doc_prefix", "d: ") or ""
    negs_per = max(1, int(getattr(args, "negatives_per", 1) or 1))
    out = Path(args.out)
    log = _TrainLog(out)

    def run_stage(stage_pairs, steps, label):
        for step in range(steps):
            idx = rng.choice(len(stage_pairs), size=B)
            batch = make_pair_batch([qp + stage_pairs[i].query for i in idx],
                                    [dp_pref + stage_pairs[i].positive for i in idx],
                                    tok, cfg.seq_len)
            if use_hard:
                # K mined hard negatives per pair; pairs without mined
                # negatives take random OTHER pairs' positives (never this
                # pair's own text)
                neg_texts = []
                for i in idx:
                    negs = stage_pairs[i].negatives
                    take = list(rng.permutation(len(negs))[:negs_per]) if negs else []
                    row = [negs[t] for t in take]
                    while len(row) < negs_per:
                        j = int(rng.integers(len(stage_pairs)))
                        if j != i and stage_pairs[j].positive != stage_pairs[i].positive:
                            row.append(stage_pairs[j].positive)
                    neg_texts.extend(row)
                encs = [tok.encode(dp_pref + t, cfg.seq_len) for t in neg_texts]
                n_ids = np.stack([e.ids for e in encs]).reshape(B, negs_per, -1)
                n_mask = np.stack([e.mask for e in encs]).reshape(B, negs_per, -1)
                loss, acc = trainer.train_step(*batch, n_ids, n_mask)
            else:
                loss, acc = trainer.train_step(*batch)
            log.write(stage=label, step=step, loss=loss, acc=acc)
            if step % 10 == 0:
                _print(f"{label} step {step:4d}  loss {loss:.4f}  acc {acc:.3f}")

    ft_path = getattr(args, "finetune", None)
    probe_pairs = load_pairs(ft_path)[:256] if ft_path else pairs[:256]

    def probe(label):
        """Retrieval-style rank probe: each probe query against the union of
        all probe positives."""
        uniq: dict[str, int] = {}
        gold_col = [uniq.setdefault(p.positive, len(uniq)) for p in probe_pairs]
        qv = _encode_texts(trainer, tok, [p.query for p in probe_pairs], qp, cfg.seq_len)
        dv = _encode_texts(trainer, tok, list(uniq), dp_pref, cfg.seq_len)
        sims = qv @ dv.T
        gold = sims[np.arange(len(probe_pairs)), gold_col]
        ranks = (sims > gold[:, None]).sum(axis=1)
        r5 = float((ranks < 5).mean())
        _print(f"{label} probe: R@1 {float((ranks == 0).mean()):.3f} R@5 {r5:.3f} over "
               f"{len(uniq)} docs (n={len(probe_pairs)})")
        return r5

    try:
        run_stage(pairs, args.steps, "pretrain")
        if getattr(args, "eval_every", 0):
            probe("pretrain-end")
        # second stage: supervised fine-tune on labeled (query -> gold) pairs
        # with a plain adamw(ft_lr) and fresh state over every parameter, as
        # the reference rebuilds its optimizer
        if ft_path and getattr(args, "finetune_steps", 0):
            ft_pairs = load_pairs(ft_path)
            if len(ft_pairs) >= 8:
                ft_lr = getattr(args, "finetune_lr", 0.0) or cfg.lr * 0.2
                for p in trainer.model.parameters():
                    p.requires_grad_(True)
                trainer.opt = AdamW(trainer.trainable(), ft_lr)
                _print(f"finetune on {len(ft_pairs)} labeled pairs at lr {ft_lr}")
                run_stage(ft_pairs, args.finetune_steps, "finetune")
                if getattr(args, "eval_every", 0):
                    probe("finetune-end")
    finally:
        log.close()
    _save_trained(trainer, out, {"query_prefix": qp, "doc_prefix": dp_pref,
                                 "trained_by": "cqs_tpu_torch contrastive trainer"})
    _print(f"saved checkpoint to {out} (params.pkl + model.safetensors + cqs_config.json)")
    return 0


def _gate_probe(ctx: CommandContext, trainer, gate_paths, seq_len: int) -> None:
    """Student-only R@1/5/20 on held-out gate queries: the whole corpus and
    the queries encoded by the student, no FTS legs, no boosts."""
    import numpy as np

    from cqs_tpu_torch.eval import load_query_set

    tok = ctx.embedder.tokenizer
    rows = [(r.id, r.origin, r.name.split("#w")[0], r.nl or r.name)
            for r in ctx.store.iter_chunks("chunk_type != 'window'")]
    _print(f"gate probe: encoding {len(rows)} corpus chunks ...")
    dv = _encode_texts(trainer, tok, [t for *_, t in rows], "d: ", seq_len)
    key_of = [(o, n) for _, o, n, _ in rows]
    for gate_path in gate_paths:
        qs = [q for q in load_query_set(gate_path) if q.gold is not None]
        resolvable = [q for q in qs
                      if any(o == q.gold.origin and n == q.gold.name for o, n in key_of)]
        if not resolvable:
            _print(f"gate {Path(gate_path).name}: no resolvable gold")
            continue
        sims = _encode_texts(trainer, tok, [q.query for q in resolvable], "q: ", seq_len) @ dv.T
        r1 = r5 = r20 = 0
        for i, q in enumerate(resolvable):
            seen, rank, pos = set(), None, 0
            for j in np.argsort(-sims[i]):
                k2 = key_of[j]
                if k2 in seen:
                    continue
                seen.add(k2)
                if k2 == (q.gold.origin, q.gold.name):
                    rank = pos
                    break
                pos += 1
                if pos >= 20:
                    break
            if rank is not None:
                r20 += 1
                r5 += rank < 5
                r1 += rank < 1
        n_ = len(resolvable)
        _print(f"gate {Path(gate_path).name}: student-only "
               f"R@1 {r1/n_:.3f} R@5 {r5/n_:.3f} R@20 {r20/n_:.3f} (n={n_})")


def cmd_train_distill(ctx: CommandContext, args) -> int:
    """Distill the fused production ordering into a dense student: teacher
    labels are the engine's top-k per mined query, the student a dual
    encoder trained with listwise KL over the candidates."""
    from cqs_tpu_torch.parallel import make_2d_mesh
    from cqs_tpu_torch.parallel.train import DistillTrainer
    from cqs_tpu_torch.train.data import mine_labeled_queries
    from cqs_tpu_torch.train.distill import (
        DistillBatcher, generate_teacher_labels, load_teacher_labels,
    )

    lp = Path(args.labels)
    if lp.exists() and not getattr(args, "relabel", False):
        labels = load_teacher_labels(lp)
        _print(f"loaded {len(labels)} teacher label rows from {lp}")
    else:
        qs = mine_labeled_queries(ctx.store, args.pool, exclude_paths=args.exclude or [])
        _print(f"teacher pass over {len(qs)} mined queries (k={args.k}) ...")

        def prog(done, total):
            print(f"  {done}/{total}", file=sys.stderr)

        lp.parent.mkdir(parents=True, exist_ok=True)
        labels = generate_teacher_labels(ctx.engine, qs, k=args.k, out_path=lp, progress=prog)
        _print(f"wrote {len(labels)} label rows to {lp}")
    if getattr(args, "labels_only", False):
        return 0

    mesh = make_2d_mesh(device=ctx.device)
    cfg = _train_config(args, ("lr", "seq_len", "hidden_size", "num_layers",
                               "intermediate_size", "temperature"), mesh)
    trainer = DistillTrainer(cfg, teacher_temp=getattr(args, "teacher_temp", 0.05),
                             mesh=mesh)
    out = Path(args.out)
    resume_p = out / "params.pkl"
    if getattr(args, "resume", False) and resume_p.exists():
        import pickle

        # either package's params.pkl; the optimizer state starts afresh
        with open(resume_p, "rb") as f:
            trainer.load_params_tree(pickle.load(f))
        _print(f"resumed params from {resume_p}")
    batcher = DistillBatcher(ctx.store, labels, ctx.embedder.tokenizer, cfg.seq_len,
                             k=getattr(args, "cands", 16))
    B = trainer.global_batch
    _print(f"distilling on {len(batcher.labels)} label rows, batch {B} x "
           f"K={batcher.k}, mesh {dict(mesh.shape)}")
    log = _TrainLog(out)
    try:
        for step in range(args.steps):
            loss, agree = trainer.distill_step(*batcher.batch(B))
            log.write(stage="distill", step=step, loss=loss, agree=agree)
            if step % 25 == 0 or step == args.steps - 1:
                _print(f"  step {step:5d}  kl {loss:.4f}  teacher-top1-agree {agree:.3f}")
    finally:
        log.close()
    if getattr(args, "gate", None):
        _gate_probe(ctx, trainer, args.gate, cfg.seq_len)
    _save_trained(trainer, out, {"query_prefix": "q: ", "doc_prefix": "d: ",
                                 "trained_by": "cqs_tpu_torch fused-ordering distillation"})
    _print(f"saved distilled checkpoint to {out}")
    return 0


def cmd_train_reranker(ctx: CommandContext, args) -> int:
    """Pairwise cross-encoder training on mined/labeled (query, positive,
    negatives) pairs, loss softplus(s_neg - s_pos). The model computes in f32
    on the CPU, as the reference's does off the TPU, and in bf16 on a GPU,
    the card's counterpart of the TPU's bf16; its parameters are f32."""
    import numpy as np

    from cqs_tpu_torch.models.bert import BertConfig
    from cqs_tpu_torch.models.embedder import compute_dtype
    from cqs_tpu_torch.models.loader import load_cross_encoder_params, save_native_checkpoint
    from cqs_tpu_torch.models.tokenizer import load_tokenizer
    from cqs_tpu_torch.parallel.train import RerankerTrainer
    from cqs_tpu_torch.train.data import load_pairs

    pairs = [p for p in load_pairs(args.pairs) if p.negatives]
    if len(pairs) < 8:
        _print(f"need >=8 pairs with negatives, have {len(pairs)}")
        return 1
    tok = load_tokenizer(None, vocab_size=32768)
    L = args.seq_len or 192
    cfg = BertConfig(vocab_size=32768, hidden_size=args.hidden_size or 256,
                     num_layers=args.num_layers or 4, num_heads=8,
                     intermediate_size=args.intermediate_size or 1024, max_position=L,
                     dtype=compute_dtype(ctx.device))
    # warmup + clip: seq-192 cross-encoders collapse to constant logits at a
    # flat 1e-3 on hard pairs
    trainer = RerankerTrainer(cfg, args.steps, lr=args.lr or 5e-4, device=ctx.device)
    if getattr(args, "init", None):
        loaded = load_cross_encoder_params(Path(args.init), trainer.model.state_dict())
        if loaded is None:
            _print(f"no loadable checkpoint at {args.init}")
            return 1
        import torch

        with torch.no_grad():
            trainer.model.load_state_dict(loaded)
        _print(f"initialized from {args.init}")

    def encode_pair(q: str, p: str):
        half = L // 2 - 2
        qe = tok.encode(q, half)
        qn = int(qe.mask.sum())
        pe = tok.encode(p, L - qn)
        pn = int(pe.mask.sum())
        ids = np.zeros(L, np.int32)
        mask = np.zeros(L, np.int32)
        types = np.zeros(L, np.int32)
        ids[:qn] = qe.ids[:qn]
        ids[qn:qn + pn] = pe.ids[:pn]
        mask[:qn + pn] = 1
        types[qn:qn + pn] = 1
        return ids, mask, types

    rng = np.random.default_rng(0)
    B = args.batch or 32
    out = Path(args.out)
    log = _TrainLog(out)
    try:
        for s_i in range(args.steps):
            idx = rng.choice(len(pairs), size=B)
            pos = [encode_pair(pairs[i].query, pairs[i].positive) for i in idx]
            neg = [encode_pair(pairs[i].query,
                               pairs[i].negatives[int(rng.integers(len(pairs[i].negatives)))])
                   for i in idx]
            loss, acc = trainer.train_step(*(np.stack(x) for x in zip(*pos)),
                                           *(np.stack(x) for x in zip(*neg)))
            log.write(stage="reranker", step=s_i, loss=loss, acc=acc)
            if s_i % 10 == 0:
                _print(f"step {s_i:4d}  loss {loss:.4f}  pair-acc {acc:.3f}")
    finally:
        log.close()
    save_native_checkpoint(trainer.params_tree(), out, {
        "family": "cross-encoder", "tokenizer": "hash",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size, "max_position": L,
        "trained_by": "cqs_tpu_torch train-reranker"})
    _print(f"saved reranker checkpoint to {out}")
    return 0


def cmd_export_model(ctx: CommandContext, args) -> int:
    """The active embedder's parameters as the reference's Flax-pathed numpy
    tree (``params.pkl``; the hash family's ``{"table": ...}``) and its
    identity (``config.json``)."""
    import pickle
    import types

    import torch

    from cqs_tpu_torch.models.bert import BertLayer
    from cqs_tpu_torch.models.convert import flax_tree_from_torch
    from cqs_tpu_torch.models.gemma import GemmaAttention

    emb = ctx.embedder
    model = emb._ensure_model()
    if isinstance(model, torch.Tensor):
        tree = {"table": model.float().cpu().numpy()}
    else:
        layer = next(m for m in model.modules() if isinstance(m, (BertLayer, GemmaAttention)))
        hd = layer.head_dim if isinstance(layer, BertLayer) else layer.cfg.head_dim
        tree = flax_tree_from_torch(model.state_dict(), types.SimpleNamespace(head_dim=hd))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    (out / "config.json").write_text(json.dumps({
        "preset": emb.preset.name, "dim": emb.dim,
        "fingerprint": emb.fingerprint,
        "max_seq_len": emb.preset.max_seq_len,
    }, indent=1))
    _print(f"exported {emb.preset.name} to {out}/")
    return 0


def cmd_train_centroids(ctx: CommandContext, args) -> int:
    """Per-category query centroids from labeled queries, written where the
    router reads them."""
    from collections import Counter

    from cqs_tpu_torch.eval import load_query_set
    from cqs_tpu_torch.search.engine import CENTROIDS_FILE
    from cqs_tpu_torch.search.router import CentroidClassifier, parse_category

    labeled = []
    for qfile in args.queries:
        for q in load_query_set(qfile):
            if q.category:
                labeled.append((parse_category(q.category), ctx.embedder.embed_query(q.query)))
    if len(labeled) < 8:
        _print(f"need more labeled queries (got {len(labeled)})")
        return 1
    clf = CentroidClassifier.train(labeled, fingerprint=ctx.embedder.fingerprint)
    out = ctx.slot_path / CENTROIDS_FILE
    clf.save(out)
    counts = Counter(cat.value for cat, _ in labeled)
    _print(f"trained centroids for {len(clf.categories)} categories "
           f"from {len(labeled)} queries -> {out}")
    for cat, n in counts.most_common():
        _print(f"  {cat:20} {n}")
    return 0


# ---------------------------------------------------------------------------
# project set-up, slots, the caches and the models
# ---------------------------------------------------------------------------

def cmd_init(ctx: CommandContext, args) -> int:
    ctx.index_dir.mkdir(parents=True, exist_ok=True)
    _ = ctx.store          # creates slots/default/index.db + schema
    _print(f"initialized {ctx.index_dir} (slot: {ctx.slot})")
    return 0


def cmd_slot(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.store import delete_slot, list_slots, promote_slot, resolve_slot

    if args.action == "list":
        active = resolve_slot(ctx.index_dir)
        for name in list_slots(ctx.index_dir):
            _print(f"{'*' if name == active else ' '} {name}")
        return 0
    if not args.name:
        _print("slot name required")
        return 2
    if args.action == "promote":
        promote_slot(ctx.index_dir, args.name)
        _print(f"promoted slot {args.name!r}")
    elif args.action == "delete":
        delete_slot(ctx.index_dir, args.name)
        _print(f"deleted slot {args.name!r}")
    return 0


def cmd_gc(ctx: CommandContext, args) -> int:
    """Drop FTS rows orphaned by chunk deletes, vacuum, and rebuild the index
    artifacts through the engine on the context's device."""
    with ctx.store.write_txn() as db:
        db.execute("DELETE FROM chunks_fts WHERE rowid NOT IN (SELECT rowid FROM chunks)")
        db.execute("DELETE FROM chunks_fts_body WHERE rowid NOT IN (SELECT rowid FROM chunks)")
    ctx.store.db.execute("VACUUM")
    for f in ("dense.npz", "dense_base.npz", "splade.npz"):
        p = ctx.slot_path / f
        if p.exists():
            p.unlink()
    _ = ctx.engine       # rebuild artifacts
    _print("gc done; index artifacts rebuilt")
    return 0


def cmd_model(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.models import all_presets

    for p in all_presets():
        _print(f"{p.name:22} {p.family:6} dim={p.dim:<6} seq={p.max_seq_len:<5} "
               f"pooling={p.pooling}")
    return 0


def cmd_cache(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.store.cache import EmbeddingCache

    cache = EmbeddingCache(ctx.slot_path / "embeddings_cache.db")
    try:
        if args.cache_cmd == "stats":
            data = cache.stats(per_model=args.per_model)
            qc = ctx.slot_path / "query_cache.db"
            data["query_cache_size_bytes"] = qc.stat().st_size if qc.exists() else 0

            def render(d):
                mb = d["total_size_bytes"] / 1e6
                _print(f"{d['total_entries']} entries / {mb:.1f} MB / "
                       f"{d['unique_models']} models  ({d['cache_path']})")
                for m in d.get("per_model", []):
                    _print(f"  {m['model']}: {m['entries']} entries, "
                           f"{m['size_bytes'] / 1e6:.1f} MB")

            _emit_or_render(args, "cache", data, render)
        elif args.cache_cmd == "clear":
            n = cache.clear(model=args.model)
            _emit_or_render(args, "cache", {"cleared": n},
                            lambda d: _print(f"cleared {d['cleared']} entries"))
        elif args.cache_cmd == "prune":
            if (args.days is None) == (args.model is None):
                print("cache prune takes exactly one of DAYS / --model", file=sys.stderr)
                return 2
            n = cache.prune(days=args.days, model=args.model)
            _emit_or_render(args, "cache", {"pruned": n},
                            lambda d: _print(f"pruned {d['pruned']} entries"))
        elif args.cache_cmd == "compact":
            freed = cache.compact()
            _emit_or_render(args, "cache", {"freed_bytes": freed},
                            lambda d: _print(f"compacted: {d['freed_bytes']} bytes freed"))
    finally:
        cache.close()
    return 0


# ---------------------------------------------------------------------------
# reading the index: a file's brief, a chunk in its file, blame, a whole file,
# stale files, another slot's diff
# ---------------------------------------------------------------------------

def cmd_brief(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.context import brief_file

    try:
        data = brief_file(ctx.store, args.file)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1

    def render(d):
        _print(f"# {d['file']} — {d['total']} chunks")
        for f in d["functions"]:
            _print(f"  {f['line_start']:>5}  {f['chunk_type']:<9} {f['name']:<40} "
                   f"callers={f['callers']} tests={f['tests']}")

    return _emit_or_render(args, "brief", data, render)


def cmd_context(ctx: CommandContext, args) -> int:
    rows = ctx.store.find_by_name(args.name)
    if not rows:
        _print(f"(unknown chunk {args.name!r})")
        return 1
    row = rows[0]
    src = ctx.root / row.origin
    if not src.exists():
        _print(row.body)
        return 0
    lines = src.read_text(errors="replace").splitlines()
    lo = max(0, row.line_start - 1 - args.lines)
    hi = min(len(lines), row.line_end + args.lines)
    _print(f"== {row.origin}:{lo + 1}-{hi} (chunk at {row.line_start}-{row.line_end})")
    for i in range(lo, hi):
        marker = "|" if row.line_start - 1 <= i < row.line_end else " "
        _print(f"{i + 1:5d}{marker} {lines[i]}")
    return 0


def cmd_blame(ctx: CommandContext, args) -> int:
    import subprocess
    from collections import Counter

    rows = ctx.store.find_by_name(args.name)
    if not rows:
        _print(f"(unknown chunk {args.name!r})")
        return 1
    row = rows[0]
    try:
        out = subprocess.run(
            ["git", "-C", str(ctx.root), "blame", "--line-porcelain",
             f"-L{row.line_start},{row.line_end}", "--", row.origin],
            capture_output=True, text=True, timeout=30)
    except (subprocess.SubprocessError, OSError):
        _print("(git blame unavailable)")
        return 1
    authors = Counter()
    for line in out.stdout.splitlines():
        if line.startswith("author "):
            authors[line[7:]] += 1
    _print(f"{row.origin}:{row.line_start}-{row.line_end}  {row.qualified_name}")
    for author, n in authors.most_common():
        _print(f"  {n:4d} lines  {author}")
    if not authors:
        _print("  (no blame data — uncommitted or not a git repo)")
    return 0


def cmd_reconstruct(ctx: CommandContext, args) -> int:
    rows = list(ctx.store.iter_chunks("origin = ? AND chunk_type != 'window'",
                                      (args.origin,)))
    if not rows:
        _print(f"(no chunks for {args.origin!r})")
        return 1
    rows.sort(key=lambda r: r.line_start)
    last_end = 0
    for r in rows:
        if r.line_start > last_end + 1 and last_end:
            _print(f"... (lines {last_end + 1}-{r.line_start - 1} not chunked)")
        _print(f"# -- {r.qualified_name} [{r.chunk_type}] L{r.line_start}-{r.line_end}")
        _print(r.body)
        last_end = max(last_end, r.line_end)
    return 0


def cmd_stale(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.utils.hashing import fingerprint_file

    stale = []
    for origin, fp in ctx.store.registered_origins().items():
        try:
            st = os.stat(ctx.root / origin)
            if not fp.matches_stat(st) and fingerprint_file(ctx.root / origin).digest != fp.digest:
                stale.append(origin)
        except OSError:
            stale.append(origin)
    if args.json:
        emit(envelope("stale", stale), True)
        return 0
    for o in stale:
        _print(o)
    _print(f"({len(stale)} stale files)" if stale else "(index is fresh)")
    return 0


def cmd_diff(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.quality import semantic_diff
    from cqs_tpu_torch.store import Store

    other = Store.open(ctx.index_dir, slot=args.other_slot, readonly=True)
    try:
        data = semantic_diff(other, ctx.store)
    finally:
        other.close()

    def render(d):
        for f in d[:30]:
            _print(f"{f['change']:15} {f['distance']:6.3f}  {f['origin']}  {f['name']}")
        _print(f"({len(d)} changes)")

    return _emit_or_render(args, "diff", data, render)


# ---------------------------------------------------------------------------
# audits, telemetry, diagnostics
# ---------------------------------------------------------------------------

def cmd_audit_extraction(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.analysis.extraction_audit import (audit_calls_python,
                                                         audit_calls_rust, run_audit)

    if args.calls:
        reps = {"python": audit_calls_python(ctx.store, ctx.root),
                "rust": audit_calls_rust(ctx.store, ctx.root)}
        if args.save:
            Path(args.save).write_text(json.dumps(reps, indent=1))
        for lang, rep in reps.items():
            if not rep["files"]:
                continue
            gt_key = "edges_ast" if "edges_ast" in rep else "edges_gt"
            _print(f"{lang} call edges: files={rep['files']} "
                   f"gt={rep[gt_key]} extracted={rep['edges_extracted']} "
                   f"recall={rep['recall']:.1%} precision={rep['precision']:.1%}")
            for w in rep["worst"][:8]:
                _print(f"    {w['origin']}:{w['chunk']} missed={w['missed']} "
                       f"phantom={w['phantom']}")
        return 0
    report = run_audit(ctx.store, ctx.root)
    if args.save:
        Path(args.save).write_text(json.dumps(report, indent=1))
    for lang, s in report.items():
        _print(f"{lang:12} files={s['files']:<5} decls={s['decls']:<6} "
               f"recall={s['recall']:.1%}")
        for w in s["worst"][:3]:
            _print(f"    {w['count']:3d} missing in {w['origin']}: {w['missing'][:4]}")
    return 0


def cmd_audit_mode(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.config import REGISTRY

    _print(f"# config: {ctx.root} (slot {ctx.slot})")
    _print(f"model: {ctx.config.model}  path: {ctx.config.model_path}")
    _print(f"splade: {ctx.config.splade_model}")
    if ctx.config.alpha_overrides:
        _print(f"alpha overrides: {ctx.config.alpha_overrides}")
    _print("# effective knobs (name = value [source])")
    for name, knob in sorted(REGISTRY.items()):
        val = getattr(ctx.config.limits, name)
        src = "default"
        if os.environ.get(knob.env) is not None:
            src = f"env {knob.env}"
        if name in ctx.config.limits._overrides:
            src = "config"
        if val != knob.default or src != "default":
            _print(f"{name} = {val} [{src}]")
    return 0


def cmd_telemetry(ctx: CommandContext, args) -> int:
    from collections import Counter

    p = ctx.index_dir / "telemetry.jsonl"
    if not p.exists():
        _print("(no telemetry; enable with CQST_TELEMETRY=1)")
        return 0
    counts = Counter()
    zero_results = Counter()
    total = 0
    for line in p.read_text().splitlines():
        try:
            rec = json.loads(line)
            counts[rec.get("command", "?")] += 1
            total += 1
            if rec.get("result_count") == 0 and rec.get("query_hash"):
                zero_results[rec["query_hash"]] += 1
        except json.JSONDecodeError:
            continue
    if args.mine:
        # queries that repeatedly return nothing are recall gaps worth
        # labeling; telemetry keeps only the query's hash
        _print("# zero-result query hashes (freq desc) — recall-gap candidates")
        for h, n in zero_results.most_common(50):
            _print(f"{n:4d}  {h}")
        return 0
    _print(f"{total} events")
    for cmd, n in counts.most_common():
        _print(f"  {cmd:16} {n}")
    return 0


def cmd_doctor(ctx: CommandContext, args) -> int:
    """The reference's diagnostics, with the device rows on ``torch.cuda``:
    the device the context resolved (and its name) and whether CUDA is
    available, which fails on a host without a card as the reference's
    TPU row fails off a TPU."""
    import torch

    from cqs_tpu_torch.index import DenseIndex, SpladeIndex
    from cqs_tpu_torch.models import get_preset

    checks: list[tuple[str, bool, str]] = []
    dev = ctx.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    checks.append(("torch device", True, f"{dev} ({name})"))
    cuda = torch.cuda.is_available()
    checks.append(("cuda available", cuda,
                   f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
                   f"CUDA {torch.version.cuda}" if cuda else f"no (torch {torch.__version__})"))
    idx_exists = (ctx.slot_path / "index.db").exists()
    checks.append(("index exists", idx_exists, str(ctx.slot_path)))
    if idx_exists:
        s = ctx.store.stats()
        checks.append(("chunks embedded", s["embedded"] == s["chunks"],
                       f"{s['embedded']}/{s['chunks']}"))
        for f in ("dense.npz", "splade.npz"):
            p = ctx.slot_path / f
            ok = p.exists()
            if ok:
                try:
                    (DenseIndex if "dense" in f else SpladeIndex).load(p, device=dev)
                    detail = "valid"
                except Exception as e:
                    ok, detail = False, f"corrupt: {e}"
            else:
                detail = "missing (will build on first query)"
            checks.append((f"artifact {f}", ok, detail))
        meta = staleness_meta(ctx.store, ctx.root)
        checks.append(("freshness", meta["stale_sampled"] == 0,
                       f"{meta['stale_sampled']}/{meta['sampled']} sampled stale"))
    preset = get_preset(ctx.config.model)
    has_weights = ctx.config.model_path is not None
    checks.append((f"model {ctx.config.model}", has_weights or preset.family == "hash",
                   "weights present" if has_weights else
                   ("lexical tier" if preset.family == "hash" else
                    "no weights -> falls back to hash tier")))
    ok_all = True
    for label, ok, detail in checks:
        ok_all &= ok
        _print(f"[{'ok ' if ok else 'FAIL'}] {label:24} {detail}")
    return 0 if ok_all else 1


# ---------------------------------------------------------------------------
# the REPL, shell completions, document conversion and the git hook; where
# the reference names its own program, these name the port's
# ---------------------------------------------------------------------------

def cmd_chat(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.daemon.batch import parse_pipeline, run_pipeline
    from cqs_tpu_torch.daemon.dispatch import BatchContext

    bctx = BatchContext(ctx)
    _print("cqs-tpu-torch chat — batch grammar (e.g.: search \"auth tokens\" | callers); "
           "Ctrl+D to exit")
    try:
        while True:
            try:
                line = input("cqs> ").strip()
            except EOFError:
                break
            if not line:
                continue
            if line in ("exit", "quit"):
                break
            resp = run_pipeline(bctx, parse_pipeline(line))
            _print(json.dumps(resp.get("results", resp), indent=1)[:4000])
    except KeyboardInterrupt:
        pass
    finally:
        bctx.close()
    return 0


_COMPLETIONS_BASH = """_cqs_tpu_torch() {
  local cur="${COMP_WORDS[COMP_CWORD]}"
  COMPREPLY=( $(compgen -W "%s" -- "$cur") )
}
complete -F _cqs_tpu_torch cqs-tpu-torch
"""


def cmd_completions(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.cli.main import REFERENCE_COMMANDS

    _print(_COMPLETIONS_BASH % " ".join(sorted(REFERENCE_COMMANDS)))
    return 0


def cmd_convert(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.convert import convert_file

    done, skipped = 0, 0
    for src in args.src:
        try:
            out = convert_file(src, ctx.root / args.out)
        except Exception as e:
            _print(f"skip {src} ({type(e).__name__}: {e})")
            skipped += 1
            continue
        if out is None:
            _print(f"skip {src} (unsupported or converter missing)")
            skipped += 1
        else:
            _print(f"{src} -> {out}")
            done += 1
    _print(f"converted {done}, skipped {skipped}; run `python -m cqs_tpu_torch index` to "
           "index them")
    return 0 if done or not skipped else 1


_HOOK_SCRIPT = """#!/bin/sh
# cqs-tpu-torch pre-push CI gate (installed by `python -m cqs_tpu_torch hook`)
exec python -m cqs_tpu_torch ci --base @{u} --threshold High
"""


def cmd_hook(ctx: CommandContext, args) -> int:
    hook = ctx.root / ".git" / "hooks" / "pre-push"
    if args.uninstall:
        if hook.exists() and "cqs-tpu" in hook.read_text():
            hook.unlink()
            _print("hook removed")
        return 0
    if not hook.parent.is_dir():
        _print("not a git repository")
        return 1
    hook.write_text(_HOOK_SCRIPT)
    hook.chmod(0o755)
    _print(f"installed pre-push CI gate at {hook}")
    return 0


# ---------------------------------------------------------------------------
# LLM enrichment and labeling (an OpenAI-compatible server named by
# CQST_LLM_BASE_URL, or the Anthropic Batches API); the searches that build
# the candidate pools run on the context's device
# ---------------------------------------------------------------------------

def cmd_label_queries(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.eval.labeling import (
        agreement_report, build_pools, judge_pools, pools_to_query_set,
    )

    p = Path(args.queries)
    if p.suffix == ".json":
        from cqs_tpu_torch.eval import load_query_set

        queries = [q.query for q in load_query_set(p)]
    else:
        queries = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
    pools = build_pools(ctx.engine, queries, k=args.k)
    if args.pool_out:
        Path(args.pool_out).write_text(json.dumps(pools, indent=1))
    if args.mock:
        from cqs_tpu_torch.llm.provider import MockProvider

        judges = {"mock_a": MockProvider(template="0"),
                  "mock_b": MockProvider(template="0")}
    else:
        from cqs_tpu_torch.llm import provider_from_env

        provider = provider_from_env()
        if provider is None:
            _print("no LLM provider configured; use --mock for plumbing tests")
            return 1
        # dual-judge: one provider judging twice, where two are not configured
        judges = {"judge_a": provider, "judge_b": provider}
    pools = judge_pools(pools, judges)
    qs = pools_to_query_set(pools)
    Path(args.out).write_text(json.dumps(qs, indent=1))
    _print(json.dumps(agreement_report(pools)))
    _print(f"wrote {qs['n']} consensus-labeled queries to {args.out}")
    return 0


def cmd_summaries(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.llm import llm_summary_pass, provider_from_env

    provider = provider_from_env()
    if provider is None:
        _print("no LLM provider configured (set CQST_LLM_BASE_URL for an "
               "OpenAI-compatible server or ANTHROPIC_API_KEY for Claude Batches)")
        return 1
    n = llm_summary_pass(ctx.store, provider, with_hyde=not args.no_hyde,
                         max_chunks=args.max)
    _print(f"enriched {n} chunks with {provider.name}; run `python -m cqs_tpu_torch index` "
           "to re-embed")
    return 0


def cmd_improve_docs(ctx: CommandContext, args) -> int:
    from cqs_tpu_torch.llm import provider_from_env
    from cqs_tpu_torch.llm.doc_writer import improve_docs

    provider = provider_from_env()
    if provider is None:
        _print("no LLM provider configured (CQST_LLM_BASE_URL or ANTHROPIC_API_KEY)")
        return 1
    patch, n = improve_docs(ctx.store, provider, ctx.root, max_chunks=args.max)
    if not n:
        _print("(nothing to document)")
        return 0
    Path(args.out).write_text(patch)
    _print(f"drafted docs for {n} functions -> {args.out} (review, then `git apply`)")
    return 0


#: command -> handler: every command of the reference's CLI
HANDLERS = {
    "index": cmd_index, "search": cmd_search,
    "callers": cmd_callers, "callees": cmd_callees, "impact": cmd_impact,
    "trace": cmd_trace, "dead": cmd_dead, "test-map": cmd_test_map,
    "read": cmd_read, "similar": cmd_similar, "notes": cmd_notes, "gather": cmd_gather,
    "deps": cmd_deps, "neighbors": cmd_neighbors, "note": cmd_note,
    "scout": cmd_scout, "task": cmd_task, "onboard": cmd_onboard, "where": cmd_where,
    "related": cmd_related, "suggest": cmd_suggest, "plan": cmd_plan, "kind": cmd_kind,
    "explain": cmd_explain, "review": cmd_review, "impact-diff": cmd_impact_diff,
    "ci": cmd_ci, "affected": cmd_affected, "health": cmd_health,
    "structural": cmd_structural, "drift": cmd_drift,
    "project": cmd_project, "ref": cmd_ref,
    "eval": cmd_eval, "ablate": cmd_ablate, "sweep": cmd_sweep,
    "stats": cmd_stats, "status": cmd_status,
    "ping": cmd_ping, "refresh": cmd_refresh, "watch": cmd_watch,
    "batch": cmd_batch, "mcp": cmd_mcp, "serve": cmd_serve,
    "embed-2d": cmd_embed_2d,
    "train-data": cmd_train_data, "train": cmd_train, "train-distill": cmd_train_distill,
    "train-reranker": cmd_train_reranker, "export-model": cmd_export_model,
    "train-centroids": cmd_train_centroids,
    "init": cmd_init, "slot": cmd_slot, "gc": cmd_gc, "model": cmd_model, "cache": cmd_cache,
    "brief": cmd_brief, "context": cmd_context, "blame": cmd_blame,
    "reconstruct": cmd_reconstruct, "stale": cmd_stale, "diff": cmd_diff,
    "audit-extraction": cmd_audit_extraction, "audit-mode": cmd_audit_mode,
    "telemetry": cmd_telemetry, "doctor": cmd_doctor, "chat": cmd_chat,
    "completions": cmd_completions, "convert": cmd_convert, "hook": cmd_hook,
    "label-queries": cmd_label_queries, "summaries": cmd_summaries,
    "improve-docs": cmd_improve_docs,
}
