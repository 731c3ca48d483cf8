"""CLI command handlers of the port.

Port of the part of ``cqs_tpu/cli/commands.py`` that the port serves: each
``cmd_<name>(ctx, args) -> int`` is the reference's handler over the port's
``CommandContext`` (store, models and engine on an explicit device). Text
rendering is compact; ``--json`` emits the versioned envelope
(``cli/envelope.py``). ``HANDLERS`` at the end is the table ``cli/main.py``
dispatches through: a reference command that is not in it is not ported yet.
"""

from __future__ import annotations

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
    eng = ctx.engine
    prior = os.environ.get("CQST_SCORE_THRESHOLD")
    if args.threshold is not None:
        os.environ["CQST_SCORE_THRESHOLD"] = str(args.threshold)
    try:
        res = eng.search(args.query, limit=args.limit, path_filter=args.path_filter,
                         lang_filter=args.lang, alpha_override=args.alpha,
                         chunk_types=chunk_types, rerank=args.rerank,
                         use_overlay=args.worktree, include_docs=args.include_docs)
    finally:
        if args.threshold is not None:
            if prior is None:
                os.environ.pop("CQST_SCORE_THRESHOLD", None)
            else:
                os.environ["CQST_SCORE_THRESHOLD"] = prior
    record_telemetry(ctx.index_dir, "search", args.query, len(res.hits))
    if args.json:
        emit(envelope("search", [h.to_dict(include_body=args.body) for h in res.hits],
                      meta={**staleness_meta(ctx.store, ctx.root),
                            "category": res.category, "strategy": res.strategy,
                            "alpha": res.alpha, "elapsed_ms": round(res.elapsed_ms, 2),
                            "device": str(ctx.device)}), True)
        return 0
    _print(f"# {res.category} / {res.strategy} / alpha={res.alpha:.2f} "
           f"({res.elapsed_ms:.0f} ms, {ctx.device})")
    for h in res.hits:
        _print(f"{h.score:6.3f}  {h.row.origin}:{h.row.line_start}  "
               f"{h.row.qualified_name}  [{h.row.chunk_type}]")
        if args.body:
            for line in h.row.body.splitlines()[:20]:
                _print(f"        {line}")
    if not res.hits:
        _print("(no results)")
    return 0


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
    for it in items:
        _print(f"{it.score:6.3f} [{it.via:9}] {it.row.origin}:{it.row.line_start}-"
               f"{it.row.line_end}  {it.row.qualified_name}")
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


#: command -> handler: what the port serves. ``cli/main.py`` exits 2 for a
#: reference command that has no entry here.
HANDLERS = {
    "index": cmd_index, "search": cmd_search,
    "callers": cmd_callers, "callees": cmd_callees, "impact": cmd_impact,
    "trace": cmd_trace, "dead": cmd_dead, "test-map": cmd_test_map,
    "read": cmd_read, "similar": cmd_similar, "notes": cmd_notes, "gather": cmd_gather,
    "stats": cmd_stats, "status": cmd_status,
    "ping": cmd_ping, "refresh": cmd_refresh, "watch": cmd_watch,
    "batch": cmd_batch, "mcp": cmd_mcp, "serve": cmd_serve,
    "embed-2d": cmd_embed_2d,
}
