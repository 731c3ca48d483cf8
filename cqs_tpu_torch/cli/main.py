"""CLI entry point: ``python -m cqs_tpu_torch index`` and
``python -m cqs_tpu_torch "query" [--json] [--device cuda|cpu]``.

Port of the ``index`` and ``search`` commands of ``cqs_tpu/cli``
(``main.py``, ``commands.py::cmd_index``/``cmd_search``), with the same JSON
envelope from the port's own copy of the reference's ``envelope.py``
(pinned to it by ``tests/test_torch_standalone.py``). A bare first argument that
is not a command is a search query. Every other command of the reference
exits non-zero with "not yet ported". ``--device`` defaults to ``cuda`` and
fails loudly where there is no GPU; ``--device cpu`` runs the plain scans.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from cqs_tpu_torch.cli.envelope import emit, envelope, staleness_meta
from cqs_tpu_torch.utils.trace import configure as configure_tracing, record_telemetry

#: the reference CLI's commands (cqs_tpu/cli/main.py KNOWN_COMMANDS)
REFERENCE_COMMANDS = {
    "init", "index", "search", "callers", "callees", "deps", "impact", "trace",
    "dead", "test-map", "read", "similar", "stats", "status", "eval", "note",
    "notes", "slot", "gather", "gc", "model", "watch", "batch", "mcp", "ping",
    "scout", "task", "onboard", "where", "related", "suggest", "plan", "kind",
    "review", "impact-diff", "ci", "affected", "health", "structural", "drift",
    "diff", "serve", "sweep", "ablate", "label-queries", "train-data", "train",
    "train-distill", "train-reranker", "train-centroids", "summaries", "doctor",
    "telemetry", "chat", "completions", "project", "ref", "convert", "embed-2d",
    "export-model", "audit-mode", "audit-extraction", "hook", "explain", "context",
    "blame", "reconstruct", "stale", "neighbors", "refresh", "improve-docs",
    "brief", "cache",
}
PORTED_COMMANDS = {"index", "search"}
_VALUE_FLAGS = {"--slot", "--path", "--device"}


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    # SUPPRESS defaults: the flags are parented onto the root parser and every
    # subparser, and a concrete default in a subparser would overwrite a
    # root-level value; main() fills the effective defaults
    common.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                        help="JSON envelope output")
    common.add_argument("--slot", default=argparse.SUPPRESS, help="index slot to use")
    common.add_argument("--path", default=argparse.SUPPRESS,
                        help="project root (default: auto-detect)")
    common.add_argument("--device", default=argparse.SUPPRESS,
                        help="torch device: cuda (default) or cpu")
    common.add_argument("-v", "--verbose", action="count", default=argparse.SUPPRESS)

    p = argparse.ArgumentParser(
        prog="cqs-tpu-torch", parents=[common],
        description="Hybrid code search on PyTorch/CUDA (lexical tier).")
    sub = p.add_subparsers(dest="command")
    sp = sub.add_parser("index", parents=[common], help="build or update the index")
    sp.add_argument("--force", action="store_true", help="reindex everything")
    sp.add_argument("--no-enrich", action="store_true",
                    help="skip the call-graph enrichment pass")
    sp = sub.add_parser("search", parents=[common], help="search (also the bare default)")
    sp.add_argument("query")
    sp.add_argument("-k", "--limit", type=int, default=10)
    sp.add_argument("--lang", help="language filter")
    sp.add_argument("--filter", dest="path_filter", help="path glob filter")
    sp.add_argument("--alpha", type=float, help="override fusion alpha")
    sp.add_argument("--body", action="store_true", help="include chunk bodies")
    sp.add_argument("--include-docs", action="store_true",
                    help="include section/module/config chunks")
    sp.add_argument("--type", action="append", dest="types", metavar="CHUNK_TYPE")
    sp.add_argument("--exclude-type", action="append", dest="exclude_types",
                    metavar="CHUNK_TYPE")
    sp.add_argument("--threshold", type=float, default=None,
                    help="cosine floor (score_threshold knob)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _VALUE_FLAGS:
            i += 2
            continue
        if a.startswith("-"):
            i += 1
            continue
        if a not in REFERENCE_COMMANDS:
            argv = argv[:i] + ["search"] + argv[i:]
        elif a not in PORTED_COMMANDS:
            print(f"cqs-tpu-torch: command {a!r} is not yet ported "
                  f"(use python -m cqs_tpu {a})", file=sys.stderr)
            return 2
        break
    args = build_parser().parse_args(argv)
    for k, v in (("json", False), ("slot", None), ("path", None), ("verbose", 0),
                 ("device", "cuda")):
        if not hasattr(args, k):
            setattr(args, k, v)
    configure_tracing(args.verbose)
    if not args.command:
        build_parser().print_help()
        return 0
    from cqs_tpu_torch.cli.context import CommandContext

    ctx = CommandContext.create(args.path, args.slot, device=args.device)
    try:
        return cmd_index(ctx, args) if args.command == "index" else cmd_search(ctx, args)
    finally:
        ctx.close()


def cmd_index(ctx, args) -> int:
    from cqs_tpu_torch.store.lock import IndexLock, IndexLocked
    from cqs_tpu_torch.pipeline import run_index_pipeline

    try:
        lock = IndexLock(ctx.index_dir).acquire()
    except IndexLocked as e:
        print(str(e))
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
        print(f"indexed {stats.files_parsed} files ({stats.files_skipped} unchanged, "
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


def cmd_search(ctx, args) -> int:
    if not Path(ctx.index_dir).exists() or ctx.store.chunk_count() == 0:
        msg = "no index found — run `python -m cqs_tpu_torch index` first"
        if args.json:
            emit(envelope("search", [], error=msg), True)
        else:
            print(msg)
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
                         chunk_types=chunk_types, include_docs=args.include_docs)
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
    print(f"# {res.category} / {res.strategy} / alpha={res.alpha:.2f} "
          f"({res.elapsed_ms:.0f} ms, {ctx.device})")
    for h in res.hits:
        print(f"{h.score:6.3f}  {h.row.origin}:{h.row.line_start}  "
              f"{h.row.qualified_name}  [{h.row.chunk_type}]")
        if args.body:
            for line in h.row.body.splitlines()[:20]:
                print(f"        {line}")
    if not res.hits:
        print("(no results)")
    return 0
