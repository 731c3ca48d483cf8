"""The index pipeline: parse -> NL -> embed -> store -> enrich -> sparse.

Port of ``cqs_tpu/pipeline.py`` onto the port's models (the hash embedder on
an explicit device, the splade-hash encoder). Parsing, NL generation, the
store and the embedding cache are the shared host code, so both packages
write the same store for the same tree: per-file fingerprints skip unchanged
files, content-addressed ids keep unchanged chunks' embeddings, and the
enrichment pass re-embeds chunks whose call-graph context changed.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from cqs_tpu.config import Config, Limits, limits as default_limits
from cqs_tpu.nl import CallContext, compute_callee_doc_freq, generate_nl, generate_nl_enriched
from cqs_tpu.parser import Chunk, ChunkType, parse_file
from cqs_tpu.store import EmbeddingCache, Store
from cqs_tpu.utils.hashing import content_hash, fingerprint_file
from cqs_tpu.utils.trace import get_tracer, span
from cqs_tpu.utils.walk import enumerate_files
from cqs_tpu_torch.models import Embedder, SpladeEncoder

log = get_tracer("pipeline")


@dataclass
class IndexStats:
    files_seen: int = 0
    files_parsed: int = 0
    files_skipped: int = 0
    files_removed: int = 0
    chunks_upserted: int = 0
    chunks_deleted: int = 0
    embedded: int = 0
    embed_reused: int = 0
    enriched: int = 0
    sparse_encoded: int = 0
    parse_errors: int = 0
    elapsed_s: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def apply_windowing(chunks: list[Chunk], embedder: Embedder,
                    lim: Limits | None = None) -> list[Chunk]:
    """Split oversized chunks into WINDOW children with parent linkage
    (ref: apply_windowing — parent/window rows, parent dedup at scoring)."""
    lim = lim or default_limits
    out: list[Chunk] = []
    for c in chunks:
        if (c.line_end - c.line_start) < lim.max_chunk_lines and \
                embedder.token_count(c.body) <= embedder.max_seq_len - 8:
            out.append(c)
            continue
        windows = embedder.split_into_windows(c.body)
        if len(windows) == 1:
            out.append(c)
            continue
        out.append(c)          # parent row stays (hydration target)
        offset = 0
        for wi, wtext in enumerate(windows):
            wlines = wtext.count("\n") + 1
            wc = Chunk(
                origin=c.origin, name=f"{c.name}#w{wi}", chunk_type=ChunkType.WINDOW,
                language=c.language, line_start=c.line_start + offset,
                line_end=min(c.line_start + offset + wlines - 1, c.line_end),
                body=wtext, signature=c.signature, doc=c.doc if wi == 0 else "",
                parent_name=c.parent_name, parent_id=c.id, window_idx=wi,
                # windows inherit the parent's test flag: a window of an
                # inline test (src-file #[cfg(test)] fn, path heuristics
                # blind) must not escape test demotion (R@1 mining: 15/48
                # window-path imposters were test chunks on non-test queries)
                is_test=c.is_test)
            out.append(wc)
            offset += max(1, wlines // 2)
        log.debug("windowed %s into %d windows", c.name, len(windows))
    return out


def run_index_pipeline(root: str | Path, store: Store, embedder: Embedder,
                       splade: SpladeEncoder | None = None,
                       config: Config | None = None,
                       force: bool = False,
                       with_enrichment: bool = True,
                       progress=None) -> IndexStats:
    t0 = time.time()
    root = Path(root)
    lim = config.limits if config else default_limits
    stats = IndexStats()
    cache = EmbeddingCache(store.path.parent / "embeddings_cache.db")

    # Model-drift requeue: embeddings stored under a different embedder
    # fingerprint are STALE DATA, not just a stale index — rebuild-from-store
    # would faithfully rebuild garbage. Requeue every chunk for re-embed
    # (weights swap, tokenizer version bump, model change all land here).
    prev_fp = store.get_meta("embedder_fingerprint")
    if prev_fp and prev_fp != embedder.fingerprint:
        log.info("embedder fingerprint drift (%s -> %s): requeuing all embeddings",
                 prev_fp[:24], embedder.fingerprint[:24])
        with store.write_txn() as db:
            db.execute("UPDATE chunks SET needs_embedding = 1, enrichment_hash = NULL")
    if splade is not None:
        prev_sp = store.get_meta("splade_fingerprint")
        if prev_sp and prev_sp != splade.fingerprint:
            log.info("splade fingerprint drift: re-encoding sparse vectors")
            with store.write_txn() as db:
                db.execute("DELETE FROM sparse_vectors")

    # Record the embedder identity so later opens (cross-project search,
    # daemon restarts) reuse the model this index was built with.
    store.set_meta("embedder_model", embedder.preset.name)
    store.set_meta("embedder_dim", str(embedder.dim))
    store.set_meta("embedder_fingerprint", embedder.fingerprint)
    if splade is not None:
        store.set_meta("splade_model", splade.preset.name)
        store.set_meta("splade_fingerprint", splade.fingerprint)

    # -- stage 1: enumerate + staleness pre-filter -------------------------
    registered = store.registered_origins()
    drifted = set(store.stale_parser_origins())   # parser-version requeue
    seen_origins: set[str] = set()
    to_parse: list[Path] = []
    with span("enumerate"):
        for f in enumerate_files(root, lim, extra_ignore=config.ignore if config else None):
            origin = str(f.relative_to(root))
            seen_origins.add(origin)
            stats.files_seen += 1
            if not force and origin not in drifted:
                fp = registered.get(origin)
                if fp is not None:
                    try:
                        if fp.matches_stat(os.stat(f)):
                            stats.files_skipped += 1
                            continue
                        if fp.digest == fingerprint_file(f).digest:
                            stats.files_skipped += 1
                            continue
                    except OSError:
                        pass
            to_parse.append(f)

    # removed files
    for origin in set(registered) - seen_origins:
        store.remove_origin(origin)
        stats.files_removed += 1

    # -- stage 2: parse (host thread fan-out) ------------------------------
    results = []
    with span("parse", files=len(to_parse)):
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            futs = {pool.submit(parse_file, f, root, lim): f for f in to_parse}
            for fut in concurrent.futures.as_completed(futs):
                r = fut.result()
                f = futs[fut]
                if r is None:
                    continue
                results.append((f, r))
    results.sort(key=lambda fr: str(fr[0]))

    # -- stage 3: windowing + NL + upsert ----------------------------------
    with span("upsert"):
        for f, r in results:
            stats.files_parsed += 1
            if r.errors:
                stats.parse_errors += len(r.errors)
            chunks = apply_windowing(r.chunks, embedder, lim)
            nls = [generate_nl(c, embedder.max_seq_len) for c in chunks]
            keep = {c.id for c in chunks}
            stats.chunks_deleted += store.delete_chunks_for_origin(r.origin, keep_ids=keep)
            store.upsert_chunks(chunks, nls=nls, nls_base=nls)
            stats.chunks_upserted += len(chunks)
            store.put_fingerprint(r.origin, fingerprint_file(f), len(chunks), r.errors or None)
            if progress:
                progress(stats)

    # -- stage 4: embed (device hot loop, canonical-hash reuse) ------------
    _embed_pending(store, embedder, cache, stats)

    # -- stage 5: enrichment pass (call-graph context -> re-embed) ---------
    if with_enrichment:
        run_enrichment_pass(store, embedder, stats=stats, lim=lim)

    # -- stage 6: SPLADE sparse vectors ------------------------------------
    if splade is not None and not lim.disable_splade:
        _encode_sparse(store, splade, stats)

    stats.elapsed_s = time.time() - t0
    return stats


def _embed_pending(store: Store, embedder: Embedder, cache: EmbeddingCache,
                   stats: IndexStats) -> None:
    pending = store.pending_embeddings()
    if not pending:
        return
    fp = embedder.fingerprint
    with span("embed", n=len(pending)):
        batch_ids: list[str] = []
        batch_nl: list[str] = []
        batch_nl_base: list[str] = []
        reused: list[tuple[str, np.ndarray]] = []
        canon_of: dict[str, str] = {}
        hashes = [content_hash(nl) for _, nl, _ in pending]
        cached_map = cache.get_batch(list(set(hashes)), fp)
        for (cid, nl, nl_base), nl_hash in zip(pending, hashes):
            cached = cached_map.get(nl_hash)
            if cached is not None and len(cached) == embedder.dim:
                reused.append((cid, cached))
                stats.embed_reused += 1
                continue
            canon_of[cid] = nl_hash
            batch_ids.append(cid)
            batch_nl.append(nl)
            batch_nl_base.append(nl_base)

        if reused:
            ids_r = [cid for cid, _ in reused]
            vecs_r = np.stack([v for _, v in reused])
            for s in range(0, len(ids_r), 1024):
                store.put_embeddings(ids_r[s : s + 1024], vecs_r[s : s + 1024],
                                     vecs_r[s : s + 1024])

        B = 512
        for s in range(0, len(batch_ids), B):
            ids = batch_ids[s : s + B]
            vecs = embedder.embed_documents(batch_nl[s : s + B])
            base_texts = batch_nl_base[s : s + B]
            same = all(a == b for a, b in zip(batch_nl[s : s + B], base_texts))
            vecs_base = vecs if same else embedder.embed_documents(base_texts)
            store.put_embeddings(ids, vecs, vecs_base)
            cache.put_batch([(canon_of[cid], fp, vecs[i]) for i, cid in enumerate(ids)])
            stats.embedded += len(ids)


def run_enrichment_pass(store: Store, embedder: Embedder,
                        stats: IndexStats | None = None,
                        lim: Limits | None = None) -> int:
    """Second embed pass: fold caller/callee names into NL and re-embed the
    enriched column in place. Idempotent via enrichment_hash (hash of the
    enriched NL): unchanged context costs nothing.
    """
    lim = lim or default_limits
    stats = stats or IndexStats()
    skipped = set((lim.disable_enrichment or "").split(","))
    if "callgraph" in skipped:
        return 0

    # caller adjacency: callee_name -> caller chunk names
    callers_of: dict[str, list[str]] = {}
    callees_of: dict[str, list[str]] = {}
    for caller_id, callee_name, in store.db.execute(
            "SELECT caller_id, callee_name FROM function_calls"):
        callees_of.setdefault(caller_id, []).append(callee_name)
    name_of: dict[str, str] = {}
    ids_by_name: dict[str, list[str]] = {}
    for cid, name in store.db.execute("SELECT id, name FROM chunks"):
        name_of[cid] = name
        ids_by_name.setdefault(name, []).append(cid)
    for caller_id, callees in callees_of.items():
        caller_name = name_of.get(caller_id, "")
        for callee in callees:
            for target in ids_by_name.get(callee, []):
                callers_of.setdefault(target, []).append(caller_name)

    df = compute_callee_doc_freq(list(callees_of.values()))
    summaries = store.get_summaries()

    to_embed_ids: list[str] = []
    to_embed_nl: list[str] = []
    with span("enrich_nl"):
        with store.write_txn() as db:
            rows = list(db.execute(
                "SELECT id, origin, name, parent_name, chunk_type, language, line_start, "
                "line_end, signature, doc, body, return_type, is_test, enrichment_hash "
                "FROM chunks WHERE embedding IS NOT NULL"))
            for (cid, origin, name, parent_name, ctype, language, ls, le, sig, doc,
                 body, ret, is_test, old_hash) in rows:
                ctx = CallContext(
                    callers=sorted(set(callers_of.get(cid, [])))[: lim.nl_max_callers * 2],
                    callees=list(dict.fromkeys(callees_of.get(cid, []))))
                if not ctx.callers and not ctx.callees and cid not in summaries:
                    continue
                chunk = Chunk(origin=origin, name=name, chunk_type=ChunkType(ctype),
                              language=language, line_start=ls, line_end=le, body=body,
                              signature=sig, doc=doc, parent_name=parent_name,
                              return_type=ret, is_test=bool(is_test))
                summary, hyde = summaries.get(cid, (None, None))
                nl = generate_nl_enriched(chunk, ctx, callee_doc_freq=df,
                                          summary=summary, hyde=hyde,
                                          max_seq_len=embedder.max_seq_len, lim=lim)
                h = content_hash(nl)
                if h == old_hash:
                    continue
                db.execute("UPDATE chunks SET nl = ?, enrichment_hash = ? WHERE id = ?",
                           (nl, h, cid))
                to_embed_ids.append(cid)
                to_embed_nl.append(nl)

    with span("enrich_embed", n=len(to_embed_ids)):
        B = 512
        for s in range(0, len(to_embed_ids), B):
            ids = to_embed_ids[s : s + B]
            vecs = embedder.embed_documents(to_embed_nl[s : s + B])
            with store.write_txn() as db:
                for i, cid in enumerate(ids):
                    db.execute("UPDATE chunks SET embedding = ? WHERE id = ?",
                               (np.asarray(vecs[i], dtype="<f4").tobytes(), cid))
            stats.enriched += len(ids)
    return stats.enriched


def _encode_sparse(store: Store, splade: SpladeEncoder, stats: IndexStats) -> None:
    missing = store.missing_sparse()
    if not missing:
        return
    with span("splade", n=len(missing)):
        B = 128
        for s in range(0, len(missing), B):
            batch = missing[s : s + B]
            ids_batch, w_batch = splade.encode_batch([nl for _, nl in batch])
            store.put_sparse_batch([
                (cid, ids_batch[i], w_batch[i]) for i, (cid, _) in enumerate(batch)])
            stats.sparse_encoded += len(batch)
