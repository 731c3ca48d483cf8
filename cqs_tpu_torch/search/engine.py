"""The search engine: index lifecycle and the default solo search path.

Port of ``cqs_tpu/search/engine.py`` with the same method names. The host
stages (classification, FTS legs, hydration, scoring, leg fusion and rescue)
are the reference's code run over the shared router/scoring/store modules;
what changes is the device side. Indexes live on the engine's explicit
``device``, and ``_device_query`` runs the port's hybrid program
(``search/program.py``) there. The reference's CPU-host BLAS branch has no
counterpart: on the CPU the same device program runs with the plain scans.

Not on this slice (they raise or are absent): the worktree overlay, the
ANN/graph tiers, mesh sharding, the int8 (q8/sk8) and screened programs,
rerank, tiered serving and ``refresh_incremental``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from cqs_tpu.config import Config, Limits, limits as default_limits
from cqs_tpu.index.stamp import Stamp, StampMismatch
from cqs_tpu.parser.types import ChunkType
from cqs_tpu.search.router import (
    Category, CentroidClassifier, Classification, Strategy, classify_query,
    reclassify_with_centroid, resolve_alpha,
)
from cqs_tpu.search.scoring import (
    Candidate, ScoringContext, dedup_exact_duplicates, dedup_windows,
    mmr_diversify, rrf_with_fts, score_candidate,
)
from cqs_tpu.store import QueryCache, Store
from cqs_tpu.store.store import ChunkRow
from cqs_tpu.utils.trace import get_tracer, span
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.index import DenseIndex, SpladeIndex
from cqs_tpu_torch.models import Embedder, SpladeEncoder
from cqs_tpu_torch.search.program import dense_query, hybrid_query, trim_query_terms

log = get_tracer("search")

DENSE_FILE = "dense.npz"
DENSE_BASE_FILE = "dense_base.npz"
SPLADE_FILE = "splade.npz"
CENTROIDS_FILE = "classifier_centroids.json"

#: knob -> value the slice supports; anything else is a path not yet ported
_UNPORTED_KNOBS = {"index_kind": "exact", "mesh_shards": 0, "scan_q8": 0,
                   "screen_enable": 0}


def bf16_extraction(capacity: int, batch: int, knob: str = "grouped",
                    min_rows: int = 131072) -> str:
    """In-kernel top-k extraction for the bf16 scans (``engine.py:1364``):
    "grouped" for batched queries on corpora of at least ``min_rows``
    padded rows when the ``scan_extraction`` knob asks for it, "loop" (the
    exact per-tile top-k) otherwise; B=1 always takes "loop"."""
    if batch > 1 and knob == "grouped" and capacity >= min_rows:
        return "grouped"
    return "loop"


def _normalized_digest(body: str) -> str:
    import hashlib

    return hashlib.blake2b(" ".join(body.split()).encode(),
                           digest_size=12).hexdigest()


def _doc_demote_leg(leg: list[tuple[str, float]],
                    exempt_ids: frozenset[str] | set[str] = frozenset()
                    ) -> list[tuple[str, float]]:
    """Stable-partition a leg: code-origin rows first, prose-file rows after.
    Chunk ids are ``{origin}:{line}:{hash}`` so the origin suffix test needs
    no hydration. ``exempt_ids`` (doc chunks whose identifier-shaped name the
    query mentions — see ``scoring.doc_demotion_exempt``) keep their place in
    the code class."""
    from cqs_tpu.search.scoring import _DOC_ORIGIN_RE

    if not leg:
        return leg

    def _is_doc(t):
        return (_DOC_ORIGIN_RE.search(t[0].rsplit(":", 2)[0])
                and t[0] not in exempt_ids)

    code = [t for t in leg if not _is_doc(t)]
    if len(code) == len(leg):
        return leg
    docs = [t for t in leg if _is_doc(t)]
    return code + docs


@dataclass
class SearchHit:
    row: ChunkRow
    score: float
    signals: dict = field(default_factory=dict)

    def to_dict(self, include_body: bool = False) -> dict:
        d = {
            "id": self.row.id,
            "name": self.row.qualified_name,
            "origin": self.row.origin,
            "line_start": self.row.line_start,
            "line_end": self.row.line_end,
            "chunk_type": self.row.chunk_type,
            "language": self.row.language,
            "score": round(self.score, 6),
            "signals": self.signals,
        }
        if include_body:
            d["body"] = self.row.body
        else:
            d["signature"] = self.row.signature
        return d


@dataclass
class SearchResult:
    hits: list[SearchHit]
    category: str
    strategy: str
    alpha: float
    elapsed_ms: float
    meta: dict = field(default_factory=dict)



class SearchEngine:
    """Owns the store handle, models and device indexes for one slot."""

    def __init__(self, store: Store, embedder: Embedder,
                 splade: SpladeEncoder | None = None,
                 slot_dir: str | Path | None = None,
                 config: Config | None = None,
                 lim: Limits | None = None,
                 root: str | Path | None = None, *,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.store = store
        self.embedder = embedder
        self.splade = splade
        self.slot_dir = Path(slot_dir) if slot_dir else store.path.parent
        self.lim = lim or (config.limits if config else default_limits)
        self.config = config
        self.root = Path(root) if root else (config.root if config else None)
        for knob, want in _UNPORTED_KNOBS.items():
            if getattr(self.lim, knob) != want:
                raise NotImplementedError(
                    f"knob {knob}={getattr(self.lim, knob)!r} selects a path not "
                    f"yet ported to cqs_tpu_torch (see ROADMAP)")
        self.dense: DenseIndex | None = None
        self.dense_base: DenseIndex | None = None
        self.sparse: SpladeIndex | None = None
        self._code_masks: dict = {}  # (index id, digest[, "device"]) -> (token, mask)
        # slot-local centroids win; otherwise the packaged artifact, gated on
        # an exact embedder-fingerprint match
        self.centroids: CentroidClassifier | None = CentroidClassifier.load(
            self.slot_dir / CENTROIDS_FILE)
        if self.centroids is None:
            self.centroids = CentroidClassifier.load_packaged(self.embedder.fingerprint)
        self.query_cache = QueryCache(self.slot_dir / "query_cache.db")
        self._row_of: dict[str, int] = {}
        # FTS legs prefetch: one worker with its own read connection so the
        # legs overlap the device program
        from concurrent.futures import ThreadPoolExecutor

        self._legs_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fts-legs")
        self._legs_store: Store | None = None
        self._legs_cache: dict = {}
        self._legs_cache_gen = -1
        self._result_cache: dict = {}
        self._result_cache_tok = None
        self._digest_cache: dict[str, str] = {}

    def close(self) -> None:
        self._legs_pool.shutdown(wait=True)

    # -- index lifecycle ---------------------------------------------------

    def load_or_build_indexes(self, build_base: bool = True) -> None:
        """Load persisted artifacts when stamps match the live store;
        otherwise rebuild from the store's embeddings."""
        with span("load_or_build_indexes"):
            self.dense = self._load_or_build_dense(DENSE_FILE, base=False)
            if build_base and not self.lim.disable_base_index:
                self.dense_base = self._load_or_build_dense(DENSE_BASE_FILE, base=True)
            if self.splade is not None and not self.lim.disable_splade:
                self.sparse = self._load_or_build_sparse()
            self._row_of = self.dense.row_of if self.dense else {}
            # pre-warm the host lexical index off-thread (lexical tier only)
            if self.embedder.preset.lexical_tier and self.lim.host_lexical:
                self._legs_pool.submit(self._get_host_lex)

    def _load_or_build_dense(self, filename: str, base: bool) -> DenseIndex | None:
        kind = "dense_base" if base else "dense"
        expect = self._expected_stamp(kind)
        path = self.slot_dir / filename
        if path.exists():
            try:
                return DenseIndex.load(path, expect=expect, device=self.device)
            except (StampMismatch, OSError, ValueError, KeyError) as e:
                log.info("dense index %s stale (%s); rebuilding", filename, e)
        ids, mat = self.store.load_embeddings(base=base)
        if not ids:
            if base:
                return None
            mat = np.zeros((0, self.embedder.dim), np.float32)
        idx = DenseIndex(ids, mat, expect, device=self.device)
        if ids:
            idx.save(path)
        return idx

    def _load_or_build_sparse(self) -> SpladeIndex | None:
        expect = self._expected_stamp("splade")
        path = self.slot_dir / SPLADE_FILE
        if path.exists():
            try:
                idx = SpladeIndex.load(path, expect=expect, device=self.device)
                if self.dense is None or idx.ids_digest == self.dense.ids_digest:
                    return idx
                log.info("splade index id-misaligned with dense; rebuilding")
            except (StampMismatch, OSError, ValueError, KeyError) as e:
                log.info("splade index stale (%s); rebuilding", e)
        rows = self.store.load_sparse()
        if not rows:
            return None
        # build in the dense index's row order so rows align by construction
        by_id = {r[0]: r for r in rows}
        order = self.dense.ids if self.dense is not None else [r[0] for r in rows]
        T = self.lim.splade_doc_terms
        doc_ids = np.zeros((len(order), T), np.int32)
        doc_w = np.zeros((len(order), T), np.float32)
        for i, cid in enumerate(order):
            r = by_id.get(cid)
            if r is None:
                continue
            _, t, w = r
            n = min(len(t), T)
            doc_ids[i, :n] = t[:n]
            doc_w[i, :n] = w[:n]
        idx = SpladeIndex(list(order), doc_ids, doc_w, self.splade.vocab_size, expect,
                          device=self.device)
        idx.save(path)
        return idx

    def refresh_incremental(self) -> dict:
        raise NotImplementedError("refresh_incremental is not yet ported (ROADMAP)")

    # -- filters -----------------------------------------------------------

    def _device_code_valid(self, index: DenseIndex, code: np.ndarray) -> torch.Tensor:
        """Device-resident ``index.mask * code`` (padded), cached beside the
        host code mask so repeat default searches upload nothing."""
        key = (id(index), index.ids_digest, "device")
        gen = self.store.coherence_token()
        cached = self._code_masks.get(key)
        if cached is not None and cached[0] == gen and cached[2] is index.mask:
            return cached[1]
        fm = np.zeros(index.capacity, np.int32)
        fm[: len(code)] = code
        valid = index.mask * torch.from_numpy(fm).to(self.device)
        self._code_masks[key] = (gen, valid, index.mask)
        return valid

    # -- the pipeline ------------------------------------------------------

    def search(self, query: str, limit: int = 10,
               path_filter: str | None = None, lang_filter: str | None = None,
               chunk_types: list[ChunkType] | None = None,
               alpha_override: float | None = None,
               rerank: bool = False,
               use_overlay: bool = False,
               include_docs: bool = False) -> SearchResult:
        """Default search is code-only (section/module/config chunks are
        excluded unless ``include_docs`` or a ``chunk_types`` filter names
        them), as in the reference. ``meta["device_ms"]`` is the host-clock
        time of the device program including its result transfer."""
        if rerank:
            raise NotImplementedError("rerank is not yet ported (ROADMAP)")
        if use_overlay:
            raise NotImplementedError("the worktree overlay is not yet ported (ROADMAP)")
        t0 = time.perf_counter()
        if self.dense is None:
            self.load_or_build_indexes()
        code_only = not include_docs and chunk_types is None
        rkey = self.result_cache_key(query, limit, path_filter, lang_filter,
                                     chunk_types, alpha_override, rerank,
                                     use_overlay, include_docs)
        cached = self.cached_result(rkey)
        if cached is not None:
            return cached
        cls = classify_query(query)
        meta: dict = {}

        # NameOnly short-circuit: an exact name match wins outright; partial
        # FTS name hits fall through to the full hybrid
        if cls.strategy is Strategy.NAME_ONLY and not (path_filter or lang_filter or chunk_types):
            rows = self.store.search_by_name_fts(cls.name_query or query, limit=limit)
            if rows:
                from cqs_tpu.utils.text import normalize_for_fts

                nq = normalize_for_fts(cls.name_query or query)
                if normalize_for_fts(rows[0].name.split("#w")[0]) == nq:
                    hits = [SearchHit(r, 1.0 - i * 1e-3, {"leg": "fts_name"})
                            for i, r in enumerate(rows)]
                    res = SearchResult(hits, cls.category.value, cls.strategy.value, 1.0,
                                       (time.perf_counter() - t0) * 1e3, meta)
                    self._cache_result(rkey, res)
                    return res
                meta["name_only_fallthrough"] = True

        q_vec = self._embed_query_cached(query)
        cls = reclassify_with_centroid(cls, q_vec, self.centroids, self.lim)
        overrides = self._alpha_overrides()
        alpha = (alpha_override if alpha_override is not None
                 else resolve_alpha(cls, overrides, self.lim))

        index = self._pick_dense_index(cls)
        if index is None or index.count == 0:
            return SearchResult([], cls.category.value, cls.strategy.value, alpha,
                                (time.perf_counter() - t0) * 1e3, {"empty_index": True})

        pool = min(max(limit * self.lim.candidate_pool_mult, self.lim.candidate_pool_floor),
                   index.capacity)
        fmask = self._filter_mask(index, path_filter, lang_filter, chunk_types)
        legs_future, full_rrf = self._start_legs(query, cls)

        t_dev = time.perf_counter()
        with span("device_query", pool=pool, n=index.count):
            fused, rows, d_leg, s_leg = self._device_query(index, q_vec, query, alpha,
                                                           pool, fmask, code_only=code_only)
        meta["device_ms"] = (time.perf_counter() - t_dev) * 1e3

        # hydrate + host scoring; the cosine-threshold drop is one vectorized
        # mask here, so dropped rows never pay hydration
        thresh = self.lim.score_threshold
        cand_ids: list[str] = []
        keep: list[int] = []
        droppable = ((d_leg > -1e30) & (d_leg < thresh) if d_leg is not None
                     else np.zeros(len(rows), bool))
        for i, r in enumerate(rows):
            if r < 0 or r >= index.count or fused[i] <= -1e30 or droppable[i]:
                continue
            cid = index.ids[r]
            if cid:
                cand_ids.append(cid)
                keep.append(i)
        by_id = {c.id: c for c in self.store.get_chunks_by_ids(cand_ids, meta_only=True)}

        from cqs_tpu.search.router import extract_lang_hints
        ctx = ScoringContext(
            query=query, type_hints=cls.type_hints,
            lang_hints=extract_lang_hints(query),
            note_mentions=self.store.note_mentions(query.split()),
            path_filter=path_filter, lang_filter=lang_filter, lim=self.lim,
            category=cls.category.value, code_only=code_only,
            include_types=(frozenset(ct.value for ct in chunk_types)
                           if chunk_types else None))
        cands: list[Candidate] = []
        for j, cid in zip(keep, cand_ids):
            row = by_id.get(cid)
            if row is None:
                continue
            c = Candidate(row=row, fused=float(fused[j]),
                          dense=float(d_leg[j]) if d_leg is not None else None,
                          sparse=float(s_leg[j]) if s_leg is not None else None)
            if score_candidate(c, ctx):
                cands.append(c)

        hits = self._host_stage(query, cls, cands, ctx, limit, q_vec, index,
                                legs_future, full_rrf, meta)
        meta["pool"] = pool
        meta["centroid_rerouted"] = cls.rerouted_by_centroid
        res = SearchResult(hits, cls.category.value, cls.strategy.value, alpha,
                           (time.perf_counter() - t0) * 1e3, meta)
        self._cache_result(rkey, res)
        return res

    def _device_query(self, index: DenseIndex, q_vec: np.ndarray, query: str,
                      alpha: float, pool: int, fmask: np.ndarray | None,
                      code_only: bool = False):
        """The device program for one query: the hybrid program when the
        sparse index is row-aligned with ``index`` and alpha < 1, else the
        dense-only program. Returns host numpy (fused, rows, dense leg,
        sparse leg or None)."""
        code = self._code_mask(index) if code_only else None
        cmask = fmask
        if code is not None:
            cmask = code if cmask is None else cmask * code
        valid = index.mask
        if cmask is not None:
            if fmask is None:
                valid = self._device_code_valid(index, code)
            else:
                fm = np.zeros(index.capacity, np.int32)
                fm[: len(cmask)] = cmask
                valid = valid * torch.from_numpy(fm).to(self.device)
        q_t = torch.from_numpy(np.array(q_vec, np.float32)).to(self.device)
        sparse_ok = (self.sparse is not None and alpha < 1.0
                     and self.sparse.capacity == index.capacity
                     and self.sparse.ids_digest == index.ids_digest)
        if sparse_ok:
            q_ids, q_w = self.splade.encode(query, is_query=True)
            q_ids2, q_w2 = trim_query_terms(q_ids[None], q_w[None])
            fused, rows, d_leg, s_leg = hybrid_query(
                index.matrix, self.sparse.packed_terms(), None, self.sparse.sketch,
                valid, q_t, torch.from_numpy(q_ids2[0]).to(self.device),
                torch.from_numpy(q_w2[0]).to(self.device), alpha, pool,
                self.sparse.vocab_size, sketch_candidates=self._sketch_candidates(fmask),
                extraction=bf16_extraction(index.capacity, 1, self.lim.scan_extraction,
                                           self.lim.scan_q8_min_rows))
            return (fused.cpu().numpy(), rows.cpu().numpy(), d_leg.cpu().numpy(),
                    s_leg.cpu().numpy())
        vals, rows = dense_query(index.matrix, valid, q_t, pool)
        vals = vals.cpu().numpy()
        return vals, rows.cpu().numpy(), vals, None


    # -- host stages shared verbatim with the reference engine ---------------

    def _body_digest(self, cid: str) -> str | None:
        d = self._digest_cache.get(cid)
        if d is None:
            row = self.store._read_db().execute(
                "SELECT body FROM chunks WHERE id = ?", (cid,)).fetchone()
            d = _normalized_digest(row[0] if row else "")
            self._digest_cache[cid] = d
        return d

    def _prefetch_digests(self, cids: list[str]) -> None:
        """Batch-hydrate missing body digests in one query per ~500 ids: the
        per-id SELECT in ``_body_digest`` cost ~31 ms/query on a cold cache
        (500 point queries); warm queries skip the round trip entirely."""
        missing = [c for c in cids if c not in self._digest_cache]
        if not missing:
            return
        db = self.store._read_db()
        for i in range(0, len(missing), 500):
            batch = missing[i:i + 500]
            q = ",".join("?" * len(batch))
            for cid, body in db.execute(
                    f"SELECT id, body FROM chunks WHERE id IN ({q})", batch):
                self._digest_cache[cid] = _normalized_digest(body or "")

    def _fts_legs(self, query: str, depth: int, syn, core: str = "",
                  struct_q: str = "") -> tuple[list, list, list, list, list]:
        # generation alone only moves on DELETEs; the token adds MAX(rowid)
        # so incremental appends invalidate too (cached behind data_version)
        gen = self.store.coherence_token()
        if self._legs_cache_gen != gen:
            self._legs_cache = {}
            self._legs_cache_gen = gen
        # syn must be in the key: the directional SQL bridge makes the
        # overlay query-dependent, and the sweep harness flips its knob
        # in-process — without this a knob flip would serve arm-stale legs
        syn_fp = (tuple(sorted((k, tuple(v)) for k, v in syn.items()))
                  if syn else None)
        ck = (query, depth, core, struct_q, syn_fp)
        hit = self._legs_cache.get(ck)
        if hit is not None:
            return hit
        out = self._fts_legs_uncached(query, depth, syn, core, struct_q)
        if len(self._legs_cache) >= 2048:       # bound daemon memory
            self._legs_cache.clear()
        self._legs_cache[ck] = out
        return out

    def _get_host_lex(self):
        """Per-coherence-token host lexical index (index/lexical.py): the
        FTS legs as in-memory posting walks at FTS5-parity bm25. Built once
        per store state (~seconds at 35k chunks), then each leg is ~1 ms vs
        13-25 ms through SQLite MATCH — on a 1-core daemon the legs were the
        single largest cold-query cost."""
        if not self.lim.host_lexical:
            return None
        tok = self.store.coherence_token()
        cached = getattr(self, "_host_lex", None)
        if cached is not None and cached[0] == tok:
            return cached[1]
        from cqs_tpu.index.lexical import HostLexicalIndex

        try:
            lex = HostLexicalIndex.from_store(self.store)
        except Exception as e:                 # pragma: no cover - degraded db
            log.warning("host lexical build failed (%s); SQLite legs", e)
            lex = None
        self._host_lex = (tok, lex)
        return lex

    def _get_sig_index(self):
        """Per-coherence-token scored signature index
        (index/lexical.py::SignatureIndex) for the structural/type-filtered
        signature-predicate leg. ~0.3 s to build at 35k chunks, then sub-ms
        per query."""
        tok = self.store.coherence_token()
        cached = getattr(self, "_sig_index", None)
        if cached is not None and cached[0] == tok:
            return cached[1]
        from cqs_tpu.index.lexical import SignatureIndex

        try:
            idx = SignatureIndex.from_store(self.store)
        except Exception as e:             # pragma: no cover - degraded db
            log.warning("signature index build failed (%s); leg off", e)
            idx = None
        self._sig_index = (tok, idx)
        return idx

    def _get_canon_map(self) -> dict:
        """Per-coherence-token {chunk id -> canonical_hash} for the
        quotation-twin collapse (one 35k-row scan, then dict lookups)."""
        tok = self.store.coherence_token()
        cached = getattr(self, "_canon_map", None)
        if cached is not None and cached[0] == tok:
            return cached[1]
        m = dict(self.store._read_db().execute(
            "SELECT id, canonical_hash FROM chunks WHERE parent_id IS NULL"))
        self._canon_map = (tok, m)
        return m

    def _fts_legs_uncached(self, query: str, depth: int, syn, core: str = "",
                           struct_q: str = "") -> tuple[list, list, list, list, list]:
        lex = self._get_host_lex()
        if lex is not None:
            fts = lex.search(query, limit=depth, synonyms=syn)
            body = lex.search(query, limit=depth, synonyms=syn, scope="body")
            core_leg = lex.search(core, limit=depth, synonyms=syn) if core else []
            struct_leg = (lex.search(struct_q, limit=depth, scope="body",
                                     require_all=True) if struct_q else [])
            stem_leg: list = []
            if self.lim.stem_leg_weight > 0:
                from cqs_tpu.search.synonyms import stem_prefix

                if any(stem_prefix(t) for t in query.lower().split()):
                    stem_leg = lex.search(query, limit=depth, synonyms=syn,
                                          stems="all")
            return fts, body, core_leg, struct_leg, stem_leg
        st = self._legs_store
        if st is None:
            try:
                # the df-filter's fts5vocab shadow tables need a writable
                # connection to spring into existence — create them on the
                # main store first so the read-only clone can use them
                self.store._fts_term_df("chunks_fts", ["__warm__"])
                self.store._fts_term_df("chunks_fts_body", ["__warm__"])
                st = Store(self.store.path, readonly=True)
            except Exception:          # in-memory / exotic stores: fall back
                st = self.store
            self._legs_store = st
        fts = st.fts_search(query, limit=depth, synonyms=syn)
        body = st.fts_search(query, limit=depth, synonyms=syn, scope="body")
        # cross-language concept-core leg: the same FTS index queried with
        # the language names / X-vs-Y scaffolding stripped, so the concept
        # terms alone rank (r3 triage: they are what the gold matches on)
        core_leg = st.fts_search(core, limit=depth, synonyms=syn) if core else []
        # structural AND leg: every structural token must appear in the body
        # (high precision; see router.structural_terms)
        struct_leg = (st.fts_search(struct_q, limit=depth, scope="body",
                                    require_all=True) if struct_q else [])
        # stem rescue leg: the whole query with every stemmable term widened
        # to its FTS5 stem-prefix — catches golds whose identifiers are
        # morphological variants of the query words ('embeds'->embed_batch;
        # r3 dev triage: the dominant no-leg-reaches-the-gold cause). Only
        # materializes when stemming actually changes a term, and joins the
        # fusion at stem_leg_weight (low) so its looser bm25 can't dilute
        # the exact legs.
        stem_leg: list = []
        if self.lim.stem_leg_weight > 0:
            from cqs_tpu.search.synonyms import stem_prefix

            if any(stem_prefix(t) for t in query.lower().split()):
                stem_leg = st.fts_search(query, limit=depth, synonyms=syn,
                                         stems="all")
        return fts, body, core_leg, struct_leg, stem_leg

    def _expected_stamp(self, kind: str) -> Stamp:
        fp = (self.splade.fingerprint if kind == "splade" and self.splade
              else self.embedder.fingerprint)
        dim = (self.splade.vocab_size if kind == "splade" and self.splade
               else self.embedder.dim)
        return Stamp(model_fingerprint=fp, dim=dim,
                     chunk_count=self.store.chunk_count(),
                     generation=self.store.generation, kind=kind)

    def _code_mask(self, index: DenseIndex) -> np.ndarray | None:
        """[count] mask of CODE rows (non-section/module/config; window rows
        classify by their parent), cached per (index, store generation).
        This is the reference's default include filter
        (ChunkType::code_types(), src/language/mod.rs:862)."""
        gen = self.store.coherence_token()
        key = (id(index), index.ids_digest)
        cached = self._code_masks.get(key)
        if cached is not None and cached[0] == gen:
            return cached[1]
        from cqs_tpu.parser.types import NON_CODE_TYPES

        q = ",".join("?" * len(NON_CODE_TYPES))
        mask = np.ones(index.count, dtype=np.int32)
        row_of = index.row_of
        hit = 0
        for (cid,) in self.store.db.execute(
                "SELECT c.id FROM chunks c "
                "LEFT JOIN chunks p ON c.parent_id = p.id "
                f"WHERE COALESCE(p.chunk_type, c.chunk_type) IN ({q})",
                NON_CODE_TYPES):
            r = row_of.get(cid)
            if r is not None:
                mask[r] = 0
                hit += 1
        if hit == 0:
            mask = None            # all-code corpus: no masking needed
        if len(self._code_masks) > 8:
            self._code_masks.clear()
        self._code_masks[key] = (gen, mask)
        return mask

    def _filter_mask(self, index: DenseIndex, path_filter: str | None,
                     lang_filter: str | None,
                     chunk_types: list[ChunkType] | None) -> np.ndarray | None:
        """SQL-side filter -> [count] mask in THE GIVEN index's row order
        (dense and dense_base number rows independently). None = no filter."""
        if not (path_filter or lang_filter or chunk_types):
            return None
        where, params = [], []
        if lang_filter:
            where.append("c.language = ?")
            params.append(lang_filter)
        if chunk_types:
            # windows classify by their parent's type (a window of a long
            # function must survive a `--type function` filter)
            q = ",".join("?" * len(chunk_types))
            where.append(f"COALESCE(p.chunk_type, c.chunk_type) IN ({q})")
            params.extend(ct.value for ct in chunk_types)
        if path_filter:
            where.append("c.origin LIKE ?")
            params.append(f"%{path_filter.strip('*')}%")
        sql = ("SELECT c.id FROM chunks c LEFT JOIN chunks p "
               "ON c.parent_id = p.id WHERE " + " AND ".join(where))
        row_of = index.row_of
        mask = np.zeros(index.count, dtype=np.int32)
        for (cid,) in self.store.db.execute(sql, params):
            r = row_of.get(cid)
            if r is not None:
                mask[r] = 1
        return mask

    def result_cache_key(self, query: str, limit: int, path_filter=None,
                         lang_filter=None, chunk_types=None,
                         alpha_override=None, rerank: bool = False,
                         use_overlay: bool = False, include_docs: bool = False):
        """Key for the full-result cache, or None when the request is not
        cacheable (worktree overlay state lives outside the store token)."""
        if use_overlay:
            return None
        tok = self.store.coherence_token()
        if self._result_cache_tok != tok:
            self._result_cache = {}
            self._result_cache_tok = tok
        # knob state is part of the behavior: env and overrides can change
        # mid-process (sweep harness, tests) — fingerprint the full snapshot
        # so a knob flip can never serve a stale ordering
        knobs = hash(tuple(sorted((k, repr(v))
                                  for k, v in self.lim.snapshot().items())))
        return (query, limit, path_filter, lang_filter,
                tuple(chunk_types) if chunk_types else None,
                alpha_override, rerank, knobs, include_docs,
                id(getattr(self, "_reranker", None)))

    def cached_result(self, key) -> "SearchResult | None":
        if key is None:
            return None
        hit = self._result_cache.get(key)
        if hit is None:
            return None
        return SearchResult(list(hit.hits), hit.category, hit.strategy,
                            hit.alpha, hit.elapsed_ms,
                            dict(hit.meta, result_cache=True))

    def _cache_result(self, key, result: "SearchResult") -> None:
        if key is None:
            return
        if len(self._result_cache) >= 1024:
            self._result_cache.clear()
        self._result_cache[key] = result

    def _start_legs(self, query: str, cls):
        """Kick off the FTS leg prefetch for the lexical tier.

        Returns ``(legs_future, full_rrf)``; ``(None, False)`` when the tier
        has no FTS legs. Shared by the solo path and the micro-batcher so the
        two paths cannot drift.
        """
        from cqs_tpu.search.router import LEXICAL_RRF_CATEGORIES
        from cqs_tpu.search.synonyms import (BRIDGE, BRIDGE_CATEGORIES,
                                             sql_bridge_overlay)

        if not self.embedder.preset.lexical_tier:
            return None, False
        full_rrf = cls.category.value in LEXICAL_RRF_CATEGORIES
        syn = self.config.synonyms if self.config else None
        if cls.category.value in BRIDGE_CATEGORIES:
            # concept-bridge overlay, category-scoped; the directional SQL
            # bridge beats the generic one, the user overlay beats both
            overlay = dict(BRIDGE)
            if self.lim.sql_bridge:
                sqlb = sql_bridge_overlay(query)
                if sqlb:
                    overlay.update(sqlb)
            syn = {**overlay, **(syn or {})}
        depth = self.lim.rrf_leg_depth if full_rrf else 100
        core = struct_q = ""
        if (cls.category.value == "cross_language"
                and self.lim.xlang_core_weight > 0):
            from cqs_tpu.search.router import concept_core

            core = concept_core(query)
        if (cls.category.value == "structural"
                and self.lim.struct_and_weight > 0):
            from cqs_tpu.search.router import structural_terms

            struct_q = structural_terms(query)
        return self._legs_pool.submit(self._fts_legs, query, depth,
                                      syn, core, struct_q), full_rrf

    def _host_stage(self, query: str, cls, cands: list, ctx,
                    limit: int, q_vec, index,
                    legs_future, full_rrf: bool, meta: dict,
                    overlay_entry=None, limit_fetch: int | None = None,
                    rerank: bool = False) -> list[SearchHit]:
        """Post-device host pipeline: dedup, overlay merge, leg fusion/rescue,
        rerank, final full-row hydration. ONE implementation shared by the
        solo path and the micro-batcher (tests pin their bit-equivalence)."""
        from cqs_tpu.search.scoring import rrf_tail_rescue

        cands.sort(key=lambda c: (-c.final, c.row.id))
        cands = dedup_windows(
            cands, self.lim,
            hydrate_parents=lambda ids: {r.id: r for r in
                                         self.store.get_chunks_by_ids(ids, meta_only=True)})
        cands.sort(key=lambda c: (-c.final, c.row.id))
        self._prefetch_digests([c.row.id for c in cands])
        cands = dedup_exact_duplicates(cands, digest_of=self._body_digest)
        if self.lim.impl_twin_demote:
            from cqs_tpu.search.scoring import impl_twin_demote

            impl_twin_demote(cands, self.lim.impl_twin_demote)
            cands.sort(key=lambda c: (-c.final, c.row.id))
        if self.lim.mmr_lambda < 1.0:
            cands = mmr_diversify(cands, self.lim.mmr_lambda, limit * 3)

        if overlay_entry is not None:
            cands = self._merge_overlay(cands, overlay_entry, q_vec, ctx,
                                        limit_fetch or limit)

        # Lexical tier: RRF-fuse the FTS5 leg for the categories where it
        # measurably lifts recall (router.LEXICAL_RRF_CATEGORIES).
        if legs_future is not None:
            fts, body, core_leg, struct_leg, stem_leg = legs_future.result()
            if fts or body or core_leg or struct_leg or stem_leg:
                # Leg UNION, not just re-ranking: an FTS-only hit absent from
                # the device pool must still be able to surface (the reference
                # fuses leg top-ks — search_hybrid_inner unions legs before
                # hydration). Window hits resolve to parents so leg ranks key
                # the same rows the pool carries.
                dirty = overlay_entry.dirty_origins if overlay_entry is not None else ()
                fts, body, core_leg, struct_leg, stem_leg = self._resolve_and_inject_legs(
                    [fts, body, core_leg, struct_leg, stem_leg], cands, ctx,
                    exclude_origins=dirty)
                doc_exempt: frozenset[str] = frozenset()
                if getattr(ctx, "_doc_demotion_on", False) and self.lim.doc_demote_legs:
                    # doc-aware leg ordering: BM25 ranks the corpus's own
                    # prose (audit logs quoting query-shaped phrases) above
                    # the code gold inside the legs too — a gold at name-leg
                    # rank 17 behind a dozen .md rows is out of RRF-rescue
                    # range at k=60, but effective rank ~5 once doc rows
                    # yield. Stable within each class; ids carry the origin
                    # prefix so only the name-exemption check hydrates (and
                    # only the doc-origin rows, one batched SELECT).
                    from cqs_tpu.search.scoring import (_DOC_ORIGIN_RE,
                                                        doc_demotion_exempt)

                    doc_ids = list({cid for leg in (fts, body, core_leg,
                                                    struct_leg, stem_leg)
                                    for cid, _ in leg
                                    if _DOC_ORIGIN_RE.search(cid.rsplit(":", 2)[0])})
                    if doc_ids:
                        doc_exempt = frozenset(
                            r.id for r in self.store.get_chunks_by_ids(
                                doc_ids, meta_only=True)
                            if doc_demotion_exempt(r.name, ctx._query_words))
                    fts, body, core_leg, struct_leg, stem_leg = (
                        _doc_demote_leg(leg, doc_exempt) for leg in
                        (fts, body, core_leg, struct_leg, stem_leg))
                if full_rrf:
                    # categories where rank-RRF reordering lifts the head too
                    extra = [(body, self.lim.rrf_body_weight)]
                    if core_leg:
                        extra.append((core_leg, self.lim.xlang_core_weight))
                    if stem_leg:
                        extra.append((stem_leg, self.lim.stem_leg_weight))
                    rrf_sp_w = self.lim.rrf_sparse_weight
                    if rrf_sp_w <= 0 and cls.category.value in {
                            c.strip() for c in
                            self.lim.rrf_sparse_categories.split(",") if c.strip()}:
                        # category-scoped sparse RRF leg: the r3 GLOBAL
                        # variant lost R@5 on both gates, but r4 triage
                        # found conceptual golds at sparse rank 0-1 buried
                        # by the dense-heavy alpha — scope the leg to the
                        # categories where the sparse leg has head skill
                        rrf_sp_w = self.lim.rrf_sparse_cat_weight
                    if rrf_sp_w > 0:
                        # the pool's exact-sparse ordering as an RRF leg
                        # (free: already computed on device). Post-code-only
                        # triage: golds at sparse rank 0-12 missing the
                        # top-20 in RRF categories — a fusion miss the
                        # dense-heavy alpha cannot recover alone.
                        sp_leg = sorted(
                            ((c.row.id, c.sparse) for c in cands
                             if c.sparse is not None and c.sparse > -1e30),
                            key=lambda t: -t[1])[:100]
                        if sp_leg:
                            extra.append((sp_leg, rrf_sp_w))
                    rrf_with_fts(cands, fts, self.lim, extra_legs=extra)
                    cands.sort(key=lambda c: (-c.final, c.row.id))
                    meta["rrf_fts"] = True
                    if self.lim.rrf_cat_tail_rescue:
                        # head-pinned tail rescue AFTER full RRF: a gold only
                        # the sparse/name/body leg surfaced enters the top-20
                        # without touching the RRF head (the gate showed
                        # head-reordering sparse legs cost R@5 — this cannot)
                        legs = [(fts, self.lim.rescue_name_weight)]
                        if self.lim.rescue_body_weight > 0:
                            legs.append((body, self.lim.rescue_body_weight))
                        sp_leg = sorted(
                            ((c.row.id, c.sparse) for c in cands
                             if c.sparse is not None and c.sparse > -1e30),
                            key=lambda t: -t[1])[:100]
                        if sp_leg:
                            legs.append((sp_leg, 0.5))
                        cands = rrf_tail_rescue(cands, legs, self.lim, pin=5)
                        meta["rrf_tail"] = True
                    elif self.lim.rescue_sparse_head > 0:
                        # sparse-HEAD rescue in RRF categories: only the
                        # exact-sparse ordering's top rows join (a gold at
                        # sparse rank 0-2 is a strong signal; the top-100
                        # variants above are measured losers)
                        sp_head = sorted(
                            ((c.row.id, c.sparse) for c in cands
                             if c.sparse is not None and c.sparse > -1e30),
                            key=lambda t: -t[1])[:self.lim.rescue_sparse_head]
                        if sp_head:
                            cands = rrf_tail_rescue(
                                cands,
                                [(sp_head, self.lim.rescue_sparse_head_weight)],
                                self.lim, pin=5)
                            meta["sparse_head_rescue"] = True
                else:
                    # head-pinned tail rescue — R@20-class
                    # recovery for golds only a leg surfaced, R@5 untouched.
                    # Extra rescue legs beyond FTS: the pool's exact-sparse
                    # ordering (already computed on device, free) and the
                    # OTHER dense index's top-100 (base vs enriched disagree
                    # exactly on the queries where enrichment tokens are
                    # noise — triage r3: gold base-rank 23 vs enriched 10691).
                    legs = [(fts, self.lim.rescue_name_weight)]
                    if self.lim.rescue_body_weight > 0:
                        legs.append((body, self.lim.rescue_body_weight))
                    if stem_leg:
                        legs.append((stem_leg, self.lim.stem_leg_weight))
                    pin = 5
                    if (cls.category.value in ("structural", "type_filtered")
                            and self.lim.sig_struct_boost > 0):
                        # Scored signature-predicate leg (ref: structural
                        # matchers, src/structural.rs): idf-weighted slot
                        # coverage over every code signature — "async methods
                        # that return a string" wants async + str IN THE
                        # SIGNATURE, not the body prose. The r3 strict FTS
                        # AND went dark on 79% of the v4 structural pool's
                        # misses (one unmatchable NL word zeroed the leg, or
                        # a single-token floor); the scored index drops df=0
                        # slots and ranks partial matches instead
                        # (index/lexical.py::SignatureIndex).
                        from cqs_tpu.search.router import sig_slots

                        sig_idx = self._get_sig_index()
                        slots = sig_slots(query) if sig_idx is not None else []
                        sig_rows, n_full, dropped = (
                            sig_idx.query(slots, limit=100,
                                          min_cover=self.lim.sig_leg_min_cover)
                            if slots else ([], 0, 0))
                        if sig_rows:
                            (sig_leg,) = self._resolve_and_inject_legs(
                                [sig_rows], cands, ctx, exclude_origins=dirty)
                            cap = self.lim.sig_struct_max_hits
                            if 0 < n_full <= cap and dropped == 0:
                                # strict-AND parity head boost: every one of
                                # these rows matches EVERY predicate slot and
                                # the match is selective; shorter signatures
                                # (the exact shape the query describes) sort
                                # first
                                matched = {cid for cid, _ in
                                           sig_leg[:min(n_full, 10)]}
                                for c in cands:
                                    if c.row.id in matched:
                                        c.boosts["sig_struct"] = self.lim.sig_struct_boost
                                        c.final += self.lim.sig_struct_boost
                                cands.sort(key=lambda c: (-c.final, c.row.id))
                                meta["sig_struct"] = len(matched)
                            if self.lim.sig_leg_weight > 0:
                                # partial-coverage tail rescue: a gold only
                                # the signature evidence ranks (head pinned,
                                # R@5-safe by construction)
                                legs.append((sig_leg, self.lim.sig_leg_weight))
                                meta["rrf_sig"] = len(sig_leg)
                    if cls.category.value == "structural":
                        # structural: the AND-over-body leg joins the rescue
                        # (golds rank 3-63 in it — tail territory, head
                        # rights measured -1.8pp test R@5) and the pin drops
                        # to struct_rescue_pin so a gold the name leg ranks
                        # high (triage: device 16 / fts-name 8) can still
                        # enter the top-5.
                        pin = self.lim.struct_rescue_pin
                        if struct_leg:
                            legs.append((struct_leg, self.lim.struct_and_weight))
                            meta["rrf_struct"] = True
                    sp_w = self.lim.rescue_sparse_weight
                    if sp_w <= 0 and cls.category.value in {
                            c.strip() for c in
                            self.lim.rescue_sparse_categories.split(",") if c.strip()}:
                        # category-gated: globally the sparse leg costs R@20
                        # (-1.9pp at 0.5), but conceptual golds surface at
                        # sparse rank 4-25 while dense sits in the thousands
                        sp_w = 0.5
                    if sp_w > 0:
                        sp_leg = sorted(
                            ((c.row.id, c.sparse) for c in cands
                             if c.sparse is not None and c.sparse > -1e30),
                            key=lambda t: -t[1])[:100]
                        if sp_leg:
                            legs.append((sp_leg, sp_w))
                    if self.lim.rescue_sparse_head > 0:
                        sp_head = sorted(
                            ((c.row.id, c.sparse) for c in cands
                             if c.sparse is not None and c.sparse > -1e30),
                            key=lambda t: -t[1])[:self.lim.rescue_sparse_head]
                        if sp_head:
                            legs.append(
                                (sp_head, self.lim.rescue_sparse_head_weight))
                    if self.lim.rescue_alt_dense_weight > 0:
                        alt_leg = self._alt_dense_leg(index, q_vec, k=100)
                        if alt_leg:
                            alt_leg, = self._resolve_and_inject_legs(
                                [alt_leg], cands, ctx,
                                exclude_origins=(overlay_entry.dirty_origins
                                                 if overlay_entry is not None else ()))
                            legs.append((alt_leg, self.lim.rescue_alt_dense_weight))
                    cands = rrf_tail_rescue(cands, legs, self.lim, pin=pin)
                    meta["rrf_rescue"] = True

        if self.lim.sparse_top1_pin and cls is not None and cls.category.value in {
                c.strip() for c in self.lim.sparse_pin_categories.split(",")
                if c.strip()}:
            # HARD sparse-head pin (r4 dev triage misses 4/14: gold at
            # sparse rank 0-1, alpha=0.8 buries it; every SOFT variant —
            # global/category RRF legs, head rescue — measured dead because
            # RRF k=60 damps a single leg's head). When the exact-sparse
            # ordering's top-1 beats its runner-up by sparse_top1_margin,
            # that row is inserted at position sparse_top1_pin outright.
            sp_sorted = sorted(
                (c for c in cands if c.sparse is not None and c.sparse > 0),
                key=lambda c: -c.sparse)
            if len(sp_sorted) >= 2:
                top1 = sp_sorted[0]
                if (top1.sparse >= self.lim.sparse_top1_margin
                        * max(sp_sorted[1].sparse, 1e-9)):
                    pos = min(int(self.lim.sparse_top1_pin),
                              len(cands)) - 1
                    cur = cands.index(top1)
                    if cur > pos:
                        cands.pop(cur)
                        cands.insert(pos, top1)
                        meta["sparse_top1_pin"] = True

        if rerank:
            # LAST reordering before truncate (after RRF/leg rescue — running
            # earlier let the legs' final-score sort silently discard the
            # reranked order), so the reranker also sees leg-rescued rows.
            cands = self._rerank(query, cands)

        if self.lim.same_name_collapse:
            # after every reordering (rescue/rerank) so the collapse keys the
            # final ranks; keep-first makes it monotone-safe for recall
            from cqs_tpu.search.scoring import collapse_same_name

            cands = collapse_same_name(cands)
        if self.lim.canonical_twin_collapse:
            # markdown fence twins fold into the code they quote (and the
            # code row inherits a higher-ranked quotation's slot)
            from cqs_tpu.search.scoring import collapse_canonical_twins

            cands = collapse_canonical_twins(cands, self._get_canon_map().get)

        # final hits re-hydrate FULL rows (body/nl) — the pool scored on
        # meta-only rows; only the <=limit survivors pay for text hydration
        final = cands[:limit]
        full = {r.id: r for r in self.store.get_chunks_by_ids(
            [c.row.id for c in final])}
        return [SearchHit(full.get(c.row.id, c.row), c.final, c.signals)
                for c in final]

    def _alt_dense_leg(self, index: DenseIndex, q_vec: np.ndarray,
                       k: int = 100) -> list[tuple[str, float]]:
        """Top-k of the dense index the router did NOT pick (enriched when
        serving base, base when serving enriched) as a rescue leg."""
        other = self.dense_base if index is self.dense else self.dense
        if other is None or not other.count or self.lim.disable_base_index:
            return []
        vals, rows = other.search(q_vec[None, :], k=min(k, other.count))
        out = []
        for v, r in zip(np.asarray(vals)[0], np.asarray(rows)[0]):
            if 0 <= r < other.count and v > -1e30:
                cid = other.ids[r]
                if cid:
                    out.append((cid, float(v)))
        return out

    def _resolve_and_inject_legs(self, legs: list[list[tuple[str, float]]],
                                 cands: list, ctx,
                                 exclude_origins=()) -> list[list[tuple[str, float]]]:
        """Resolve FTS leg hits (which may be window rows) to their parent
        chunk ids, and APPEND leg hits missing from the candidate pool as
        zero-fused candidates (they rank at the pool's tail; RRF lifts them
        by leg position). Returns the resolved legs."""
        all_ids = list({cid for leg in legs for cid, _ in leg})
        rows = {r.id: r for r in self.store.get_chunks_by_ids(all_ids, meta_only=True)}
        parent_of: dict[str, str] = {}
        parent_rows: dict[str, object] = {}
        for cid, row in rows.items():
            if row.parent_id:
                parent_of[cid] = row.parent_id
            else:
                parent_of[cid] = cid
                parent_rows[cid] = row
        missing_parents = [pid for pid in set(parent_of.values()) if pid not in parent_rows]
        for r in self.store.get_chunks_by_ids(missing_parents, meta_only=True):
            parent_rows[r.id] = r
        drop: set[str] = set()
        if getattr(ctx, "code_only", False):
            # default code-only search: non-code rows leave the legs entirely
            # (leg RANKS then count only code rows — stronger than the
            # doc-demotion stable partition, which this supersedes here)
            from cqs_tpu.parser.types import NON_CODE_TYPES

            drop = {rid for rid, row in parent_rows.items()
                    if row.chunk_type in NON_CODE_TYPES}
        inc = getattr(ctx, "include_types", None)
        if inc is not None:
            # explicit --type filter: the legs honor it too (the device mask
            # already does; an injected leg row must not bypass the filter)
            drop |= {rid for rid, row in parent_rows.items()
                     if row.chunk_type not in inc}
        resolved: list[list[tuple[str, float]]] = []
        for leg in legs:
            out, seen = [], set()
            for cid, s in leg:
                rid = parent_of.get(cid, cid)
                if rid not in seen and rid not in drop:
                    out.append((rid, s))
                    seen.add(rid)
            resolved.append(out)
        have = {c.row.id for c in cands}
        for leg in resolved:
            for rid, _ in leg:
                if rid in have:
                    continue
                row = parent_rows.get(rid)
                if row is None or row.origin in exclude_origins:
                    continue   # worktree overlay masked this origin as stale
                c = Candidate(row=row, fused=0.0)
                c.boosts["leg"] = "fts_union"
                if score_candidate(c, ctx):
                    cands.append(c)
                    have.add(rid)
        return resolved

    def _alpha_overrides(self) -> dict[str, float]:
        """Config overrides, seeded with lexical-tier adjustments when the
        embedder is the hash family (see router.LEXICAL_ALPHA_OVERRIDES)."""
        from cqs_tpu.search.router import LEXICAL_ALPHA_OVERRIDES

        overrides: dict[str, float] = {}
        if self.embedder.preset.lexical_tier:
            overrides.update(LEXICAL_ALPHA_OVERRIDES)
        # env knobs (alpha_<category>, -1 = unset) sit between the tier
        # defaults and the TOML config — registry precedence config > env >
        # default — and make the alpha table LOCO-sweepable
        # (`cqs-tpu sweep alpha_conceptual 0.5 0.7 ...`).
        for cat in Category:
            v = getattr(self.lim, f"alpha_{cat.value}")
            if v is not None and v >= 0.0:
                overrides[cat.value] = float(v)
        if self.config:
            overrides.update(self.config.alpha_overrides)
        return overrides

    def _sketch_candidates(self, fmask) -> bool:
        """Whether the device program runs the sketch candidate-generation
        leg. On by default (auto -1 == on): skipping it halves the CPU
        program cost (~-22 ms eval p50 at 35k chunks) but was gate-measured
        at -3.6 pp test R@5 — the sparse-only candidates it finds matter.
        ``sketch_leg=0`` is the explicit latency-over-recall mode; filtered
        queries always keep the leg (FTS legs don't see the filter mask, so
        it is the only sparse candidate source under a filter)."""
        if self.lim.sketch_leg == 0 and fmask is None:
            return False
        return True

    def _pick_dense_index(self, cls: Classification) -> DenseIndex | None:
        """Adaptive dual-index routing (ref: SearchStrategy::DenseBase +
        A/B kills CQST_DISABLE_BASE_INDEX / CQST_FORCE_BASE_INDEX)."""
        if self.lim.force_base_index and self.dense_base is not None:
            return self.dense_base
        if (cls.strategy is Strategy.DENSE_BASE and self.dense_base is not None
                and not self.lim.disable_base_index and self.dense_base.count > 0):
            return self.dense_base
        # Lexical tier: structural queries measurably rank better against the
        # PLAIN NL (base) than the call-graph-enriched NL — the enrichment
        # tokens (caller/callee names) are noise for shape-of-code queries
        # when the dense leg is itself lexical (triage r3: gold base ranks
        # 0/59/119 vs enriched 40/114/89 on the test split's structural set).
        if (self.embedder.preset.lexical_tier
                and cls.category is Category.STRUCTURAL
                and self.dense_base is not None
                and not self.lim.disable_base_index and self.dense_base.count > 0):
            return self.dense_base
        return self.dense

    def _embed_query_cached(self, query: str) -> np.ndarray:
        fp = self.embedder.fingerprint
        hit = self.query_cache.get(query, fp)
        if hit is not None and len(hit) == self.embedder.dim:
            return hit
        vec = self.embedder.embed_query(query)
        self.query_cache.put(query, fp, vec)
        return vec
