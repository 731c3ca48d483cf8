"""Query micro-batching: fuse concurrent searches into one device program.

Port of ``cqs_tpu/daemon/batcher.py`` (the socket server and dispatch are
not ported yet). Concurrent default searches (no filters) collect for up to
``daemon_batch_window_ms`` or ``daemon_max_batch`` entries, embed as one
batch and run ONE ``hybrid_query_batch`` on the engine's device; hydration
and scoring fan back out per query through the engine's shared host stage,
so a batched query returns what the solo path returns.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from cqs_tpu.config import limits as default_limits
from cqs_tpu.search.router import (
    Strategy, classify_query, extract_lang_hints, reclassify_with_centroid, resolve_alpha,
)
from cqs_tpu.search.scoring import Candidate, ScoringContext, score_candidate
from cqs_tpu.utils.trace import get_tracer
from cqs_tpu_torch.search.engine import SearchEngine, SearchHit, SearchResult, bf16_extraction
from cqs_tpu_torch.search.program import hybrid_query_batch, trim_query_terms

log = get_tracer("batcher")


@dataclass
class _Pending:
    query: str
    limit: int
    future: Future


class QueryBatcher:
    """Background micro-batching loop over a shared engine."""

    def __init__(self, engine: SearchEngine):
        self.engine = engine
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # dispatch gate: tests (and drain-sensitive callers) pause() the loop
        # so a burst of submits deterministically lands in ONE batch — fusion
        # otherwise depends on submit/dispatch timing under load
        self._gate = threading.Event()
        self._gate.set()
        # fusion observability (exported into watch_status snapshots):
        # batches dispatched, queries fused vs run solo, synchronous cache
        # hits, and a batch-size histogram {size: count}
        self.stats = {"batches": 0, "fused": 0, "solo": 0, "cache_hits": 0,
                      "batch_size_hist": {}}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cqst-batcher")
        self._thread.start()

    def pause(self) -> None:
        """Hold dispatch: submits queue up until resume()."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    def stats_snapshot(self) -> dict:
        s = dict(self.stats)
        s["batch_size_hist"] = dict(self.stats["batch_size_hist"])
        return s

    def submit(self, query: str, limit: int = 10) -> Future:
        fut: Future = Future()
        # result-cache hits resolve synchronously — no reason to ride the
        # batch window (the window wait was the cached path's whole latency)
        try:
            hit = self.engine.cached_result(
                self.engine.result_cache_key(query, limit))
        except Exception:
            hit = None
        if hit is not None:
            self.stats["cache_hits"] += 1
            fut.set_result(hit)
            return fut
        self.q.put(_Pending(query, limit, fut))
        return fut

    def search(self, query: str, limit: int = 10, timeout: float = 30.0) -> SearchResult:
        return self.submit(query, limit).result(timeout=timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the loop thread and the hydration pool."""
        self._stop.set()
        self._thread.join(timeout)
        pool = getattr(self, "_hydrate_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        window_s = default_limits.daemon_batch_window_ms / 1e3
        max_batch = default_limits.daemon_max_batch
        while not self._stop.is_set():
            if not self._gate.wait(timeout=0.25):
                continue
            try:
                first = self.q.get(timeout=0.25)
            except queue.Empty:
                continue
            # a pause() that landed while we were blocked in q.get still
            # holds collection — the window only opens once resumed, so a
            # paused burst always fuses. Timed wait so stop() can terminate
            # the loop (the dequeued entry fails over to solo on stop).
            while not self._gate.wait(timeout=0.25):
                if self._stop.is_set():
                    try:
                        first.future.set_result(
                            self.engine.search(first.query, limit=first.limit))
                    except Exception as e:
                        first.future.set_exception(e)
                    return
            batch = [first]
            deadline = time.perf_counter() + window_s
            while len(batch) < max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:
                log.warning("batch failed: %s", e)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _run_batch(self, batch: list[_Pending]) -> None:
        eng = self.engine
        if eng.dense is None:
            eng.load_or_build_indexes()
        # group per target index (dual-index routing must match the solo
        # path); NameOnly / sparse-unavailable queries run solo
        solo: list[_Pending] = []
        groups: dict[int, list[tuple[_Pending, object, float]]] = {}
        for p in batch:
            # full-result cache: repeated warm daemon queries short-circuit
            # the whole window (token-keyed — invalidates on any store change)
            hit = eng.cached_result(eng.result_cache_key(p.query, p.limit))
            if hit is not None:
                p.future.set_result(hit)
                continue
            cls = classify_query(p.query)
            if cls.strategy is not Strategy.NAME_ONLY:
                # the solo path reclassifies with the centroid router before
                # picking alpha and index; the reference batcher skips this,
                # which made a rerouted query's batched result differ
                cls = reclassify_with_centroid(cls, eng._embed_query_cached(p.query),
                                               eng.centroids, eng.lim)
            alpha = resolve_alpha(cls, eng._alpha_overrides(), eng.lim)
            index = eng._pick_dense_index(cls)
            if (cls.strategy is Strategy.NAME_ONLY or eng.sparse is None
                    or index is None
                    or eng.sparse.capacity != index.capacity
                    or eng.sparse.ids_digest != index.ids_digest):
                solo.append(p)
            else:
                groups.setdefault(id(index), []).append((p, cls, alpha))
        self.stats["solo"] += len(solo)
        for p in solo:
            try:
                p.future.set_result(eng.search(p.query, limit=p.limit))
            except Exception as e:
                p.future.set_exception(e)
        for group in groups.values():
            index = eng._pick_dense_index(group[0][1])
            self._run_group(group, index)

    def _run_group(self, batchable: list, index) -> None:
        t0 = time.perf_counter()
        eng = self.engine
        B = len(batchable)
        self.stats["batches"] += 1
        self.stats["fused"] += B
        hist = self.stats["batch_size_hist"]
        hist[B] = hist.get(B, 0) + 1
        q_dense = np.stack([eng._embed_query_cached(p.query) for p, _, _ in batchable])
        # kick off every query's FTS leg prefetch BEFORE the device dispatch
        # so the legs overlap it (same overlap trick as the solo path)
        legs = [eng._start_legs(p.query, cls) for p, cls, _ in batchable]
        q_ids_b, q_w_b = eng.splade.encode_batch([p.query for p, _, _ in batchable],
                                                 is_query=True)
        alphas = np.asarray([a for _, _, a in batchable], dtype=np.float32)
        pool = min(max(max(p.limit for p, _, _ in batchable) * eng.lim.candidate_pool_mult,
                       eng.lim.candidate_pool_floor), index.capacity)

        # pad the batch dim to a rung so the number of distinct batch shapes
        # stays small (padding rows repeat the first query)
        Bp = next((r for r in (1, 4, 8, 16, 32, 64, 128) if B <= r), B)
        if Bp != B:
            q_dense = np.concatenate([q_dense, np.repeat(q_dense[:1], Bp - B, 0)])
            q_ids_b = np.concatenate([q_ids_b, np.repeat(q_ids_b[:1], Bp - B, 0)])
            q_w_b = np.concatenate([q_w_b, np.repeat(q_w_b[:1], Bp - B, 0)])
            alphas = np.concatenate([alphas, np.repeat(alphas[:1], Bp - B)])
        # every batched query is a default (code-only) search, as on the
        # solo path
        code = eng._code_mask(index)
        q_ids_t, q_w_t = trim_query_terms(q_ids_b, q_w_b)
        valid = index.mask if code is None else eng._device_code_valid(index, code)
        dev = eng.device
        fused, rows, d_leg, s_leg = hybrid_query_batch(
            index.matrix, eng.sparse.packed_terms(), None, eng.sparse.sketch, valid,
            torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(q_ids_t)).to(dev),
            torch.from_numpy(np.ascontiguousarray(q_w_t, np.float32)).to(dev),
            torch.from_numpy(alphas).to(dev), pool, eng.sparse.vocab_size,
            sketch_candidates=eng._sketch_candidates(None),
            extraction=bf16_extraction(index.capacity, B, eng.lim.scan_extraction,
                                       eng.lim.scan_q8_min_rows))
        fused, rows = fused[:B].cpu().numpy(), rows[:B].cpu().numpy()
        d_leg, s_leg = d_leg[:B].cpu().numpy(), s_leg[:B].cpu().numpy()
        device_ms = (time.perf_counter() - t0) * 1e3

        # hydration/boosting fans out on host threads: the device part of a
        # window is sub-ms on TPU, so serial per-query hydrate (~10-30 ms of
        # SQLite + scoring each) would dominate the window latency
        def finish(item):
            i, (p, cls, alpha) = item
            try:
                hits = self._hydrate(p, cls, index, fused[i], rows[i],
                                     d_leg[i], s_leg[i], q_dense[i], legs[i])
                res = SearchResult(
                    hits[: p.limit], cls.category.value, cls.strategy.value + "+batched",
                    alpha, (time.perf_counter() - t0) * 1e3,
                    {"batch_size": B, "device_ms": round(device_ms, 2)})
                eng._cache_result(eng.result_cache_key(p.query, p.limit), res)
                p.future.set_result(res)
            except Exception as e:
                p.future.set_exception(e)

        if B > 2:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_hydrate_pool"):
                self._hydrate_pool = ThreadPoolExecutor(max_workers=4,
                                                        thread_name_prefix="cqst-hydrate")
            list(self._hydrate_pool.map(finish, enumerate(batchable)))
        else:
            for item in enumerate(batchable):
                finish(item)

    def _hydrate(self, p: _Pending, cls, index, fused, rows, d_leg, s_leg,
                 q_vec, legs) -> list[SearchHit]:
        """Per-query host stage: identical to the solo path by construction —
        pool extraction here, then the engine's shared ``_host_stage``."""
        eng = self.engine
        cand_ids, keep = [], []
        # vectorized cosine-threshold pre-drop (same rows score_candidate
        # would reject; identical to the solo path's mask)
        droppable = (np.asarray(d_leg) > -1e30) & \
            (np.asarray(d_leg) < eng.lim.score_threshold)
        for j, r in enumerate(rows):
            if fused[j] <= -1e30:     # masked/duplicate sentinel, not a hit
                continue
            if droppable[j]:
                continue
            if 0 <= r < index.count:
                cid = index.ids[r]
                if cid:
                    cand_ids.append(cid)
                    keep.append(j)
        by_id = {c.id: c for c in eng.store.get_chunks_by_ids(cand_ids, meta_only=True)}
        ctx = ScoringContext(query=p.query, type_hints=cls.type_hints,
                             lang_hints=extract_lang_hints(p.query),
                             note_mentions=eng.store.note_mentions(p.query.split()),
                             lim=eng.lim, category=cls.category.value,
                             code_only=True)
        cands = []
        for j, cid in zip(keep, cand_ids):
            row = by_id.get(cid)
            if row is None:
                continue
            c = Candidate(row=row, fused=float(fused[j]), dense=float(d_leg[j]),
                          sparse=float(s_leg[j]))
            if score_candidate(c, ctx):
                cands.append(c)
        legs_future, full_rrf = legs
        return eng._host_stage(p.query, cls, cands, ctx, p.limit,
                               np.asarray(q_vec), index, legs_future,
                               full_rrf, meta={})
