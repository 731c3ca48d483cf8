"""Query micro-batching: fuse concurrent searches into one device program.

Port of ``cqs_tpu/daemon/batcher.py``; ``daemon/dispatch.py`` feeds it from
the socket server's client threads. Concurrent default searches (no filters) collect for up to
``daemon_batch_window_ms`` or ``daemon_max_batch`` entries, embed as one
batch and run ONE device program on the engine's device
(``hybrid_query_batch``, or the engine's int8 program when ``scan_q8``
selects one, as on the solo path; on a ``host_mirror`` engine, the CPU's,
one call of its host mirror ``hybrid_query_host``, unpadded, as the
reference batches on a CPU backend); an engine serving a sharded index
(``mesh_shards``) answers each query solo, through the sharded program;
hydration
and scoring fan back out per query through the engine's shared host stage,
so a batched query returns what the solo path returns. Over a
``TieredServing`` each query is batched on the engine that answers it solo
(``engine_for``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.search.router import (
    Strategy, classify_query, extract_lang_hints, reclassify_with_centroid, resolve_alpha,
)
from cqs_tpu_torch.search.scoring import Candidate, ScoringContext, score_candidate
from cqs_tpu_torch.utils.trace import get_tracer
from cqs_tpu_torch.search.engine import SearchEngine, SearchHit, SearchResult, bf16_extraction
from cqs_tpu_torch.search.program import (
    bf16_round, hybrid_query_batch, hybrid_query_host, trim_query_terms,
)

log = get_tracer("batcher")

#: a batch is padded to the first rung that holds it, so every batch size a
#: device program is launched with is one of these (or larger than the last)
BATCH_RUNGS = (1, 4, 8, 16, 32, 64, 128)


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
            eng = self._engine_for(query)
            hit = eng.cached_result(eng.result_cache_key(query, limit))
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

    def _engine_for(self, query: str) -> SearchEngine:
        """The engine that answers ``query``: a ``TieredServing``'s tier or
        default engine, else the one engine."""
        route = getattr(self.engine, "engine_for", None)
        return route(query) if route is not None else self.engine

    def _run_batch(self, batch: list[_Pending]) -> None:
        # each query runs on the engine that answers it solo (a tiered
        # engine's tier or default), one batch program per engine
        by_engine: dict[int, tuple[SearchEngine, list[_Pending]]] = {}
        for p in batch:
            eng = self._engine_for(p.query)
            by_engine.setdefault(id(eng), (eng, []))[1].append(p)
        for eng, part in by_engine.values():
            self._run_engine(eng, part)

    def _run_engine(self, eng: SearchEngine, batch: list[_Pending]) -> None:
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
            # alpha 1 (dense only): the solo path runs the exact dense-only
            # program, whose pool the hybrid batch program's per-tile and
            # sketch candidates would not reproduce; the reference batches it.
            # A sharded engine (mesh_shards): the solo path runs the sharded
            # program, whose pool is each leg's exact global top-pool; the
            # reference's batcher has no sharded branch and batches it
            if (cls.strategy is Strategy.NAME_ONLY or eng.sparse is None
                    or eng.sharded is not None or index is None or alpha >= 1.0
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
            self._run_group(eng, group, index)

    def _run_group(self, eng: SearchEngine, batchable: list, index) -> None:
        t0 = time.perf_counter()
        # the engine's index lock: one batch reads one consistent set of index
        # tensors, whatever a refresh does meanwhile (search/engine.py). It is
        # held for the device part only; hydration runs outside it. A rebuild
        # that swapped the indexes since the group was formed leaves ``index``
        # behind: those queries go the solo way, on the new indexes
        with eng.index_lock:
            current = (index is eng.dense or index is eng.dense_base) and (
                eng.sparse is not None and eng.sparse.capacity == index.capacity
                and eng.sparse.ids_digest == index.ids_digest)
            generation = eng.index_generation
            if current:
                q_dense, legs, fused, rows, d_leg, s_leg = self._device_batch(
                    eng, batchable, index)
        if not current:
            self.stats["solo"] += len(batchable)
            for p, _, _ in batchable:
                try:
                    p.future.set_result(eng.search(p.query, limit=p.limit))
                except Exception as e:
                    p.future.set_exception(e)
            return
        B = len(batchable)
        device_ms = (time.perf_counter() - t0) * 1e3

        # hydration/boosting fans out on host threads: one device program
        # serves the whole window, so hydrating query after query (SQLite
        # and scoring for each) would dominate the window's latency
        def finish(item):
            i, (p, cls, alpha) = item
            try:
                hits = self._hydrate(eng, p, cls, index, fused[i], rows[i],
                                     d_leg[i], s_leg[i], q_dense[i], legs[i])
                res = SearchResult(
                    hits[: p.limit], cls.category.value, cls.strategy.value + "+batched",
                    alpha, (time.perf_counter() - t0) * 1e3,
                    {"batch_size": B, "device_ms": round(device_ms, 2)})
                if generation == eng.index_generation:      # no refresh meanwhile
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

    def _device_batch(self, eng: SearchEngine, batchable: list, index):
        """The device part of one group, under the caller's index lock:
        embed, start the FTS legs, run ONE device program for the padded
        batch. Returns (q_dense, legs, fused, rows, dense leg, sparse leg),
        the last four as host arrays of the B real queries."""
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
        # every batched query is a default (code-only) search, as on the
        # solo path
        code = eng._code_mask(index)
        if eng.host_mirror:
            # the host mirror (batcher.py:207-230): numpy recompiles nothing
            # per batch size, so the batch is not padded
            fm = None
            if code is not None:
                fm = np.zeros(index.capacity, np.int32)
                fm[: len(code)] = code
            fused, rows, d_leg, s_leg = hybrid_query_host(
                q_dense=bf16_round(q_dense), q_ids=np.asarray(q_ids_b),
                q_w=np.asarray(q_w_b, np.float32), alphas=alphas, pool=pool,
                vocab_size=eng.sparse.vocab_size,
                sketch_candidates=eng._sketch_candidates(None),
                **eng._host_hybrid_inputs(index, fm))
            return q_dense, legs, fused, rows, d_leg, s_leg

        # pad the batch dim to a rung so the number of distinct batch shapes
        # stays small (padding rows repeat the first query)
        Bp = next((r for r in BATCH_RUNGS if B <= r), B)
        if Bp != B:
            q_dense = np.concatenate([q_dense, np.repeat(q_dense[:1], Bp - B, 0)])
            q_ids_b = np.concatenate([q_ids_b, np.repeat(q_ids_b[:1], Bp - B, 0)])
            q_w_b = np.concatenate([q_w_b, np.repeat(q_w_b[:1], Bp - B, 0)])
            alphas = np.concatenate([alphas, np.repeat(alphas[:1], Bp - B)])
        q_ids_t, q_w_t = trim_query_terms(q_ids_b, q_w_b)
        valid = index.mask if code is None else eng._device_code_valid(index, code)
        dev = eng.device
        queries = (torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(q_ids_t)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(q_w_t, np.float32)).to(dev),
                   torch.from_numpy(alphas).to(dev))
        q8 = eng._q8_arrays(index) if eng._sketch_candidates(None) else None
        if q8 is not None:
            fused, rows, d_leg, s_leg = eng._q8_query(index, q8, valid, *queries, pool)
        else:
            fused, rows, d_leg, s_leg = hybrid_query_batch(
                index.matrix, eng.sparse.packed_terms(), None, eng.sparse.sketch, valid,
                *queries, pool, eng.sparse.vocab_size,
                sketch_candidates=eng._sketch_candidates(None),
                extraction=bf16_extraction(index.capacity, B, eng.lim.scan_extraction,
                                           eng.lim.scan_q8_min_rows))
        return (q_dense, legs, fused[:B].cpu().numpy(), rows[:B].cpu().numpy(),
                d_leg[:B].cpu().numpy(), s_leg[:B].cpu().numpy())

    def _hydrate(self, eng: SearchEngine, p: _Pending, cls, index, fused, rows, d_leg,
                 s_leg, q_vec, legs) -> list[SearchHit]:
        """Per-query host stage: identical to the solo path by construction —
        pool extraction here, then the engine's shared ``_host_stage``."""
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
