"""Gold-miss triage: per-query leg analysis for eval failures.

Reference analog: the ``evals/`` error-analysis tooling (pool building +
per-leg diagnostics around ``search_legs``). For every eval query this
computes where the gold ranks in EACH retrieval leg independently:

- dense leg: exact cosine rank over the full live corpus (host numpy)
- sparse leg: exact SPLADE dot-product rank over the full corpus
- fts_name / fts_body legs: FTS5 rank (window rows resolved to parents)

plus the production pipeline's final rank, classification, and alpha. The
point (VERDICT r2 item 3): for a gold missing from the top-20, the fix
depends on WHICH leg could have surfaced it — a dense-rank-3000 gold is a
candidate-generation miss; a dense-rank-12 gold that final-ranks 40 is a
scoring/fusion miss.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from cqs_tpu_torch.eval import EvalQuery


def _gold_rows(store, gold) -> tuple[list[str], list[str]]:
    """All chunk ids for the gold (its own row + window rows).

    Returns (gold_ids, gold_group_ids) where group ids also include the
    parent id a window would resolve to."""
    rows = store.db.execute(
        "SELECT id, parent_id FROM chunks WHERE origin = ? AND "
        "(name = ? OR name LIKE ? || '#w%')",
        (gold.origin, gold.name, gold.name)).fetchall()
    ids = [r[0] for r in rows]
    group = set(ids)
    for _, pid in rows:
        if pid:
            group.add(pid)
    return ids, sorted(group)


def _dense_rank(engine, index, q_vec: np.ndarray, gold_ids: list[str]) -> int | None:
    """Exact cosine rank of the best gold row (0-based) among CODE rows —
    the same competitor set the default (code-only) search scans."""
    if index is None or not index.count:
        return None
    row_of = index.row_of
    rows = [row_of[g] for g in gold_ids if g in row_of]
    if not rows:
        return None
    host = index._host
    qn = q_vec / (np.linalg.norm(q_vec) + 1e-9)
    scores = host @ qn.astype(host.dtype)
    code = engine._code_mask(index)
    if code is not None:
        scores = np.where(code[: len(scores)] > 0, scores, -np.inf)
    best = max(float(scores[r]) for r in rows)
    if best == -np.inf:
        return None            # gold is a non-code chunk: unreachable by default
    return int((scores > best).sum())


def _sparse_rank(engine, gold_ids: list[str], q_ids: np.ndarray,
                 q_w: np.ndarray) -> int | None:
    sp = engine.sparse
    if sp is None or not sp.count:
        return None
    row_of = {cid: i for i, cid in enumerate(sp.ids) if cid}
    rows = [row_of[g] for g in gold_ids if g in row_of]
    if not rows:
        return None
    doc_ids, doc_w = sp._host_ids, sp._host_w
    scores = np.zeros(doc_ids.shape[0], np.float32)
    for tid, w in zip(np.asarray(q_ids).ravel(), np.asarray(q_w).ravel()):
        if w <= 0:
            continue
        scores += w * (doc_w * (doc_ids == int(tid))).sum(axis=1)
    if engine.dense is not None:
        # sparse rows are dense-row-aligned; rank among CODE rows only
        code = engine._code_mask(engine.dense)
        if code is not None:
            scores[: len(code)][code == 0] = -np.inf
    best = max(float(scores[r]) for r in rows)
    if best <= 0.0:
        return None          # gold shares no terms with the query at all
    return int((scores > best).sum())


def _fts_rank(store, query: str, gold_group: set[str], scope: str,
              limit: int = 200, synonyms=None) -> int | None:
    from cqs_tpu_torch.parser.types import NON_CODE_TYPES

    hits = store.fts_search(query, limit=limit, scope=scope, synonyms=synonyms)
    # resolve window rows to parents so ranks key logical chunks; non-code
    # rows don't consume a rank — the default search's leg resolution drops
    # them, so the effective leg rank counts only code rows
    ids = [cid for cid, _ in hits]
    rows = {r.id: r for r in store.get_chunks_by_ids(ids)}
    parent = {cid: (r.parent_id or cid) for cid, r in rows.items()}
    ptypes = {cid: r.chunk_type for cid, r in rows.items() if not r.parent_id}
    ptypes.update({r.id: r.chunk_type for r in store.get_chunks_by_ids(
        [pid for pid in set(parent.values()) if pid not in rows])})
    seen, rank = set(), 0
    for cid, _ in hits:
        rid = parent.get(cid, cid)
        if rid in seen:
            continue
        seen.add(rid)
        if rid in gold_group or cid in gold_group:
            return rank
        if ptypes.get(rid) in NON_CODE_TYPES:
            continue
        rank += 1
    return None


def triage_query(engine, q: EvalQuery, k: int = 20) -> dict:
    from cqs_tpu_torch.search.router import classify_query

    store = engine.store
    gold_ids, gold_group = _gold_rows(store, q.gold)
    out: dict = {
        "query": q.query,
        "category": q.category,
        "gold": {"origin": q.gold.origin, "name": q.gold.name},
        "gold_rows": len(gold_ids),
    }
    if not gold_ids:
        out["error"] = "gold_not_extracted"
        return out

    res = engine.search(q.query, limit=k)
    rank = None
    for r, hit in enumerate(res.hits):
        if (hit.row.origin == q.gold.origin
                and hit.row.name.split("#w")[0] == q.gold.name):
            rank = r
            break
    cls = classify_query(q.query)
    out.update({
        "final_rank": rank,
        "classified_as": res.category,
        "rule_category": cls.category.value,
        "strategy": res.strategy,
        "alpha": res.alpha,
        "top5": [f"{h.row.origin}:{h.row.name.split('#w')[0]}"
                 for h in res.hits[:5]],
    })

    q_vec = engine._embed_query_cached(q.query)
    out["dense_rank"] = _dense_rank(engine, engine.dense, q_vec, gold_ids)
    if engine.dense_base is not None and engine.dense_base.count:
        out["dense_base_rank"] = _dense_rank(engine, engine.dense_base, q_vec, gold_ids)
    if engine.splade is not None and engine.sparse is not None:
        q_ids, q_w = engine.splade.encode(q.query, is_query=True)
        out["sparse_rank"] = _sparse_rank(engine, gold_ids, q_ids, q_w)
    syn = engine.config.synonyms if engine.config else None
    gg = set(gold_group)
    out["fts_name_rank"] = _fts_rank(store, q.query, gg, "meta", synonyms=syn)
    out["fts_body_rank"] = _fts_rank(store, q.query, gg, "body", synonyms=syn)
    return out


def run_triage(engine, queries: list[EvalQuery], k: int = 20,
               only_misses: bool = True, category: str | None = None,
               progress=None) -> list[dict]:
    rows = []
    todo = [q for q in queries if q.gold is not None
            and (category is None or q.category == category)]
    for i, q in enumerate(todo):
        t = triage_query(engine, q, k=k)
        if only_misses and t.get("final_rank") is not None and t["final_rank"] < 5:
            t = {"query": t["query"], "category": t["category"],
                 "final_rank": t["final_rank"]}     # hit@5: keep a stub row
        rows.append(t)
        if progress:
            progress(i + 1, len(todo))
    return rows


def summarize(rows: list[dict], k: int = 20) -> dict:
    """Which leg COULD have rescued each top-k miss (leg rank < 100)."""
    misses = [r for r in rows if r.get("final_rank") is None
              or r["final_rank"] >= k]
    rescue = {"dense": 0, "sparse": 0, "fts_name": 0, "fts_body": 0,
              "dense_base": 0, "none": 0}
    for r in misses:
        if "error" in r:
            continue
        any_leg = False
        for leg, key in (("dense", "dense_rank"), ("sparse", "sparse_rank"),
                         ("fts_name", "fts_name_rank"), ("fts_body", "fts_body_rank"),
                         ("dense_base", "dense_base_rank")):
            rk = r.get(key)
            if rk is not None and rk < 100:
                rescue[leg] += 1
                any_leg = True
        if not any_leg:
            rescue["none"] += 1
    return {"misses_at_k": len(misses), "rescuable_by_leg": rescue}
