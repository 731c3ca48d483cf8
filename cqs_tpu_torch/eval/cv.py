"""Leave-one-category-out (LOCO) sweep harness.

Reference analog: the ``evals/`` alpha-sweep scripts (``v3_alpha_sweep*.json``
checkpoints) — but hardened against the r2 failure mode: several levers moved
the 109-query dev and test splits in OPPOSITE directions (per-category alpha
sweeps: dev +1.8, test −3.7). Tuning on one small split overfits it.

The LOCO protocol: pool every labeled non-test query (the reference ships 741
of them across its v3 files), and for each knob value measure per-category
recall over the pool. A value "wins LOCO" when, for each held-out category,
the value chosen by the OTHER categories also performs well on the held-out
one — i.e. the lever generalizes across query styles instead of exploiting
one split's accidents.

Usage (CLI): ``cqs-tpu sweep <knob> v1 v2 ... --pool a.json b.json
--exclude test.json`` — prints the per-category table, the LOCO-selected
value, and the honest LOCO recall estimate.
"""

from __future__ import annotations

import os
from collections import defaultdict

from cqs_tpu_torch.eval import EvalQuery, load_query_set


def load_labeled_pool(paths: list, exclude_paths: list | None = None) -> list[EvalQuery]:
    """Union of labeled queries across files, dedup by query text, minus any
    query appearing in an exclude file (the held-out gate split)."""
    held: set[str] = set()
    for p in exclude_paths or []:
        held |= {q.query for q in load_query_set(p)}
    seen: set[str] = set()
    pool: list[EvalQuery] = []
    for p in paths:
        for q in load_query_set(p):
            if q.gold is None or q.query in held or q.query in seen:
                continue
            seen.add(q.query)
            pool.append(q)
    return pool


def eval_by_category(engine, queries: list[EvalQuery], k: int = 5) -> dict[str, tuple[int, int]]:
    """Per-category (hits@k, total) over the production search path."""
    out: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    resolvable = {(o, n.split("#w")[0]) for o, n in
                  engine.store.db.execute("SELECT origin, name FROM chunks")}
    for q in queries:
        if (q.gold.origin, q.gold.name) not in resolvable:
            continue
        res = engine.search(q.query, limit=k)
        hit = any(h.row.origin == q.gold.origin
                  and h.row.name.split("#w")[0] == q.gold.name
                  for h in res.hits[:k])
        c = out[q.category or "unknown"]
        c[0] += int(hit)
        c[1] += 1
    return {cat: (h, t) for cat, (h, t) in out.items()}


def loco_sweep(engine, knob: str, values: list, queries: list[EvalQuery],
               k: int = 5, progress=None) -> dict:
    """Sweep one env knob over the pool; produce per-(value, category) recall
    and the LOCO verdict.

    For each held-out category c: the winning value on the POOL MINUS c is
    applied to c. The LOCO recall is the weighted aggregate of those held-out
    scores — an honest estimate of what shipping the per-pool winner buys."""
    env = f"CQST_{knob.upper()}"
    prior = os.environ.get(env)
    table: dict[str, dict[str, tuple[int, int]]] = {}
    try:
        for v in values:
            os.environ[env] = str(v)
            table[str(v)] = eval_by_category(engine, queries, k=k)
            if progress:
                progress(str(v), table[str(v)])
    finally:
        if prior is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = prior

    cats = sorted({c for t in table.values() for c in t})

    def recall(v: str, include: set[str]) -> float:
        h = sum(table[v].get(c, (0, 0))[0] for c in include)
        t = sum(table[v].get(c, (0, 0))[1] for c in include)
        return h / t if t else 0.0

    all_cats = set(cats)
    pool_best = max(table, key=lambda v: recall(v, all_cats))
    loco_hits = loco_total = 0
    picks: dict[str, str] = {}
    for c in cats:
        rest = all_cats - {c}
        v_star = max(table, key=lambda v: recall(v, rest))
        picks[c] = v_star
        h, t = table[v_star].get(c, (0, 0))
        loco_hits += h
        loco_total += t
    return {
        "knob": knob,
        "values": [str(v) for v in values],
        "per_value": {
            v: {
                "overall": round(recall(v, all_cats), 4),
                "per_category": {c: {"hits": table[v].get(c, (0, 0))[0],
                                     "total": table[v].get(c, (0, 0))[1]}
                                 for c in cats},
            } for v in table
        },
        "pool_best": pool_best,
        "pool_best_recall": round(recall(pool_best, all_cats), 4),
        "loco_picks": picks,
        "loco_recall": round(loco_hits / loco_total, 4) if loco_total else 0.0,
        "stable": len(set(picks.values())) == 1,
    }
