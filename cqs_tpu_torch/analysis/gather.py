"""Gather: search seeds -> call-graph expansion -> reading order.

Reference analog: ``src/gather.rs`` — ``GatherOptions`` (expand depth,
direction, seed limit/threshold, decay factor, node cap — defaults at
``src/gather.rs:173-184``), BFS expansion with depth/decay and a node cap
(``bfs_expand``, ``src/gather.rs:302``), parent dedup, and a reading order
that leads with the strongest seeds and groups by file.
"""

from __future__ import annotations

from dataclasses import dataclass

from cqs_tpu_torch.analysis.callgraph import CallGraph
from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.store.store import ChunkRow

DECAY = 0.6

#: ref: GatherDirection (src/gather.rs:187) — which edges BFS follows
DIRECTIONS = ("both", "callees", "callers")


@dataclass
class GatherItem:
    row: ChunkRow
    score: float
    via: str            # "seed" | "calls" | "called_by"

    def as_dict(self) -> dict:
        return {"name": self.row.qualified_name, "origin": self.row.origin,
                "line_start": self.row.line_start, "line_end": self.row.line_end,
                "score": round(self.score, 4), "via": self.via}


def gather(engine, query: str, depth: int = 2, limit: int = 20,
           direction: str = "both", seed_limit: int | None = None,
           seed_threshold: float = 0.0, decay: float = DECAY,
           lim: Limits | None = None) -> list[GatherItem]:
    """``direction`` restricts BFS to callee edges, caller edges, or both;
    ``seed_limit``/``seed_threshold`` bound which search hits seed the walk;
    ``decay`` is the per-hop score multiplier (ref defaults: direction=both,
    seed_limit=5, seed_threshold=0.3, decay=0.8 — src/gather.rs:173)."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    lim = lim or default_limits
    store: Store = engine.store
    n_seeds = seed_limit if seed_limit is not None else max(limit // 2, 5)
    res = engine.search(query, limit=n_seeds)
    graph = CallGraph.for_store(store)
    items: dict[str, GatherItem] = {}
    for hit in res.hits:
        if seed_threshold > 0.0 and hit.score < seed_threshold and items:
            break              # hits are score-ordered; keep >=1 seed
        items[hit.row.id] = GatherItem(hit.row, hit.score, "seed")

    dirs = (("calls", graph.fwd), ("called_by", graph.rev))
    if direction == "callees":
        dirs = (("calls", graph.fwd),)
    elif direction == "callers":
        dirs = (("called_by", graph.rev),)

    # frontier = accepted seeds only: sub-threshold hits must not seed the
    # expansion (nor leak in via reverse edges)
    frontier = [(cid, it.score) for cid, it in items.items()]
    for d in range(depth):
        nxt: list[tuple[str, float]] = []
        for cid, score in frontier:
            if len(items) >= lim.gather_node_cap:
                break
            for via, adj in dirs:
                for nid in sorted(adj.get(cid, ())):
                    if nid in items:
                        continue
                    s = score * decay
                    row = store.get_chunk(nid)
                    if row is None:
                        continue
                    items[nid] = GatherItem(row, s, via)
                    nxt.append((nid, s))
        frontier = nxt

    out = sorted(items.values(), key=lambda it: -it.score)[:limit]
    # reading order: strongest file first, then by line within file
    file_rank: dict[str, int] = {}
    for it in out:
        file_rank.setdefault(it.row.origin, len(file_rank))
    out.sort(key=lambda it: (file_rank[it.row.origin], it.row.line_start))
    return out
