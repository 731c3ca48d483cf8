"""Call-graph analytics: adjacency, BFS, impact, trace, dead code, test map.

Reference analog: ``src/impact/`` (``analyze_impact``, BFS with depth/node
caps at ``src/impact/bfs.rs``), ``src/store/calls/dead_code.rs`` (entry-point/
trait-method/test exclusions, confidence tiers), and the ``CallGraph``
fwd+rev adjacency in ``src/store/helpers/``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.parser.registry import get_language
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.store.store import ChunkRow


@dataclass
class CallGraph:
    """Name-resolved adjacency over chunk ids (forward = calls, reverse =
    called-by), built once per store snapshot."""

    fwd: dict[str, set[str]] = field(default_factory=dict)
    rev: dict[str, set[str]] = field(default_factory=dict)

    @classmethod
    def build(cls, store: Store) -> "CallGraph":
        g = cls()
        for caller, callee in store.call_edges():
            g.fwd.setdefault(caller, set()).add(callee)
            g.rev.setdefault(callee, set()).add(caller)
        return g

    @classmethod
    def for_store(cls, store: Store) -> "CallGraph":
        """Coherence-cached graph: rows are immutable per coherence token
        (generation moves on deletes, MAX(rowid) on appends), so a warm
        daemon serves every analysis call from ONE build (the
        rebuild-per-call path measured 10 s/impact on a 31k-chunk corpus);
        any reindex invalidates."""
        # key includes the resolved fanout cap: flipping
        # CQST_CALLGRAPH_FANOUT_CAP in a warm daemon must not serve a graph
        # built under the old cap
        key = (store.coherence_token(), default_limits.callgraph_fanout_cap)
        cached = getattr(store, "_callgraph_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        g = cls.build(store)
        store._callgraph_cache = (key, g)
        return g

    def bfs(self, start: str, reverse: bool = False, depth: int | None = None,
            node_cap: int | None = None) -> dict[str, int]:
        """Transitive closure with depth/node caps -> {chunk_id: distance}."""
        lim = default_limits
        depth = depth if depth is not None else lim.impact_depth
        node_cap = node_cap if node_cap is not None else lim.impact_node_cap
        adj = self.rev if reverse else self.fwd
        dist = {start: 0}
        q = deque([start])
        while q and len(dist) < node_cap:
            cur = q.popleft()
            if dist[cur] >= depth:
                continue
            for nxt in sorted(adj.get(cur, ())):
                if nxt not in dist:
                    dist[nxt] = dist[cur] + 1
                    q.append(nxt)
                    if len(dist) >= node_cap:
                        break
        dist.pop(start, None)
        return dist

    def shortest_path(self, src: str, dst: str, max_depth: int = 12) -> list[str] | None:
        """BFS shortest call path src -> dst (chunk ids)."""
        if src == dst:
            return [src]
        prev: dict[str, str] = {src: ""}
        q = deque([(src, 0)])
        while q:
            cur, d = q.popleft()
            if d >= max_depth:
                continue
            for nxt in sorted(self.fwd.get(cur, ())):
                if nxt in prev:
                    continue
                prev[nxt] = cur
                if nxt == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                q.append((nxt, d + 1))
        return None


def _resolve_name(store: Store, name: str) -> list[ChunkRow]:
    rows = store.find_by_name(name)
    if not rows:
        rows = store.search_by_name_fts(name, limit=5)
    return rows


@dataclass
class ImpactReport:
    target: ChunkRow
    callers: list[tuple[ChunkRow, int]]          # (chunk, distance)
    affected_tests: list[ChunkRow]
    risk: str                                     # High | Medium | Low
    risk_factors: list[str] = None                # why (ref: risk scoring)

    def as_dict(self) -> dict:
        return {
            "target": {"name": self.target.qualified_name, "origin": self.target.origin,
                       "line_start": self.target.line_start},
            "risk": self.risk,
            "risk_factors": self.risk_factors or [],
            "callers": [
                {"name": c.qualified_name, "origin": c.origin,
                 "line_start": c.line_start, "distance": d}
                for c, d in self.callers],
            "affected_tests": [
                {"name": t.qualified_name, "origin": t.origin, "line_start": t.line_start}
                for t in self.affected_tests],
        }


def analyze_impact(store: Store, name: str, depth: int | None = None,
                   graph: CallGraph | None = None,
                   lim: Limits | None = None) -> ImpactReport | None:
    """Transitive callers + affected tests + risk tier (ref: analyze_impact,
    risk thresholds in src/limits.rs:416-433)."""
    lim = lim or default_limits
    targets = _resolve_name(store, name)
    if not targets:
        return None
    target = targets[0]
    graph = graph or CallGraph.for_store(store)
    dist = graph.bfs(target.id, reverse=True, depth=depth)
    rows = store.get_chunks_by_ids(list(dist))
    callers = sorted(((r, dist[r.id]) for r in rows), key=lambda x: (x[1], x[0].origin))
    tests = [r for r, _ in callers if r.is_test]
    direct = sum(1 for _, d in callers if d == 1)
    factors: list[str] = []
    if direct >= lim.risk_high_callers:
        risk, tier = "High", 2
        factors.append(f"direct_callers={direct}")
    elif direct >= lim.risk_medium_callers:
        risk, tier = "Medium", 1
        factors.append(f"direct_callers={direct}")
    else:
        risk, tier = "Low", 0
    # Escalations beyond raw caller count (ref: the richer risk model in
    # src/impact/ + src/limits.rs:416-433 — blast radius and test coverage
    # matter, not just fan-in):
    non_test = [(r, d) for r, d in callers if not r.is_test]
    if len(non_test) >= 3 * lim.risk_high_callers:
        tier += 1
        factors.append(f"transitive_breadth={len(non_test)}")
    origins = {r.origin for r, _ in non_test}
    if len(origins) >= lim.risk_high_callers:
        tier += 1
        factors.append(f"cross_file_origins={len(origins)}")
    if not tests and direct >= lim.risk_medium_callers:
        tier += 1
        factors.append("no_test_coverage")
    risk = ("Low", "Medium", "High")[min(tier, 2)]
    return ImpactReport(target=target, callers=callers, affected_tests=tests,
                        risk=risk, risk_factors=factors)


def trace_path(store: Store, src_name: str, dst_name: str,
               graph: CallGraph | None = None) -> list[ChunkRow] | None:
    src = _resolve_name(store, src_name)
    dst = _resolve_name(store, dst_name)
    if not src or not dst:
        return None
    graph = graph or CallGraph.for_store(store)
    best: list[str] | None = None
    for s in src[:3]:
        for t in dst[:3]:
            path = graph.shortest_path(s.id, t.id)
            if path and (best is None or len(path) < len(best)):
                best = path
    if best is None:
        return None
    return store.get_chunks_by_ids(best)


def test_map(store: Store, name: str, graph: CallGraph | None = None) -> list[ChunkRow]:
    """Tests that (transitively) exercise a function."""
    rep = analyze_impact(store, name, graph=graph)
    return rep.affected_tests if rep else []


def find_dead_code(store: Store, graph: CallGraph | None = None) -> list[dict]:
    """Likely-dead callables with edge-kind provenance and confidence tiers
    (ref: ``src/store/calls/dead_code.rs`` — SQL-driven detection with
    entry-point/trait-method exclusions, confidence tiers, edge-kind
    provenance).

    Exclusion ladder (a hit anywhere removes the candidate):
    - entry points / dunders / test code
    - any STRONG incoming edge (call / method_call)
    - interface-member name match (trait/interface methods are dispatched
      dynamically — the call graph cannot see the call site)

    Confidence (weak evidence demotes instead of excluding):
    - high:   private-looking name, no references of any kind
    - medium: public name, no references; or referenced only by a weak edge
      (macro_heuristic / fn_pointer — heuristic extraction, may be real)
    - low:    name appears in other chunks' BODIES (string registration,
      decorator tables, config dispatch) or in doc comments — a caller the
      graph cannot prove. Each entry carries its ``evidence`` list.
    """
    graph = graph or CallGraph.for_store(store)
    out: list[dict] = []
    strong_called: set[str] = {
        r[0] for r in store._read_db().execute(
            "SELECT DISTINCT callee_name FROM function_calls "
            "WHERE kind IN ('call', 'method_call')")}
    weak_called: dict[str, str] = {}
    for name, kind in store._read_db().execute(
            "SELECT DISTINCT callee_name, kind FROM function_calls "
            "WHERE kind IN ('macro_heuristic', 'fn_pointer')"):
        weak_called.setdefault(name, kind)
    doc_referenced: set[str] = {
        r[0] for r in store._read_db().execute(
            "SELECT DISTINCT callee_name FROM function_calls "
            "WHERE kind = 'doc_reference'")}
    # dynamic-dispatch shield: names declared on interfaces/traits/protocols
    interface_members: set[str] = {
        r[0] for r in store._read_db().execute(
            "SELECT DISTINCT name FROM chunks WHERE parent_name IN "
            "(SELECT name FROM chunks WHERE chunk_type IN ('interface', 'trait'))")}
    interface_members |= {
        r[0] for r in store._read_db().execute(
            "SELECT DISTINCT c2.name FROM chunks c1 JOIN chunks c2 "
            "ON c2.parent_name = c1.name WHERE c1.chunk_type = 'interface'")}

    from cqs_tpu_torch.utils.text import normalize_for_fts

    def body_referenced(row) -> bool:
        """Name mentioned in OTHER chunks' code bodies (registration tables,
        decorators-by-name, CLI dispatch) — an exact PHRASE query against the
        body FTS index (OR-of-words would match any chunk sharing one word)."""
        toks = normalize_for_fts(row.name).split()
        if not toks or (len(toks) == 1 and len(toks[0]) < 6):
            return False           # short single words match everything
        phrase = '"' + " ".join(toks[:6]) + '"'
        try:
            hits = store._read_db().execute(
                "SELECT id FROM chunks_fts_body WHERE chunks_fts_body MATCH ? "
                "LIMIT 8", (phrase,)).fetchall()
        except Exception:
            return False
        own_prefix = f"{row.origin}:{row.line_start}:"
        return any(cid != row.id and not cid.startswith(own_prefix)
                   for (cid,) in hits)

    for row in store.iter_chunks("chunk_type IN ('function','method')"):
        if row.is_test:
            continue
        lang = get_language(row.language)
        entry_points = set(lang.entry_points) if lang else {"main"}
        if row.name in entry_points or row.name.startswith("__"):
            continue
        if row.name in strong_called or row.id in graph.rev:
            continue
        if row.name in interface_members and row.parent_name:
            continue               # likely dynamic dispatch via the interface
        evidence: list[str] = []
        confidence = "high" if row.name.startswith("_") else "medium"
        weak = weak_called.get(row.name)
        if weak:
            confidence = "medium"
            evidence.append(f"weak_edge:{weak}")
        if row.name in doc_referenced:
            confidence = "low"
            evidence.append("doc_reference")
        if confidence != "low" and body_referenced(row):
            confidence = "low"
            evidence.append("body_mention")
        out.append({
            "name": row.qualified_name, "origin": row.origin,
            "line_start": row.line_start, "confidence": confidence,
            "chunk_type": row.chunk_type, "evidence": evidence,
        })
    tier = {"high": 0, "medium": 1, "low": 2}
    out.sort(key=lambda d: (tier[d["confidence"]], d["origin"], d["line_start"]))
    return out
