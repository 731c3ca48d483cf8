"""Shared command dispatch for daemon socket + batch + MCP + web.

Port of ``cqs_tpu/daemon/dispatch.py``: one handler table serving the daemon
socket, JSONL batch mode, the MCP bridge and the web API, so all surfaces
speak the same grammar, over the port's ``CommandContext`` (engine on an
explicit device) and ``QueryBatcher``. The CLI forwards to a live daemon
through the same table (``daemon/client.py``). The handlers are the
reference's; what the port adds is :meth:`BatchContext.close`, which stops
the batcher's threads, and a logged (not silent) failure of the background
reindex.

An exception in a handler is answered as ``{"error": ...}`` and the daemon
lives on; nothing here falls back to another device.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.utils.trace import get_tracer, span

log = get_tracer("daemon")


class BatchContext:
    """Holds warm store/engine handles shared by daemon clients."""

    def __init__(self, ctx: CommandContext, micro_batch: bool = False):
        self.ctx = ctx
        self.lock = threading.RLock()
        self._warmed = False
        self._batcher = None
        self._micro_batch = micro_batch
        self.last_request_ts = time.time()

    def warm(self) -> None:
        with self.lock:
            if not self._warmed:
                self.ctx.engine.embedder.warm()
                self._warmed = True

    @property
    def batcher(self):
        if self._batcher is None:
            from cqs_tpu_torch.daemon.batcher import QueryBatcher

            with self.lock:
                if self._batcher is None:
                    self._batcher = QueryBatcher(self.ctx.engine)
        return self._batcher

    def batcher_stats(self) -> dict | None:
        """Fusion observability: None until the first batched search."""
        return self._batcher.stats_snapshot() if self._batcher else None

    def close(self) -> None:
        """Stop the micro-batcher's loop thread and hydration pool, if one
        was started. The context (store, engine) stays the caller's to
        close."""
        with self.lock:
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.stop()

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, command: str, args: dict[str, Any]) -> dict:
        t0 = time.perf_counter()
        self.last_request_ts = time.time()
        # Simple searches micro-batch OUTSIDE the context lock so concurrent
        # clients fuse into one device program (cqs_tpu/daemon/batcher.py).
        if (self._micro_batch and command == "search"
                and not any(args.get(k) for k in ("filter", "lang", "alpha",
                                                  "rerank", "body"))):
            try:
                res = self.batcher.search(args["query"], limit=int(args.get("limit", 10)))
                return {"ok": True, "command": command,
                        "results": [h.to_dict() for h in res.hits],
                        "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 2),
                        "batched": res.meta.get("batch_size", 1)}
            except Exception as e:
                log.warning("batched search failed: %s", e)
                return {"error": f"{type(e).__name__}: {e}", "code": 1}
        handler = getattr(self, "h_" + command.replace("-", "_"), None)
        if handler is None:
            return {"error": f"unknown command {command!r}", "code": 2}
        try:
            with self.lock, span("daemon_dispatch", command=command):
                result = handler(args)
            return {"ok": True, "command": command, "results": result,
                    "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 2)}
        except Exception as e:  # daemon must not die on a bad request
            log.warning("dispatch %s failed: %s", command, e)
            return {"error": f"{type(e).__name__}: {e}", "code": 1}

    # -- handlers ----------------------------------------------------------

    def h_search(self, a: dict) -> list[dict]:
        chunk_types = None
        if a.get("types"):
            from cqs_tpu_torch.parser.types import ChunkType

            chunk_types = [ChunkType(t) for t in a["types"]]
        res = self.ctx.engine.search(
            a["query"], limit=int(a.get("limit", 10)),
            path_filter=a.get("filter"), lang_filter=a.get("lang"),
            alpha_override=a.get("alpha"), rerank=bool(a.get("rerank", False)),
            chunk_types=chunk_types,
            include_docs=bool(a.get("include_docs", False)))
        return [h.to_dict(include_body=bool(a.get("body", False))) for h in res.hits]

    def h_callers(self, a: dict) -> list[dict]:
        return [{"name": c.qualified_name, "origin": c.origin, "line": line, "kind": kind}
                for c, line, kind in self.ctx.store.callers_of(a["name"])]

    def h_callees(self, a: dict) -> list[dict]:
        out = []
        for row in self.ctx.store.find_by_name(a["name"]):
            for callee, line, kind in self.ctx.store.callees_of(row.id):
                out.append({"name": callee, "line": line, "kind": kind})
        return out

    def h_impact(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis import analyze_impact

        rep = analyze_impact(self.ctx.store, a["name"], depth=a.get("depth"))
        return rep.as_dict() if rep else {}

    def h_trace(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis import trace_path

        path = trace_path(self.ctx.store, a["src"], a["dst"])
        return [{"name": r.qualified_name, "origin": r.origin, "line_start": r.line_start}
                for r in (path or [])]

    def h_test_map(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis import test_map

        return [{"name": t.qualified_name, "origin": t.origin, "line_start": t.line_start}
                for t in test_map(self.ctx.store, a["name"])]

    def h_dead(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis import find_dead_code

        return find_dead_code(self.ctx.store)

    def h_gather(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis import gather

        items = gather(self.ctx.engine, a["query"], depth=int(a.get("depth", 2)),
                       limit=int(a.get("limit", 20)),
                       direction=str(a.get("direction", "both")),
                       seed_limit=(int(a["seed_limit"]) if "seed_limit" in a else None),
                       seed_threshold=float(a.get("seed_threshold", 0.0)),
                       decay=float(a.get("decay", 0.6)))
        return [it.as_dict() for it in items]

    def h_read(self, a: dict) -> list[dict]:
        rows = self.ctx.store.find_by_name(a["name"])
        return [{"name": r.qualified_name, "origin": r.origin,
                 "line_start": r.line_start, "line_end": r.line_end, "body": r.body}
                for r in rows[:3]]

    def h_stats(self, a: dict) -> dict:
        return self.ctx.store.stats()

    def h_status(self, a: dict) -> dict:
        from cqs_tpu_torch.cli.envelope import staleness_meta

        return {"slot": self.ctx.slot, **self.ctx.store.stats(),
                **staleness_meta(self.ctx.store, self.ctx.root)}

    def h_notes(self, a: dict) -> list[dict]:
        return [{"id": i, "target": t, "text": x, "sentiment": s}
                for i, t, x, s in self.ctx.store.notes_for(a.get("target"))]

    def h_note(self, a: dict) -> dict:
        nid = self.ctx.store.add_note(a["target"], a["text"], a.get("sentiment", "neutral"))
        return {"id": nid}

    def h_note_update(self, a: dict) -> dict:
        ok = self.ctx.store.update_note(int(a["id"]), a["text"], a.get("sentiment"))
        return {"updated": ok}

    def h_note_remove(self, a: dict) -> dict:
        return {"removed": self.ctx.store.remove_note(int(a["id"]))}

    def h_index(self, a: dict) -> dict:
        """Fire-and-forget reindex (ref: the gated MCP `index` tool): kick a
        background pipeline run and return immediately."""
        import threading

        def run():
            try:
                from cqs_tpu_torch.pipeline import run_index_pipeline

                run_index_pipeline(self.ctx.root, self.ctx.store, self.ctx.embedder,
                                   self.ctx._maybe_splade(), config=self.ctx.config,
                                   force=bool(a.get("force")))
                self.ctx.engine.load_or_build_indexes()
            except Exception as e:    # fire-and-forget: nobody waits for it
                log.warning("background reindex failed: %s: %s", type(e).__name__, e)

        threading.Thread(target=run, name="cqst-mcp-index", daemon=True).start()
        return {"started": True}

    def h_similar(self, a: dict) -> list[dict]:
        rows = self.ctx.store.find_by_name(a["name"])
        if not rows:
            return []
        res = self.ctx.engine.search(rows[0].nl or rows[0].body[:500],
                                     limit=int(a.get("limit", 10)) + 1)
        return [h.to_dict() for h in res.hits if h.row.id != rows[0].id]

    def h_ping(self, a: dict) -> dict:
        return {"pong": True, "ts": time.time()}

    def h_refresh(self, a: dict) -> dict:
        """Reload indexes after an external reindex (daemon coherence)."""
        self.ctx.engine.load_or_build_indexes()
        return {"refreshed": True}

    # -- idle management ---------------------------------------------------

    def maybe_idle_unload(self, idle_s: float | None = None,
                          threshold_s: float = 600.0) -> bool:
        """Drop the embedder's device-resident table after a long idle
        stretch (``Embedder.clear_session``). The next query rebuilds it on
        the same device and pays for that once."""
        if idle_s is None:
            idle_s = time.time() - self.last_request_ts
        if idle_s < threshold_s:
            return False
        with self.lock:
            self.ctx.engine.embedder.clear_session()
            self._warmed = False
        return True

    # -- analysis handlers (second wave) ----------------------------------

    def h_scout(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.context import scout

        return scout(self.ctx.engine, a["query"], limit=int(a.get("limit", 8)))

    def h_task(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.context import task_brief

        return task_brief(self.ctx.engine, a["description"])

    def h_onboard(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.context import onboard

        return onboard(self.ctx.store)

    def h_where(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis.context import suggest_placement

        return suggest_placement(self.ctx.engine, a["description"])

    def h_related(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis.context import find_related

        return find_related(self.ctx.store, a["name"], limit=int(a.get("limit", 10)))

    def h_suggest(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis.context import suggest_refactors

        return suggest_refactors(self.ctx.store)

    def h_plan(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.context import plan_task

        return plan_task(self.ctx.engine, a["description"])

    def h_kind(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.context import classify_kind

        return {"name": a["name"], "kind": classify_kind(self.ctx.store, a["name"])}

    def h_health(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.quality import health_report

        return health_report(self.ctx.store, self.ctx.root)

    def h_structural(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis.quality import structural_scan

        return structural_scan(self.ctx.store, pattern_filter=a.get("pattern"))

    def h_review(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.diffs import git_diff, review_diff

        diff = a.get("diff") or git_diff(self.ctx.root, a.get("base"))
        return review_diff(self.ctx.store, diff)

    def h_impact_diff(self, a: dict) -> dict:
        from cqs_tpu_torch.analysis.diffs import git_diff, impact_of_diff

        diff = a.get("diff") or git_diff(self.ctx.root, a.get("base"))
        return impact_of_diff(self.ctx.store, diff).as_dict()

    def h_explain(self, a: dict) -> dict:
        eng = self.ctx.engine
        res = eng.search(a["query"], limit=50)
        for rank, h in enumerate(res.hits):
            if h.row.name == a["name"] or h.row.qualified_name == a["name"]:
                return {"found": True, "rank": rank, "score": h.score,
                        "signals": h.signals, "category": res.category,
                        "alpha": res.alpha, "nl": h.row.nl[:300]}
        return {"found": False, "category": res.category, "alpha": res.alpha}

    def h_deps(self, a: dict) -> list[dict]:
        return [{"name": u.qualified_name, "origin": u.origin,
                 "line_start": u.line_start}
                for u in self.ctx.store.type_users(a["name"])]

    def h_neighbors(self, a: dict) -> list[dict]:
        rows = self.ctx.store.find_by_name(a["name"])
        if not rows:
            return []
        row = rows[0]
        siblings = sorted(self.ctx.store.iter_chunks(
            "origin = ? AND chunk_type != 'window'", (row.origin,)),
            key=lambda r: r.line_start)
        idx = next((i for i, s in enumerate(siblings) if s.id == row.id), 0)
        return [{"name": s.qualified_name, "origin": s.origin,
                 "line_start": s.line_start, "line_end": s.line_end,
                 "chunk_type": s.chunk_type, "is_target": s.id == row.id}
                for s in siblings[max(0, idx - 2): idx + 3]]

    def h_drift(self, a: dict) -> list[dict]:
        from cqs_tpu_torch.analysis.quality import drift_report

        return drift_report(self.ctx.store, self.ctx.engine.embedder)
