"""Web serve: local HTTP API + embedded UI.

Port of ``cqs_tpu/daemon/serve.py``: a stdlib ``http.server`` threading
server on 127.0.0.1 with a per-launch 256-bit bearer token (timing-safe
comparison), endpoints ``/api/{stats,graph,chunk/:id,search,search_legs,
hierarchy/:id,embed/2d,eval_gold}`` and a small single-file UI, over the
port's ``BatchContext``. Each request runs on its own thread, so the
handlers read the store through that thread's own connection
(``Store._read_db``), never through the home connection.
"""

from __future__ import annotations

import hmac
import json
import secrets
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from cqs_tpu_torch.daemon.dispatch import BatchContext
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("serve")

_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>cqs-tpu</title>
<style>
body{font-family:ui-monospace,monospace;margin:2rem;background:#111;color:#ddd}
input{width:60%;padding:.5rem;background:#222;color:#eee;border:1px solid #444}
.hit{margin:.6rem 0;padding:.5rem;border-left:3px solid #4a8;background:#1a1a1a;cursor:pointer}
.score{color:#4a8}.path{color:#888}.sig{color:#aaa;font-size:.9em}
h1{font-size:1.2rem}#meta{color:#666;font-size:.85em}
#graph{margin-top:1rem;background:#161616;border:1px solid #333;display:none}
.gnode{cursor:pointer}
.gnode rect{fill:#223;stroke:#446}
.gnode.center rect{fill:#264;stroke:#4a8}
.gnode text{fill:#cde;font-size:11px}
.gedge{stroke:#556;stroke-width:1;marker-end:url(#arr)}
#legend{color:#666;font-size:.8em;display:none}
</style></head><body>
<h1>cqs-tpu</h1>
<input id="q" placeholder="search the index..." autofocus>
<div id="meta"></div><div id="out"></div>
<div id="legend">callers &#8594; <b>chunk</b> &#8594; callees &nbsp;(click a node to pivot, click a result to open)</div>
<svg id="graph" width="1100" height="460"></svg>
<script>
const token = new URLSearchParams(location.search).get('token');
let t;
document.getElementById('q').addEventListener('input', e => {
  clearTimeout(t); t = setTimeout(() => run(e.target.value), 250);
});
async function run(q) {
  if (!q) { out.innerHTML = ''; return; }
  const r = await fetch(`/api/search?q=${encodeURIComponent(q)}&token=${token}`);
  const data = await r.json();
  meta.textContent = `${data.category} / alpha=${data.alpha} / ${data.elapsed_ms} ms`;
  out.innerHTML = (data.results || []).map(h =>
    `<div class="hit" data-id="${encodeURIComponent(h.id)}">
     <span class="score">${h.score.toFixed(3)}</span>
     <b>${h.name}</b> <span class="path">${h.origin}:${h.line_start}</span>
     <div class="sig">${(h.signature||'').replace(/</g,'&lt;')}</div></div>`).join('');
  for (const el of document.querySelectorAll('.hit'))
    el.addEventListener('click', () => hierarchy(el.dataset.id));
}
// Layered call-graph explorer (the reference embeds Cytoscape; this renderer
// is dependency-free so it works with zero egress): callers in the left
// column, the chunk centered, callees right. Click any node to re-pivot.
async function hierarchy(encId) {
  const r = await fetch(`/api/hierarchy/${encId}?token=${token}`);
  const d = await r.json();
  const svg = document.getElementById('graph');
  if (d.error) { svg.style.display = 'none'; return; }
  svg.style.display = 'block'; legend.style.display = 'block';
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  const esc = s => String(s||'').replace(/&/g,'&amp;').replace(/</g,'&lt;');
  const col = (items, x) => items.slice(0, 14).map((n, i) => ({
    ...n, x, y: 30 + i * ((H - 50) / Math.max(items.length, 1))}));
  const callers = col(d.callers, 60);
  const callees = col(d.callees, W - 320);
  const cx = W/2 - 130, cy = H/2;
  let defs = `<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7"
    refY="3" orient="auto"><path d="M0,0 L7,3 L0,6" fill="none" stroke="#556"/>
    </marker></defs>`;
  let edges = '', nodes = '';
  const box = (n, x, y, center) => {
    const id = n.id ? encodeURIComponent(n.id) : '';
    return `<g class="gnode ${center?'center':''}" data-id="${id}"
      transform="translate(${x},${y})"><rect width="260" height="24" rx="4"/>
      <text x="6" y="16">${esc((n.name||'?').slice(0,34))}</text></g>`;
  };
  for (const n of callers) {
    edges += `<line class="gedge" x1="${n.x+260}" y1="${n.y+12}" x2="${cx}" y2="${cy+12}"/>`;
    nodes += box(n, n.x, n.y, false);
  }
  for (const n of callees) {
    edges += `<line class="gedge" x1="${cx+260}" y1="${cy+12}" x2="${n.x}" y2="${n.y+12}"/>`;
    nodes += box(n, n.x, n.y, false);
  }
  nodes += box(d.chunk, cx, cy, true);
  svg.innerHTML = defs + edges + nodes;
  for (const el of svg.querySelectorAll('.gnode[data-id]'))
    if (el.dataset.id) el.addEventListener('click', () => hierarchy(el.dataset.id));
  svg.scrollIntoView({behavior:'smooth'});
}
</script></body></html>"""


class ServeHandler(BaseHTTPRequestHandler):
    bctx: BatchContext = None
    token: str = ""

    def log_message(self, fmt, *args):  # quiet
        log.debug("http %s", fmt % args)

    def _authed(self, params: dict) -> bool:
        supplied = params.get("token", [""])[0]
        auth = self.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            supplied = auth[7:]
        return hmac.compare_digest(supplied, self.token)

    def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        parsed = urllib.parse.urlparse(self.path)
        params = urllib.parse.parse_qs(parsed.query)
        path = parsed.path
        if path == "/":
            self._send(200, _UI_HTML.encode(), "text/html")
            return
        if not self._authed(params):
            self._send(401, b'{"error":"unauthorized"}')
            return
        try:
            if path == "/api/stats":
                data = self.bctx.dispatch("stats", {})
            elif path == "/api/search":      # ?include_docs=1 searches all
                q = params.get("q", [""])[0]
                k = max(1, min(200, int(params.get("k", ["10"])[0])))
                inc = params.get("include_docs", ["0"])[0] in ("1", "true")
                res = self.bctx.ctx.engine.search(q, limit=k, include_docs=inc)
                data = {"results": [h.to_dict() for h in res.hits],
                        "category": res.category, "alpha": res.alpha,
                        "elapsed_ms": round(res.elapsed_ms, 1)}
            elif path == "/api/search_legs":
                # leg inspector: dense-only, sparse-heavy, and fused orderings
                q = params.get("q", [""])[0]
                eng = self.bctx.ctx.engine
                data = {
                    "dense": [h.to_dict() for h in eng.search(q, limit=10, alpha_override=1.0).hits],
                    "sparse": [h.to_dict() for h in eng.search(q, limit=10, alpha_override=0.01).hits],
                    "fused": [h.to_dict() for h in eng.search(q, limit=10).hits],
                }
            elif path == "/api/embed/2d":
                rows = self.bctx.ctx.store._read_db().execute(
                    "SELECT id, name, origin, chunk_type, umap_x, umap_y FROM chunks "
                    "WHERE umap_x IS NOT NULL LIMIT 20000").fetchall()
                data = {"points": [
                    {"id": r[0], "name": r[1], "origin": r[2], "type": r[3],
                     "x": r[4], "y": r[5]} for r in rows],
                    "note": "" if rows else "run `cqs-tpu embed-2d` first"}
            elif path == "/api/graph":
                edges = self.bctx.ctx.store.call_edges()[:2000]
                data = {"edges": [{"from": a, "to": b} for a, b in edges]}
            elif path.startswith("/api/hierarchy/"):
                # ref: /api/hierarchy/:id (src/serve/mod.rs:387-397) — the
                # chunk's one-hop call neighborhood for the graph explorer
                cid = urllib.parse.unquote(path[len("/api/hierarchy/"):])
                store = self.bctx.ctx.store
                row = store.get_chunk(cid)
                if row is None:
                    data = {"error": "not found"}
                else:
                    callers = [{"id": c.id, "name": c.qualified_name,
                                "origin": c.origin, "line": line, "kind": kind}
                               for c, line, kind in store.callers_of(row.name)[:40]]
                    callees = []
                    for callee, line, kind in store.callees_of(row.id)[:40]:
                        resolved = store.find_by_name(callee)
                        callees.append({
                            "name": callee, "line": line, "kind": kind,
                            "id": resolved[0].id if resolved else None,
                            "origin": resolved[0].origin if resolved else None})
                    siblings = [{"id": r[0], "name": r[1], "line": r[2]}
                                for r in store._read_db().execute(
                                    "SELECT id, name, line_start FROM chunks "
                                    "WHERE origin = ? AND id != ? AND parent_id IS NULL "
                                    "ORDER BY line_start LIMIT 60", (row.origin, cid))]
                    data = {"chunk": {"id": row.id, "name": row.qualified_name,
                                      "origin": row.origin, "line": row.line_start,
                                      "type": row.chunk_type,
                                      "signature": row.signature},
                            "callers": callers, "callees": callees,
                            "siblings": siblings}
            elif path == "/api/eval_gold":
                # ref: the eval_gold endpoint feeding the serve UI's gold
                # inspector (src/serve/mod.rs:387-397) — golds + their
                # resolution state against the live index
                from cqs_tpu_torch.eval import load_query_set

                qpath = params.get("path", [""])[0]
                root = Path(self.bctx.ctx.root).resolve()
                ok_path = False
                if qpath:
                    rp = Path(qpath).resolve()
                    # an HTTP param must not become an arbitrary-file-read
                    # primitive: only files under the project root resolve
                    ok_path = rp.is_file() and rp.is_relative_to(root)
                if not qpath:
                    data = {"error": "pass ?path=<v3 query json>"}
                elif not ok_path:
                    self._send(403, b'{"error":"path outside project root"}')
                    return
                else:
                    qs = load_query_set(qpath)
                    store = self.bctx.ctx.store
                    rows = store._read_db().execute(
                        "SELECT origin, name FROM chunks").fetchall()
                    have = {(o, (nm or "").split("#w")[0]) for o, nm in rows}
                    data = {"queries": [
                        {"query": q.query, "category": q.category,
                         "gold": ({"origin": q.gold.origin, "name": q.gold.name,
                                   "resolves": (q.gold.origin, q.gold.name) in have}
                                  if q.gold else None)}
                        for q in qs]}
            elif path.startswith("/api/chunk/"):
                cid = urllib.parse.unquote(path[len("/api/chunk/"):])
                row = self.bctx.ctx.store.get_chunk(cid)
                data = ({"id": row.id, "name": row.qualified_name, "origin": row.origin,
                         "body": row.body, "nl": row.nl} if row else {"error": "not found"})
            else:
                self._send(404, b'{"error":"not found"}')
                return
            self._send(200, json.dumps(data).encode())
        except Exception as e:
            log.warning("serve error: %s", e)
            self._send(500, json.dumps({"error": str(e)}).encode())


def run_server(bctx: BatchContext, host: str = "127.0.0.1", port: int = 7777,
               token: str | None = None) -> tuple[ThreadingHTTPServer, str]:
    """Start the HTTP server in a background thread; returns (server, token)."""
    token = token or secrets.token_hex(32)
    handler = type("BoundHandler", (ServeHandler,), {"bctx": bctx, "token": token})
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True, name="cqst-serve")
    t.start()
    log.info("serving on http://%s:%d/?token=%s", host, port, token)
    return httpd, token
