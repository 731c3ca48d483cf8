"""The port's warm daemon on the CPU: the dispatch table against the JAX
package's, the Unix-socket server under concurrent and hostile clients, the
watch loop, and the batch, MCP and web surfaces over the same table.

Tolerances: result structures equal, with floats (scores) within 1e-5 and
clock readings (``elapsed_ms``, ``ts``) left out; batched hits equal solo
hits (ids and order identical, scores within 1e-5)."""

import io
import json
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest
from cqs_tpu.cli.context import CommandContext as JContext
from cqs_tpu.daemon.dispatch import BatchContext as JBatchContext
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon import BatchContext, DaemonServer, ping, request
from cqs_tpu_torch.daemon import status as watch_status
from cqs_tpu_torch.daemon.batch import run_batch_loop
from cqs_tpu_torch.daemon.mcp import serve_stdio
from cqs_tpu_torch.daemon.protocol import read_json_line, socket_path, write_json_line
from cqs_tpu_torch.daemon.serve import run_server
from cqs_tpu_torch.daemon.watch import WatchLoop, run_watch
from cqs_tpu_torch.models.convert import embedder_params_from_jax
from cqs_tpu_torch.pipeline import run_index_pipeline
from test_torch_slice import QUERIES, _assert_same_hits, same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)
WAIT = 60.0          # every join, future and socket wait below is bounded
CLOCKS = {"elapsed_ms", "ts", "generated_at"}


def _short_dir() -> Path:
    """A directory under the temporary directory for a project whose
    daemon socket (``<dir>/p/.cqs-tpu/watch.sock``) must fit an AF_UNIX
    address, which holds about 107 bytes. The tests stay under the
    temporary directory they were given and say so when it is too long."""
    d = Path(tempfile.mkdtemp(prefix="cq"))
    sock = socket_path(d / "p" / ".cqs-tpu")
    if len(str(sock).encode()) > 104:
        d.rmdir()
        pytest.fail(f"the temporary directory {tempfile.gettempdir()!r} is too long for a "
                    f"Unix socket under it ({sock}): set TMPDIR to a shorter path")
    return d


def _project(root: Path) -> Path:
    """The suite's fixture project at ``root``, with its index directory in
    place so that nothing above ``root`` is taken for the project."""
    root.mkdir(parents=True)
    make = getattr(conftest.tmp_project, "__wrapped__", conftest.tmp_project)
    make(root)
    (root / ".cqs-tpu").mkdir()
    return root


@pytest.fixture(scope="module")
def pair():
    """The fixture project indexed under each package, a warm context each;
    the port's embedder carries the JAX table."""
    base = _short_dir()
    jctx = JContext.create(str(_project(base / "j")))
    ctx = CommandContext.create(str(_project(base / "t")), device="cpu")
    try:
        j_index(jctx.root, jctx.store, jctx.embedder, jctx._maybe_splade(), config=jctx.config)
        jctx.embedder._ensure_model()
        ctx.embedder.load_params(embedder_params_from_jax(
            {"table": np.asarray(jctx.embedder._params["table"])}))
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        _ = jctx.engine, ctx.engine
        yield ctx, jctx
    finally:
        jctx.close()
        ctx.close()
        shutil.rmtree(base, ignore_errors=True)


@pytest.fixture
def project():
    """A fresh copy of the fixture project, indexed by the port, under a
    short path."""
    base = _short_dir()
    root = _project(base / "p")
    assert main(["index", "--path", str(root), "--device", "cpu"]) == 0
    try:
        yield root
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _assert_close(port, ref, where="results"):
    """Equal structures; floats within 1e-5; clock readings skipped."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), where
        for k in ref:
            if k not in CLOCKS:
                _assert_close(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_close(a, b, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert abs(port - ref) <= 1e-5, (where, port, ref)
    else:
        assert port == ref, (where, port, ref)


DIFF = '''--- a/src/auth.py
+++ b/src/auth.py
@@ -3,4 +3,4 @@
 def validate_token(token: str) -> bool:
     """Validate a bearer token against the signing key."""
-    decoded = decode_jwt(token)
+    decoded = decode_jwt(token.strip())
     return check_expiry(decoded)
'''
#: every handler of the dispatch table, in an order in which the note
#: handlers find the note they need
REQUESTS = [
    ("search", {"query": "validate token", "limit": 5}),
    ("search", {"query": "retry with exponential backoff", "lang": "rust", "body": True}),
    ("search", {"query": "session store", "filter": "src/auth", "alpha": 0.5}),
    ("search", {"query": "token validation", "include_docs": True, "types": ["section"]}),
    ("callers", {"name": "decode_jwt"}),
    ("callees", {"name": "validate_token"}),
    ("impact", {"name": "check_expiry", "depth": 3}),
    ("trace", {"src": "validate_token", "dst": "decode_jwt"}),
    ("test-map", {"name": "backoff_delay"}),
    ("dead", {}),
    ("gather", {"query": "validate token", "depth": 2, "limit": 10}),
    ("read", {"name": "validate_token"}),
    ("stats", {}),
    ("status", {}),
    ("note", {"target": "validate_token", "text": "fragile", "sentiment": "warning"}),
    ("notes", {}),
    ("notes", {"target": "validate_token"}),
    ("note-update", {"id": 1, "text": "sturdy now", "sentiment": "positive"}),
    ("note-remove", {"id": 1}),
    ("similar", {"name": "decode_jwt", "limit": 3}),
    ("ping", {}),
    ("refresh", {}),
    ("scout", {"query": "session handling", "limit": 4}),
    ("task", {"description": "add token refresh to the session store"}),
    ("onboard", {}),
    ("where", {"description": "rate limiting for retries"}),
    ("related", {"name": "validate_token", "limit": 5}),
    ("suggest", {}),
    ("plan", {"description": "fix the expiry check"}),
    ("kind", {"name": "SessionStore"}),
    ("health", {}),
    ("structural", {}),
    ("review", {"diff": DIFF}),
    ("impact-diff", {"diff": DIFF}),
    ("explain", {"query": "validate token", "name": "validate_token"}),
    ("deps", {"name": "SessionStore"}),
    ("neighbors", {"name": "decode_jwt"}),
    ("drift", {}),
    ("no-such-command", {}),
    ("callers", {}),                      # a handler's KeyError becomes an error answer
]


def test_dispatch_table_matches_reference(pair):
    ctx, jctx = pair
    bctx, jbctx = BatchContext(ctx), JBatchContext(jctx)
    handlers = {n for n in dir(BatchContext) if n.startswith("h_")}
    assert handlers == {n for n in dir(JBatchContext) if n.startswith("h_")}
    asked = {"h_" + c.replace("-", "_") for c, _ in REQUESTS}
    assert handlers - asked == {"h_index"}           # fire-and-forget; below
    for command, args in REQUESTS:
        port, ref = bctx.dispatch(command, dict(args)), jbctx.dispatch(command, dict(args))
        assert ("error" in port) == ("error" in ref), (command, port, ref)
        _assert_close(port, ref, command)
    assert bctx.batcher_stats() is None          # nothing was micro-batched
    bctx.warm()
    assert bctx.maybe_idle_unload(idle_s=1.0) is False
    assert bctx.maybe_idle_unload(idle_s=1e9) is True and ctx.embedder._model is None


def test_background_index_handler(project):
    ctx = CommandContext.create(str(project), device="cpu")
    bctx = BatchContext(ctx)
    try:
        _ = ctx.engine
        (project / "src" / "late.py").write_text(
            'def late_arrival(x):\n    """Arrives after the first index."""\n    return x\n')
        assert bctx.dispatch("index", {})["results"] == {"started": True}
        # fire-and-forget: the answer came at once; the new chunk turns up
        # when the background run has reindexed and reloaded the indexes
        deadline = time.monotonic() + WAIT
        names: list[str] = []
        while "late_arrival" not in names and time.monotonic() < deadline:
            time.sleep(0.2)
            names = [h["name"] for h in
                     bctx.dispatch("search", {"query": "late arrival"})["results"]]
        assert "late_arrival" in names
        for t in threading.enumerate():
            if t.name == "cqst-mcp-index":
                t.join(timeout=WAIT)
                assert not t.is_alive()
    finally:
        bctx.close()
        ctx.close()


class _Daemon:
    """A ``DaemonServer`` over a micro-batching context, as ``watch
    --serve`` sets it up."""

    def __init__(self, root: Path):
        self.ctx = CommandContext.create(str(root), device="cpu")
        self.bctx = BatchContext(self.ctx, micro_batch=True)
        self.bctx.warm()
        self.server = DaemonServer(self.bctx, self.ctx.index_dir)
        self.server.start()

    def close(self) -> None:
        self.server.stop()
        self.bctx.close()
        self.ctx.close()


def _hit_pairs(results: list[dict]) -> list[tuple[str, float]]:
    return [(h["id"], h["score"]) for h in results]


def test_socket_clients_batched_equals_solo(project):
    d = _Daemon(project)
    try:
        solo = {q: [(h.row.id, round(h.score, 6)) for h in d.ctx.engine.search(q).hits]
                for q in QUERIES}
        d.ctx.engine._result_cache = {}          # the daemon computes its own answers
        assert ping(d.ctx.index_dir)
        answers: dict[int, list] = {}
        batcher = d.bctx.batcher
        batcher.pause()                          # the burst lands in one window

        def client(k: int) -> None:
            q = QUERIES[k]
            answers[k] = [request(d.ctx.index_dir, "search", {"query": q}, timeout=WAIT)]
            # a second request over a connection of its own
            answers[k].append(request(d.ctx.index_dir, "stats", {}, timeout=WAIT))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        try:
            # the loop may hold one entry that it took before the pause
            for _ in range(400):
                if batcher.q.qsize() >= 7:
                    break
                threading.Event().wait(0.05)
            assert batcher.q.qsize() >= 7
            threading.Event().wait(0.3)
        finally:
            batcher.resume()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        for k in range(8):
            resp, stats = answers[k]
            assert resp["ok"] and "error" not in resp and stats["ok"], resp
            _assert_same_hits(_hit_pairs(resp["results"]), solo[QUERIES[k]])
        snap = d.bctx.batcher_stats()
        assert snap["fused"] == 8 and snap["solo"] == 0
        assert max(snap["batch_size_hist"]) > 1
        assert max(answers[k][0]["batched"] for k in range(8)) > 1
    finally:
        d.close()
    assert not socket_path(project / ".cqs-tpu").exists()
    assert not d.server._thread.is_alive() and not batcher._thread.is_alive()


def _connect(index_dir: Path) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(WAIT)
    s.connect(str(socket_path(index_dir)))
    return s


@pytest.mark.parametrize("attack", ["garbage", "oversized", "disconnect"])
def test_hostile_client_leaves_server_answering(project, monkeypatch, attack):
    monkeypatch.setenv("CQST_DAEMON_RECV_MAX_BYTES", "4096")
    d = _Daemon(project)
    try:
        s = _connect(d.ctx.index_dir)
        if attack == "garbage":
            s.sendall(b"\x00\xff not json at all {{{\n")
            assert "error" in read_json_line(s, timeout=WAIT)
            assert s.recv(4096) == b""             # and the connection is dropped
        elif attack == "oversized":
            s.sendall(b'{"command":"search","args":{"query":"' + b"a" * 8192 + b'"}}\n')
            resp = read_json_line(s, timeout=WAIT)
            assert resp["code"] == 413 and "exceeds" in resp["error"]
        else:
            write_json_line(s, {"command": "search", "args": {"query": "validate token"}})
        s.close()
        # one connection, several rounds: still served
        s = _connect(d.ctx.index_dir)
        for q in QUERIES[:3]:
            write_json_line(s, {"command": "search", "args": {"query": q, "limit": 3}})
            resp = read_json_line(s, timeout=WAIT)
            assert resp["ok"] and resp["results"], resp
        write_json_line(s, {"command": "bogus"})
        assert read_json_line(s, timeout=WAIT)["code"] == 2
        s.close()
        assert ping(d.ctx.index_dir)
    finally:
        d.close()


def test_stale_socket_is_reclaimed_and_live_one_refused(project):
    path = socket_path(project / ".cqs-tpu")
    dead = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    dead.bind(str(path))
    dead.close()                                   # a daemon that died: the file stays
    assert path.exists() and not ping(project / ".cqs-tpu")
    d = _Daemon(project)
    try:
        assert ping(d.ctx.index_dir)
        second = DaemonServer(d.bctx, d.ctx.index_dir)
        with pytest.raises(RuntimeError, match="already live"):
            second.start()
        assert ping(d.ctx.index_dir)               # the live socket was left alone
    finally:
        d.close()


def test_cli_forwards_to_live_daemon(project, capsys):
    d = _Daemon(project)
    try:
        capsys.readouterr()
        for argv, command in ((["validate token", "-k", "3"], "search"),
                              (["callers", "decode_jwt"], "callers"),
                              (["stats"], "stats")):
            assert main(argv + ["--path", str(project), "--device", "cpu", "--json"]) == 0
            env = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert env["command"] == command and env["_meta"]["daemon"] is True
            assert env["results"]
        assert main(["ping", "--path", str(project), "--device", "cpu"]) == 0
        assert main(["refresh", "--path", str(project), "--device", "cpu"]) == 0
        assert "refreshed" in capsys.readouterr().out
    finally:
        d.close()
    # no daemon: the same commands run in-process
    assert main(["ping", "--path", str(project), "--device", "cpu"]) == 1
    assert main(["refresh", "--path", str(project), "--device", "cpu"]) == 1
    capsys.readouterr()
    assert main(["callers", "decode_jwt", "--path", str(project), "--device", "cpu",
                 "--json"]) == 0
    env = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "daemon" not in env["_meta"] and env["results"][0]["name"] == "validate_token"


def test_cli_lists_exactly_the_unported_commands(project, capsys):
    from cqs_tpu.cli.main import KNOWN_COMMANDS
    from cqs_tpu_torch.cli.commands import HANDLERS
    from cqs_tpu_torch.cli.main import PORTED_COMMANDS, REFERENCE_COMMANDS, build_parser

    assert REFERENCE_COMMANDS == KNOWN_COMMANDS
    assert PORTED_COMMANDS == set(HANDLERS) <= REFERENCE_COMMANDS
    # nothing is left unported: the parser serves exactly the reference's commands
    assert REFERENCE_COMMANDS - PORTED_COMMANDS == set()
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert set(sub.choices) == PORTED_COMMANDS == REFERENCE_COMMANDS
    assert main(["stale", "--path", str(project), "--device", "cpu"]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    # --rerank is ported: without reranker weights it is a logged no-op
    assert main(["search", "x", "--rerank", "--path", str(project), "--device", "cpu"]) == 0


@pytest.mark.parametrize("argv", [["ping"], ["status"], ["stats"], ["watch", "--once"],
                                  ["callers", "decode_jwt"], ["batch"], ["mcp"], ["serve"]])
def test_every_command_defaults_to_cuda(project, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv + ["--path", str(project)])


def test_watch_once_refreshes_incrementally_and_publishes(project, capsys):
    ctx = CommandContext.create(str(project), device="cpu")
    try:
        loop = WatchLoop(ctx)
        outcomes = []
        refresh = ctx.engine.refresh_incremental
        ctx.engine.refresh_incremental = lambda: (outcomes.append(refresh()), outcomes[-1])[1]
        assert loop.reconcile_once() == 0 and not outcomes
        assert watch_status.read(ctx.index_dir)["fresh"] is True
        rows = ctx.engine.dense.count
        (project / "src" / "late.py").write_text(
            'def late_arrival(x):\n    """Arrives after the first index."""\n    return x\n')
        (project / "src" / "retry.rs").unlink()
        assert loop.run(once=True) == 0
        assert len(outcomes) == 1
        assert outcomes[0]["appended"] == 1 and outcomes[0]["tombstoned"] >= 2
        assert ctx.engine.dense.count == rows + 1
        assert [h.row.name for h in ctx.engine.search("late arrival").hits][0] == "late_arrival"
        snap = watch_status.read(ctx.index_dir)
        assert snap["fresh"] is True and snap["last_reindex_files"] == 2
        assert snap["chunks"] == ctx.store.chunk_count()
        assert run_watch(ctx, once=True) == 0         # nothing changed: still fresh
    finally:
        ctx.close()
    capsys.readouterr()
    assert main(["status", "--watch", "--json", "--path", str(project), "--device", "cpu"]) == 0
    env = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert env["results"]["daemon"]["fresh"] is True
    assert env["results"]["daemon"]["chunks"] == env["results"]["chunks"]
    assert main(["status", "--wait", "--timeout", "5", "--path", str(project),
                 "--device", "cpu"]) == 0


def test_batch_mcp_and_web_round_trips(project, monkeypatch):
    ctx = CommandContext.create(str(project), device="cpu")
    try:
        want = [h.to_dict() for h in ctx.engine.search("validate token", limit=5).hits]

        # JSONL batch loop: a request object, a pipeline line, bad JSON
        out = io.StringIO()
        lines = ['{"command":"search","args":{"query":"validate token","limit":5}}',
                 'search "validate token" -k 3 | callers', "{not json"]
        assert run_batch_loop(ctx, io.StringIO("\n".join(lines) + "\n"), out) == 0
        first, piped, bad = [json.loads(x) for x in out.getvalue().splitlines()]
        assert first["ok"] and first["results"] == want
        assert piped["command"] == "callers" and piped["fanned_from"] >= 1
        assert bad["code"] == 2

        # MCP stdio bridge
        msgs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                 "params": {"name": "cqs_search",
                            "arguments": {"query": "validate token", "limit": 5}}},
                {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
                 "params": {"name": "cqs_index", "arguments": {}}}]
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdin", io.StringIO("".join(json.dumps(m) + "\n" for m in msgs)))
        monkeypatch.setattr(sys, "stdout", out)
        assert serve_stdio(ctx) == 0
        monkeypatch.undo()
        init, tools, call, gated = [json.loads(x) for x in out.getvalue().splitlines()]
        assert init["result"]["capabilities"] == {"tools": {}}
        assert "cqs_search" in {t["name"] for t in tools["result"]["tools"]}
        assert json.loads(call["result"]["content"][0]["text"]) == want
        assert gated["error"]["code"] == -32602        # mutation tools are gated

        # web API with its bearer token
        bctx = BatchContext(ctx)
        httpd, token = run_server(bctx, port=0)
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"

            def get(path, tok=None):
                req = urllib.request.Request(base + path)
                if tok:
                    req.add_header("Authorization", f"Bearer {tok}")
                with urllib.request.urlopen(req, timeout=WAIT) as r:
                    return r.status, r.read()

            status, body = get("/api/search?q=validate%20token&k=5", token)
            assert status == 200 and json.loads(body)["results"] == want
            status, body = get(f"/api/stats?token={token}")
            assert json.loads(body)["results"]["chunks"] == ctx.store.chunk_count()
            cid = urllib.request.quote(want[0]["id"], safe="")
            assert json.loads(get(f"/api/hierarchy/{cid}", token)[1])["chunk"]["id"] == want[0]["id"]
            assert get("/")[0] == 200                  # the UI itself needs no token
            for path, tok in (("/api/search?q=x", "wrong"), ("/api/stats", None)):
                with pytest.raises(urllib.error.HTTPError) as e:
                    get(path, tok)
                assert e.value.code == 401
        finally:
            httpd.shutdown()
            httpd.server_close()
            bctx.close()
    finally:
        ctx.close()
