"""The port stands alone: it imports nothing of ``cqs_tpu``, keeps its own
copies of the reference's host modules (pinned to them here), and shares
the on-disk format with the reference, so either package opens the other's
index.

Tolerances: none; every comparison here is exact."""

import ast
import dataclasses
import enum
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import cqs_tpu.models.tokenizer as j_tok
import cqs_tpu.native as j_native
import cqs_tpu.search.router as j_router
import cqs_tpu.store.schema as j_schema
from cqs_tpu.nl import generate_nl as j_generate_nl
from cqs_tpu.parser import parse_file as j_parse_file
from cqs_tpu.parser.types import PARSER_VERSION as J_PARSER_VERSION
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu.store import Store as JStore
from cqs_tpu.cli.context import CommandContext as JContext
import cqs_tpu_torch.models.tokenizer as t_tok
import cqs_tpu_torch.native as t_native
import cqs_tpu_torch.search.router as t_router
import cqs_tpu_torch.store.schema as t_schema
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.nl import generate_nl
from cqs_tpu_torch.parser import parse_file
from cqs_tpu_torch.parser.types import PARSER_VERSION
from cqs_tpu_torch.store import Store

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "cqs_tpu"
PORT = REPO / "cqs_tpu_torch"

#: Host modules the port keeps as copies of the reference's, at the same
#: relative path; only ``cqs_tpu.`` is renamed ``cqs_tpu_torch.`` in them.
COPIES = (
    "utils/hashing.py", "utils/text.py", "utils/walk.py", "utils/__init__.py",
    "config.py", "data/classifier_centroids.v1.json",
    "parser/types.py", "parser/registry.py", "parser/generic.py", "parser/python_ast.py",
    "parser/docs.py", "parser/web.py", "parser/__init__.py",
    "nl/__init__.py",
    "store/schema.py", "store/migrations.py", "store/slots.py", "store/cache.py",
    "store/lock.py", "store/store.py", "store/__init__.py", "store/projects.py",
    "models/tokenizer.py", "models/registry.py",
    "index/stamp.py", "index/lexical.py",
    "search/synonyms.py", "search/router.py", "search/scoring.py",
    "cli/envelope.py",
    "daemon/protocol.py", "daemon/client.py", "daemon/status.py", "daemon/inotify.py",
    "analysis/__init__.py", "analysis/callgraph.py", "analysis/context.py",
    "analysis/diffs.py", "analysis/extraction_audit.py", "analysis/gather.py",
    "analysis/quality.py",
    "eval/__init__.py", "eval/cv.py", "eval/triage.py",
    # the JSONL and MCP surfaces reach the engine only through the context
    # they are given: their text needs no change beyond the rename
    "daemon/batch.py", "daemon/mcp.py",
    # training data and teacher labels: host code over the store and the engine
    "train/__init__.py", "train/data.py", "train/distill.py",
    # LLM enrichment over urllib, the labeling that calls engine.search, and
    # the document converters (stdlib only)
    "llm/__init__.py", "llm/provider.py", "llm/summaries.py", "llm/doc_writer.py",
    "eval/labeling.py", "convert.py", "pdf.py", "chm.py",
)
#: Modules at a reference path that are ports, not copies: they run the
#: device work on PyTorch, or (``native/__init__.py``, the one exception to
#: the drift check) build the tokenizer's C++ from the port's own copy into
#: the port's ``_build/`` rather than into the reference's directory.
PORTED = (
    "__init__.py", "__main__.py", "pipeline.py", "cli/__init__.py", "cli/context.py",
    "cli/main.py", "daemon/__init__.py", "daemon/batcher.py", "index/__init__.py",
    "index/dense.py", "index/sparse.py", "models/__init__.py", "models/embedder.py",
    "models/splade.py", "native/__init__.py", "ops/__init__.py", "ops/fusion.py",
    "ops/sparse.py", "ops/topk.py", "search/__init__.py", "search/engine.py",
    "search/program.py",
    "cli/commands.py", "daemon/dispatch.py", "daemon/server.py", "daemon/watch.py",
    "daemon/serve.py",
    "models/bert.py", "models/gemma.py", "models/hybrid.py", "models/loader.py",
    "models/reranker.py",
    "index/graph.py", "index/tiered.py", "store/overlay.py", "ops/project2d.py",
    "parallel/__init__.py", "parallel/train.py",
    "parallel/mesh.py", "parallel/sharded_hybrid.py",
    # the reference's spans and telemetry, plus an in-memory recorder of the
    # port's spans and counters
    "utils/trace.py",
)

#: ``store/store.py``'s difference from its original, all of it (the other
#: copies that differ: ``ANALYSIS_READS``, ``PROJECTS_DEVICE``, ``NL_BASE``). A worker thread must never read through the home
#: connection (two threads running the same SQL text on one connection share
#: its cached prepared statement, and one thread's step takes the other's
#: row), so in the port (1) ``Store._read_db`` is the text below: it retries
#: the read-only open and raises rather than hand out ``self.db``; (2) the
#: read methods named in ``STORE_READS``, which the reference lets read
#: ``self.db`` from any thread, say ``self._read_db()`` wherever the
#: reference says ``self.db``. Every other line is the reference's.
STORE_READ_DB = '''\
    def _read_db(self) -> sqlite3.Connection:
        """The connection to READ from in the calling thread: the home
        connection on the thread that opened the store, else that thread's
        own read-only connection (WAL gives it the last committed snapshot).
        A worker thread is never handed the home connection: two threads that
        run the same SQL text on one connection share its cached prepared
        statement, and one thread's step takes the other's row. The open is
        retried; when it still fails, the error is raised."""
        if threading.get_ident() == self._home_thread:
            return self.db
        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            for attempt in range(3):
                try:
                    conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True,
                                           timeout=30.0)
                    conn.execute("PRAGMA mmap_size=268435456")
                    break
                except sqlite3.OperationalError:
                    if attempt == 2:
                        raise
                    time.sleep(0.05 * (attempt + 1))
            self._tlocal.conn = conn
        return conn

'''
STORE_READS = (
    "chunk_count", "find_by_name", "iter_chunks", "all_origins", "pending_embeddings",
    "load_embeddings", "get_embedding_by_canonical", "load_sparse", "missing_sparse",
    "search_by_name_fts", "get_fingerprint", "registered_origins", "stale_parser_origins",
    "callers_of", "callees_of", "call_edges", "type_users", "notes_for", "get_summaries",
    "stats",
)


def port_store_text(reference: str) -> str:
    """The reference's ``store/store.py`` (package already renamed) with the
    port's allowed difference applied, method by method."""
    methods = re.split(r"(?m)^(?=    def )", reference)
    names = [m.group(1) if (m := re.match(r"    def (\w+)\(", part)) else None
             for part in methods]
    assert names.count("_read_db") == 1 and all(names.count(n) == 1 for n in STORE_READS)
    for i, name in enumerate(names):
        if name == "_read_db":
            methods[i] = STORE_READ_DB
        elif name in STORE_READS:
            assert "self.db" in methods[i], name
            methods[i] = re.sub(r"\bself\.db\b", "self._read_db()", methods[i])
    return "".join(methods)


#: Copies whose one allowed difference is that their reads of the store go
#: through ``store._read_db()`` where the reference says ``store.db``: the
#: daemon calls them from client threads, which must never read through the
#: writer's connection (``tests/test_torch_store_threads.py``). Their
#: originals read through ``store.db`` and never write through it
#: (``test_analysis_reads_are_only_reads``). ``analysis/diffs.py`` reads
#: through the store's methods only and stays verbatim.
ANALYSIS_READS = ("analysis/callgraph.py", "analysis/context.py",
                  "analysis/extraction_audit.py", "analysis/quality.py")

#: ``store/projects.py``'s one allowed difference, line for line: another
#: project's engine opens on the caller's device (the port's
#: ``CommandContext.create`` takes a keyword-only ``device`` with no
#: default), threaded through ``open_project_engine`` and
#: ``cross_project_search``.
PROJECTS_DEVICE = (
    ("def open_project_engine(name: str):\n",
     "def open_project_engine(name: str, *, device: str | torch.device):\n"),
    ('    """Open a registered project\'s store + engine (read-only search scope)."""\n',
     '    """Open a registered project\'s store + engine (read-only search scope)\n'
     '    on ``device``, the caller\'s: never a device of its own choosing."""\n'),
    ("    ctx = CommandContext.create(str(root))\n",
     "    ctx = CommandContext.create(str(root), device=device)\n"),
    ("def cross_project_search(names: list[str], query: str, limit: int = 10) -> list[dict]:\n",
     "def cross_project_search(names: list[str], query: str, limit: int = 10, *,\n"
     "                         device: str | torch.device) -> list[dict]:\n"),
    ("        ctx = open_project_engine(name)\n",
     "        ctx = open_project_engine(name, device=device)\n"),
)


#: ``nl/__init__.py``'s one allowed difference, line for line: the index
#: pipeline's enrichment pass hands ``generate_nl_enriched`` the base NL it
#: stored (keyword-only ``base``; ``chunk`` is then None), and caller and
#: callee names' words come from a cache (``tests/test_torch_enrich_base.py``).
NL_BASE = (
    ("import re as _re\n", "import functools\nimport re as _re\n"),
    ("def generate_nl_enriched(\n    chunk: Chunk,\n",
     "@functools.lru_cache(maxsize=1 << 16)\n"
     "def _name_words(name: str) -> str:\n"
     '    """A caller\'s or callee\'s name as words. Cached: the enrichment pass\n'
     '    names the same few hundred functions in every row that calls them."""\n'
     '    return " ".join(tokenize_identifier(name))\n\n\n'
     "def generate_nl_enriched(\n    chunk: Chunk | None,\n"),
    ("    lim: Limits | None = None,\n) -> str:\n    \"\"\"Enriched NL",
     "    lim: Limits | None = None,\n    *,\n    base: str | None = None,\n) -> str:\n"
     "    \"\"\"Enriched NL"),
    ("    queries are appended (ref: src/nl/mod.rs:44-120).\n",
     "    queries are appended (ref: src/nl/mod.rs:44-120).\n\n"
     "    ``base``, when non-empty, is the chunk's base NL as ``generate_nl(chunk,\n"
     "    max_seq_len)`` gives it (the index pipeline's stored ``nl_base``);\n"
     "    ``chunk`` is then not read and may be None.\n"),
    ("    base = generate_nl(chunk, max_seq_len)\n",
     "    base = base or generate_nl(chunk, max_seq_len)\n"),
    ('[" ".join(tokenize_identifier(c)) for c in ctx.callers',
     "[_name_words(c) for c in ctx.callers"),
    ('[" ".join(tokenize_identifier(c)) for c in kept',
     "[_name_words(c) for c in kept"),
)


def port_copy_text(rel: str, reference: str) -> str:
    """The reference's text of a copy (package already renamed) with the
    port's allowed difference for that copy applied."""
    if rel == "store/store.py":
        return port_store_text(reference)
    if rel in ANALYSIS_READS:
        assert re.search(r"\bstore\.db\b", reference), rel
        return re.sub(r"\bstore\.db\b", "store._read_db()", reference)
    for path, diff in (("store/projects.py", PROJECTS_DEVICE), ("nl/__init__.py", NL_BASE)):
        if rel == path:
            for old, new in diff:
                assert reference.count(old) == 1, old
                reference = reference.replace(old, new)
    return reference


def test_analysis_reads_are_only_reads():
    # every use of the writer's connection that the port moves is a read
    for rel in ANALYSIS_READS:
        text = (REF / rel).read_text()
        uses = [ln for ln in text.splitlines() if re.search(r"\bstore\.db\b", ln)]
        assert uses, rel
        assert not re.search(r"\b(INSERT|UPDATE|DELETE|REPLACE)\b|commit\(|write_txn", text), rel
        assert "store.db" not in (PORT / rel).read_text(), rel


def reference_imports(source: str) -> list[str]:
    """Names of ``cqs_tpu`` modules a Python source imports: import
    statements at any depth, and ``importlib.import_module`` or
    ``__import__`` of a literal name. ``cqs_tpu_torch`` is not one."""
    def is_ref(name) -> bool:
        return isinstance(name, str) and (name == "cqs_tpu" or name.startswith("cqs_tpu."))

    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if is_ref(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and is_ref(node.module):
            found.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and is_ref(node.args[0].value)
              and (getattr(node.func, "attr", None) == "import_module"
                   or getattr(node.func, "id", None) == "__import__")):
            found.append(node.args[0].value)
    return found


PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                      if "_build" not in p.parts) + ["chip_smoke.py", "scripts/torch_ab.py",
                                                     "scripts/torch_graph_recall.py"]


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_import_of_reference(rel):
    assert reference_imports((REPO / rel).read_text()) == []


#: Packages the card's machine lacks or the port must not load; the neural
#: model modules import none of them (the one exception in the package is
#: ``models/tokenizer.py``, a drift-pinned copy whose ``HFTokenizer`` loads
#: ``tokenizers`` for a ``tokenizer.json``)
FOREIGN = ("jax", "jaxlib", "flax", "optax", "safetensors", "transformers", "tokenizers")
MODEL_SOURCES = ("models/__init__.py", "models/bert.py", "models/convert.py",
                 "models/embedder.py", "models/gemma.py", "models/hybrid.py",
                 "models/layers.py", "models/loader.py", "models/reranker.py",
                 "models/splade.py", "search/engine.py", "cli/context.py", "cli/commands.py",
                 "parallel/train.py", "parallel/mesh.py", "parallel/sharded_hybrid.py",
                 "parallel/tensor_parallel.py")


def imported_roots(source: str) -> set[str]:
    """Top-level package names a Python source imports, at any depth."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", MODEL_SOURCES)
def test_model_modules_import_nothing_foreign(rel):
    assert imported_roots((PORT / rel).read_text()) & set(FOREIGN) == set()
    assert reference_imports((PORT / rel).read_text()) == []


def test_foreign_scan_sees_nested_imports():
    src = "import torch\ndef f():\n    from safetensors.numpy import load_file\n    import jax.numpy\n"
    assert imported_roots(src) & set(FOREIGN) == {"safetensors", "jax"}


def test_import_scan_matches_only_the_reference():
    src = textwrap.dedent("""
        import cqs_tpu_torch.config
        from cqs_tpu_torch import native
        import os, cqs_tpu
        def f():
            from cqs_tpu.store import Store
            import importlib
            importlib.import_module("cqs_tpu.search")
            __import__("cqs_tpu_torch.search")
    """)
    assert reference_imports(src) == ["cqs_tpu", "cqs_tpu.store", "cqs_tpu.search"]


#: the native sources the port keeps beside its loader, copies of the
#: repository's ``native/``
NATIVE_COPIES = ("native/fastscan.cpp", "native/hostscan.cpp")


@pytest.mark.parametrize("rel", COPIES + NATIVE_COPIES)
def test_copy_matches_reference(rel):
    port = PORT / rel
    ref = REPO / rel if rel in NATIVE_COPIES else REF / rel
    if rel.endswith(".py"):
        want = re.sub(r"\bcqs_tpu\.", "cqs_tpu_torch.", ref.read_text())
        assert port.read_text() == port_copy_text(rel, want)
    else:
        assert port.read_bytes() == ref.read_bytes()


def test_every_module_is_a_copy_or_a_port():
    twins = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
             if "_build" not in p.parts and (REF / p.relative_to(PORT)).is_file()}
    assert twins == set(c for c in COPIES if c.endswith(".py")) | set(PORTED)


def test_on_disk_format_versions_shared():
    assert t_schema.SCHEMA_VERSION == j_schema.SCHEMA_VERSION
    assert PARSER_VERSION == J_PARSER_VERSION
    assert t_tok.TOKENIZER_VERSION == j_tok.TOKENIZER_VERSION


def test_port_runs_alone_from_a_copy(tmp_project, tmp_path):
    # both packages copied to a directory of their own, without built
    # libraries: the port indexes, searches and serves a daemon, and must
    # neither import the reference nor write under it (the tokenizer's
    # library goes to the port's _build/)
    pkgs = tmp_path / "pkgs"
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so", "*.srchash")
    for name in ("cqs_tpu", "cqs_tpu_torch"):
        shutil.copytree(REPO / name, pkgs / name, ignore=ignore)
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        pkgs = Path({str(pkgs)!r})
        def files():
            return {{str(p): (p.stat().st_size, p.stat().st_mtime_ns)
                    for p in (pkgs / "cqs_tpu").rglob("*")
                    if p.is_file() and "__pycache__" not in p.parts}}
        before = files()
        import torch
        torch.set_num_threads(1)
        import cqs_tpu_torch
        from cqs_tpu_torch.cli.main import main
        assert Path(cqs_tpu_torch.__file__).parent == pkgs / "cqs_tpu_torch"
        # the project under a short path: the daemon's socket lies inside it,
        # and an AF_UNIX address holds about 107 bytes
        import os, shutil, tempfile
        short = tempfile.mkdtemp(prefix="cq")
        assert len(short + "/p/.cqs-tpu/watch.sock") <= 104, (
            "the temporary directory is too long for a Unix socket under it: " + short)
        root = shutil.copytree({str(tmp_project)!r}, short + "/p")
        os.mkdir(root + "/.cqs-tpu")
        assert main(["index", "--path", root, "--device", "cpu"]) == 0
        assert main(["validate token", "--path", root, "--device", "cpu", "--json"]) == 0
        # one step of the (dp, tp) training grid on logical CPU devices
        from cqs_tpu_torch.parallel import make_2d_mesh
        from cqs_tpu_torch.parallel.train import ContrastiveTrainer, TrainConfig
        cfg = TrainConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=4,
                          intermediate_size=64, seq_len=8, batch_per_device=2)
        fn, example = ContrastiveTrainer(cfg, mesh=make_2d_mesh(4, dp=2, device="cpu")).jitted_step()
        assert len(fn(*example)) == 4
        # the search served through the host mirror, whose native scans the
        # port builds into its own _build/ (where g++ exists)
        from cqs_tpu_torch import native
        if shutil.which("g++"):
            assert native._hlib is not None
            assert native._HLIB.parent == pkgs / "cqs_tpu_torch" / "_build" / "native"
        # a daemon on the socket: started, asked over the wire, stopped
        from cqs_tpu_torch.cli.context import CommandContext
        from cqs_tpu_torch.daemon import BatchContext, DaemonServer, ping, request
        ctx = CommandContext.create(root, device="cpu")
        bctx = BatchContext(ctx, micro_batch=True)
        server = DaemonServer(bctx, ctx.index_dir)
        server.start()
        try:
            assert ping(ctx.index_dir)
            resp = request(ctx.index_dir, "search", {{"query": "validate token"}})
            assert resp["ok"] and resp["results"], resp
            assert main(["callers", "decode_jwt", "--path", root, "--device", "cpu"]) == 0
        finally:
            server.stop()
            bctx.close()
            ctx.close()
        assert not ping(ctx.index_dir)
        loaded = [m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("cqs_tpu", "jax", "jaxlib", "flax", "optax")]
        assert not loaded, loaded
        assert files() == before, "files under cqs_tpu/ changed"
        shutil.rmtree(short)
        print("STANDALONE_OK")
    """)
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and Path(p).resolve() != REPO]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(pkgs)] + path))
    env.pop("CQST_DISABLE_NATIVE", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE_OK" in proc.stdout and '"command":"search"' in proc.stdout
    if shutil.which("g++"):
        assert (pkgs / "cqs_tpu_torch" / "_build" / "native" / "libfastscan.so").is_file()
    assert not list((pkgs / "cqs_tpu").rglob("*.so"))


def _plain(x):
    """A value with the package's classes taken out: dataclasses become
    dicts of their fields, enums their values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("subdir", ["cqs_tpu/parser", "cqs_tpu/search", "docs", "native"])
def test_parse_and_nl_agree(subdir):
    files = sorted(p for p in (REPO / subdir).rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts and p.suffix not in (".so", ".srchash"))
    n_chunks = 0
    for path in files:
        port, ref = parse_file(path, root=REPO), j_parse_file(path, root=REPO)
        assert (port is None) == (ref is None), path
        if port is None:
            continue
        assert _plain(port) == _plain(ref), path
        assert [generate_nl(c) for c in port.chunks] == [j_generate_nl(c) for c in ref.chunks]
        n_chunks += len(port.chunks)
    assert n_chunks > 0


ROUTER_QUERIES = [
    "validate token", "fn cmd_audit_mode", "how does the store upsert chunks",
    "functions that call parse_file", "retry with exponential backoff in rust",
    "struct Config", "error handling without panics", "def generate_nl",
    "what implements the Embedder trait", "sort a list of integers", "TODO",
    "class HashTokenizer", "read config from toml file",
]


@pytest.mark.parametrize("query", ROUTER_QUERIES)
def test_router_classification_and_alpha_agree(query):
    port, ref = t_router.classify_query(query), j_router.classify_query(query)
    assert _plain(port) == _plain(ref)
    assert t_router.resolve_alpha(port) == j_router.resolve_alpha(ref)
    assert t_router.structural_terms(query) == j_router.structural_terms(query)
    assert t_router.sig_slots(query) == j_router.sig_slots(query)


TOKENIZER_TEXTS = [p.read_text() for p in sorted((REF / "search").glob("*.py"))] + [
    "validate_token(decodeJwt(x)) -> bool", "unicode: café naïve", ""]


def reference_library(monkeypatch, get, tried: str, lib: str, current,
                      timeout: float = 180.0, settle: float = 60.0):
    """``get()`` of one of the reference's native libraries, loaded once a
    build of it has finished.

    The reference compiles each library straight onto the path it loads
    from (``cqs_tpu/native/__init__.py``), and its loader gives up for the
    rest of the process (``tried`` set, ``lib`` None) when its
    ``ctypes.CDLL`` meets a file another test process is still writing:
    processes that start together in a fresh checkout leave some of them
    without the library. So: wait until a build has finished (its stamp
    matches its source, ``current()``), then reset the loader's two globals
    through ``monkeypatch`` and load again; past ``settle`` seconds without
    a finished build, let the loader build it itself."""
    got = get()
    t0 = time.monotonic()
    while got is None and time.monotonic() - t0 < timeout:
        if current() or time.monotonic() - t0 > settle:
            monkeypatch.setattr(j_native, tried, False)
            monkeypatch.setattr(j_native, lib, None)
            got = get()
        if got is None:
            time.sleep(0.5)
    return got


def native_tokenizers(monkeypatch) -> tuple:
    """(reference, port) tokenizer libraries, the reference's loaded by
    :func:`reference_library` wherever the port's loaded."""
    port = t_native.get_lib()
    ref = j_native.get_lib()
    if port is not None and ref is None:
        ref = reference_library(monkeypatch, j_native.get_lib, "_tried", "_lib",
                                j_native._lib_current)
    return ref, port


def test_reference_library_reloads_after_a_failed_load(monkeypatch):
    # the state a half-written library leaves a process in: the loader has
    # given up on a finished build; reloading must find the library
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build the tokenizer libraries")
    assert j_native.get_lib() is not None or native_tokenizers(monkeypatch)[0] is not None
    monkeypatch.setattr(j_native, "_tried", True)
    monkeypatch.setattr(j_native, "_lib", None)
    assert j_native.get_lib() is None
    ref, port = native_tokenizers(monkeypatch)
    assert ref is not None and port is not None


@pytest.mark.parametrize("native", [True, False])
def test_tokenizer_ids_agree(monkeypatch, native):
    # each package's native library, then each package's pure-Python path
    if native:
        if shutil.which("g++") is None:
            pytest.skip("no C++ toolchain to build the tokenizer libraries")
        ref_lib, port_lib = native_tokenizers(monkeypatch)
        assert ref_lib is not None and port_lib is not None
    else:
        monkeypatch.setenv("CQST_DISABLE_NATIVE", "1")
        assert t_native.get_lib() is None
    port, ref = t_tok.HashTokenizer(), j_tok.HashTokenizer()
    for text in TOKENIZER_TEXTS:
        got, want = port.encode(text, 512), ref.encode(text, 512)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.mask, want.mask)


def test_port_native_tokenizer_matches_python():
    # the reference's equivalence cases (tests/test_native.py), through the
    # port's own library
    if t_native.get_lib() is None:
        pytest.skip("no C++ toolchain to build the port's tokenizer library")
    assert t_native._LIB.parent == PORT / "_build" / "native"
    tok = t_tok.HashTokenizer(vocab_size=32768)
    for text in ["validate the bearer token", "HnswIndex::search_filtered(query, k)",
                 "parseJSONFast HTTPServer camelCase snake_case",
                 "retried retrying retries validated", "x = foo.bar(1, 2); // comment",
                 "123 456abc _private __dunder__", "", "unicode: café naïve"]:
        python = np.asarray([tok._tok_id(w) for w in tok.tokenize_words(text)], np.int32)
        np.testing.assert_array_equal(t_native.tokenize_hash(text, 32768, 4096), python)


def _rows(store_cls, index_dir):
    store = store_cls.open(index_dir, readonly=True)
    try:
        rows = sorted((_plain(r) for r in store.iter_chunks()), key=lambda r: r["id"])
        hits = [cid for cid, _ in store.fts_search("validate token", limit=10)]
        return rows, hits, store.chunk_count()
    finally:
        store.close()


def test_store_opens_in_either_package(tmp_project):
    # named after this test's project: tmp_project.parent is shared by every
    # test that runs in one worker
    port_root = tmp_project.parent / f"{tmp_project.name}_port_copy"
    shutil.copytree(tmp_project, port_root)
    jctx = JContext.create(str(tmp_project))
    try:
        j_index(jctx.root, jctx.store, jctx.embedder, jctx._maybe_splade(), config=jctx.config)
    finally:
        jctx.close()
    assert main(["index", "--path", str(port_root), "--device", "cpu"]) == 0
    ref_dir, port_dir = tmp_project / ".cqs-tpu", port_root / ".cqs-tpu"
    # each store read through the other package's Store, and through its own
    ref_by_port, ref_by_ref = _rows(Store, ref_dir), _rows(JStore, ref_dir)
    port_by_ref, port_by_port = _rows(JStore, port_dir), _rows(Store, port_dir)
    assert ref_by_port == ref_by_ref and port_by_ref == port_by_port
    assert ref_by_port[2] > 10 and ref_by_port[1]
    # the two indexes of one project hold the same chunks (rowids aside)
    def content(rows):
        return [{k: v for k, v in r.items() if k != "rowid"} for r in rows[0]]
    assert content(ref_by_port) == content(port_by_ref)
