"""The port's whole ``search`` surface, its agent context, diff, registry and
eval commands against the JAX package's, through each package's CLI
``main`` on the CPU (the port with ``--device cpu``).

Two fixture projects are indexed once by the reference: the suite's
``tmp_project`` and a small second project of its own (a cache module:
a helper with four callers, one of them a test, two methods with one
body, a recursive and an async function).
Each package then runs its commands over its own copy of those indexes
(the on-disk format is shared), with the project registry under a
directory of the test's own (``XDG_DATA_HOME``). ``eval``, ``sweep`` and
``ablate`` read a v3 query file written from the fixture's functions: each
query is the first line of a function's docstring, its gold that function's
origin and name. ``review``, ``impact-diff``, ``ci`` and ``affected`` read a
unified diff of one line added to the cache module's four-caller helper.

Tolerances: ``--json`` envelopes equal, with floats (scores, signals,
similarities) within 1e-5 and the clock readings (``generated_at``,
``elapsed_ms``, eval's ``latency_ms``) and the port's ``device`` field left
out; text output equal line for line, with printed numbers within one unit
of their last printed digit (``--budget`` prints scores to three decimals);
saved reports (``sweep``, ``ablate``) equal; exit codes equal."""

import contextlib
import io
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

import conftest
from cqs_tpu.cli.context import CommandContext as JContext
from cqs_tpu.cli.main import build_parser as j_build_parser
from cqs_tpu.cli.main import main as jmain
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu_torch.cli.main import PORTED_COMMANDS, build_parser, search_stays_local
from cqs_tpu_torch.cli.main import main as tmain
from cqs_tpu_torch.search.router import classify_query
from cqs_tpu_torch.store import Store
from test_torch_slice import same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)
CLOCKS = {"generated_at", "elapsed_ms", "latency_ms", "device"}

CACHE_PY = '''"""A small least-recently-used cache."""


class LruCache:
    """Keeps the most recently used entries up to a capacity."""

    def __init__(self, capacity: int):
        """Create an empty cache holding at most capacity entries."""
        self.capacity = capacity
        self.entries = {}

    def get(self, key):
        """Return a cached value and mark it as recently used."""
        value = self.entries.pop(key)
        touch(self.entries, key, value)
        return value

    def put(self, key, value):
        """Insert a value, evicting the least recently used entry."""
        if len(self.entries) >= self.capacity:
            evict_oldest(self.entries)
        touch(self.entries, key, value)

    def refresh(self, key):
        """Mark an entry as recently used without reading it."""
        touch(self.entries, key, self.entries.pop(key))

    def drop_all(self):
        """Remove every entry and report how many there were."""
        count = len(self.entries)
        self.entries.clear()
        return count


class FifoCache:
    """Evicts entries in the order they were inserted."""

    def __init__(self):
        """Create an empty cache."""
        self.entries = {}

    def drop_all(self):
        """Remove every entry and report how many there were."""
        count = len(self.entries)
        self.entries.clear()
        return count


def touch(entries, key, value):
    """Store an entry as the most recently used one."""
    entries[key] = value


def evict_oldest(entries):
    """Drop the least recently used entry of a cache."""
    oldest = next(iter(entries))
    removed = entries.pop(oldest)
    return oldest, removed


def drop_oldest(entries):
    """Drop the least recently used entry of a cache."""
    oldest = next(iter(entries))
    removed = entries.pop(oldest)
    return oldest, removed


def fibonacci(n: int) -> int:
    """Compute a Fibonacci number by plain recursion."""
    if n < 2:
        return n
    return fibonacci(n - 1) + fibonacci(n - 2)


async def fetch_session(client, session_id):
    """Fetch a session record from the remote store."""
    return await client.get(f"/sessions/{session_id}")


def test_touch_marks_recent():
    entries = {}
    touch(entries, "a", 1)
    assert entries == {"a": 1}
'''


def one_line_diff(text: str, func: str, added: str) -> str:
    """A unified diff of ``src/cache.py`` that adds ``added`` after the
    docstring of the function ``func``."""
    lines = text.splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.startswith(f"def {func}("))
    return ("diff --git a/src/cache.py b/src/cache.py\n--- a/src/cache.py\n"
            f"+++ b/src/cache.py\n@@ -{i + 1},2 +{i + 1},3 @@\n"
            + "".join(f" {ln}\n" for ln in lines[i:i + 2]) + f"+    {added}\n")


def write_queries(index_dir: Path, out: Path) -> int:
    """A v3 query file: one query a documented function or method, the
    first line of its docstring, gold its origin and name."""
    store = Store.open(index_dir, readonly=True)
    try:
        rows = list(store.iter_chunks("chunk_type IN ('function','method') AND doc != ''"))
    finally:
        store.close()
    qs = []
    for r in sorted(rows, key=lambda r: (r.origin, r.line_start)):
        line = r.doc.strip().splitlines()[0].strip() if r.doc.strip() else ""
        if line:
            qs.append({"query": line, "category": classify_query(line).category.value,
                       "gold_chunk": {"origin": r.origin, "name": r.name}})
    out.write_text(json.dumps({"version": 3, "queries": qs}, indent=1))
    return len(qs)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The two projects indexed by the reference, one copy of each per
    package, the query file and the diff."""
    base = tmp_path_factory.mktemp("cmds")
    make = getattr(conftest.tmp_project, "__wrapped__", conftest.tmp_project)
    src_a, src_b = base / "src_a", base / "src_b"
    src_a.mkdir()
    make(src_a)
    (src_b / "src").mkdir(parents=True)
    (src_b / "src" / "cache.py").write_text(CACHE_PY)
    with pytest.MonkeyPatch.context() as mp:
        same_tokenizer_path.__wrapped__(mp)
        for root in (src_a, src_b):
            (root / ".cqs-tpu").mkdir()
            ctx = JContext.create(str(root))
            try:
                j_index(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                        config=ctx.config)
                _ = ctx.engine
            finally:
                ctx.close()
    assert write_queries(src_a / ".cqs-tpu", base / "queries.v3.json") == 7
    (base / "change.diff").write_text(one_line_diff(CACHE_PY, "touch", "audit(key)"))
    for pkg in ("ref", "port"):
        for name, src in (("a", src_a), ("b", src_b)):
            shutil.copytree(src, base / pkg / name)
    return base


def run(pkg: str, base: Path, root: Path, argv: list[str]) -> tuple[int, str]:
    """One command line through one package's CLI ``main``: its exit code and
    standard output. ``{a}``, ``{b}``, ``{queries}``, ``{diff}`` and
    ``{out}`` in the arguments name that package's files."""
    names = {"a": base / pkg / "a", "b": base / pkg / "b", "queries": base / "queries.v3.json",
             "diff": base / "change.diff", "out": root / f"{pkg}_out.json"}
    argv = [a.format(**names) for a in argv]
    argv += ["--path", str(root)] + (["--device", "cpu"] if pkg == "port" else [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = (tmain if pkg == "port" else jmain)(argv)
    return rc, out.getvalue().replace(str(base / pkg), "<tree>")


def assert_close(port, ref, where="results"):
    """Equal structures; floats within 1e-5; clock readings and the port's
    device field skipped."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), where
        assert set(port) - CLOCKS == set(ref) - CLOCKS, (where, set(port) ^ set(ref))
        for k in set(ref) - CLOCKS:
            assert_close(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), (where, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_close(a, b, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(port, (int, float)) and abs(port - ref) <= 1e-5, (where, port, ref)
    else:
        assert port == ref, (where, port, ref)


_NUMBER = re.compile(r"[-+]?\d+\.\d+")


def assert_same_text(port: str, ref: str) -> None:
    """Equal lines, numbers with a fraction within one unit of their last
    printed digit; the search header's clock reading and the port's device
    name left out."""
    def norm(text):
        return [re.sub(r" \(\d+ ms(, \w+)?\)$", "", ln) for ln in text.splitlines()]

    got, want = norm(port), norm(ref)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for x, y in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            unit = 10.0 ** -len(y.split(".")[1])
            assert abs(float(x) - float(y)) <= unit + 1e-9, (g, w)


#: (case, project, steps, compared): each step one command line; compared
#: is "json" (the last line's envelope), "text" (all of standard output) or
#: "saved" (the ``{out}`` report the last step writes, and its text)
CASES = [
    # host-only: the store, the call graph, the diff and the registry
    ("onboard", "a", [["onboard", "--json"]], "json"),
    ("related", "b", [["related", "evict_oldest", "--json"]], "json"),
    ("suggest", "b", [["suggest", "--json"]], "json"),
    ("kind", "a", [["kind", "SessionStore", "--json"]], "json"),
    ("health", "a", [["health", "--json"]], "json"),
    ("structural", "b", [["structural", "--json"]], "json"),
    ("review", "b", [["review", "--diff-file", "{diff}", "--json"]], "json"),
    ("impact-diff", "b", [["impact-diff", "--diff-file", "{diff}", "--json"]], "json"),
    ("ci-breach", "b", [["ci", "--diff-file", "{diff}", "--threshold", "Medium", "--json"]],
     "json"),
    ("ci-off", "b", [["ci", "--diff-file", "{diff}", "--threshold", "Off"]], "text"),
    ("affected", "b", [["affected", "--diff-file", "{diff}", "--json"]], "json"),
    ("deps", "a", [["deps", "Error", "--json"]], "json"),
    ("neighbors", "a", [["neighbors", "decode_jwt"]], "text"),
    ("drift", "a", [["drift", "--json"]], "json"),
    ("note", "a", [["note", "validate_token", "rotate the signing key", "--sentiment",
                    "warning"], ["notes", "--json"]], "json"),
    ("project", "a", [["project", "add", "a", "{a}"], ["project", "add", "b", "{b}"],
                      ["project", "list"], ["project", "remove", "a"],
                      ["project", "remove", "a"], ["project", "list"]], "text"),
    ("ref", "a", [["ref", "add", "docs", "{b}"], ["ref", "list"], ["ref", "remove", "docs"],
                  ["ref", "list"]], "text"),
    ("search-name-only", "a", [["search", "session", "--name-only", "--json"]], "json"),
    ("search-expand-parent", "a",
     [["search", "create a new session", "--expand-parent", "--json"]], "json"),
    ("search-budget", "a", [["search", "validate token", "--budget", "60"]], "text"),
    ("gather-budget", "a", [["gather", "validate token", "--budget", "80"]], "text"),
    # search-based: each runs the device program (the plain scans here)
    ("search-rrf", "a", [["search", "validate token", "--rrf", "--json"]], "json"),
    ("search-pattern", "b", [["search", "compute a number", "--pattern", "recursion",
                              "--json"]], "json"),
    ("search-no-demote", "a", [["search", "backoff delay", "--no-demote", "--json"]], "json"),
    ("search-project", "a", [["project", "add", "a", "{a}"], ["project", "add", "b", "{b}"],
                             ["search", "session", "--project", "a", "--project", "b",
                              "--json"]], "json"),
    ("scout", "a", [["scout", "validate a token", "--json"]], "json"),
    ("task", "a", [["task", "add token refresh", "--json"]], "json"),
    ("where", "a", [["where", "a helper to refresh tokens", "--json"]], "json"),
    ("plan", "a", [["plan", "add token refresh", "--json"]], "json"),
    ("explain", "a", [["explain", "validate token", "validate_token", "--json"]], "json"),
    ("onboard-concept", "a", [["onboard", "validate a bearer token", "--json"]], "json"),
    ("eval", "a", [["eval", "{queries}", "--json"]], "json"),
    ("sweep", "a", [["sweep", "name_boost", "0", "0.2", "--pool", "{queries}", "--save",
                     "{out}"]], "saved"),
    ("ablate", "a", [["ablate", "{queries}", "--levers", "name_boost,sig_boost", "--save",
                      "{out}"]], "saved"),
]


@pytest.mark.parametrize("case,project,steps,compared", CASES, ids=[c[0] for c in CASES])
def test_command_matches_reference(trees, tmp_path, monkeypatch, case, project, steps,
                                   compared):
    outputs = {}
    for pkg in ("ref", "port"):
        # a fresh copy of the indexes (``note`` writes to the store) and a
        # registry of the test's own
        root = tmp_path / pkg
        shutil.copytree(trees / pkg / project, root)
        monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / f"{pkg}_xdg"))
        outputs[pkg] = [run(pkg, trees, root, argv) for argv in steps]
        if compared == "saved":
            outputs[pkg].append((0, (root / f"{pkg}_out.json").read_text()))
    ref, port = outputs["ref"], outputs["port"]
    assert [rc for rc, _ in port] == [rc for rc, _ in ref]
    if case == "ci-breach":
        assert ref[-1][0] == 3
    if compared == "json":
        for (_, p), (_, r) in zip(port[:-1], ref[:-1]):
            assert_same_text(p, r)
        got = json.loads(port[-1][1].splitlines()[-1])
        want = json.loads(ref[-1][1].splitlines()[-1])
        assert want["results"] or case == "structural", want
        if case == "search-expand-parent":
            assert want["parents"], want
        if case == "search-project":
            assert {h["project"] for h in want["results"]} == {"a", "b"}, want
        assert_close(got, want, case)
    elif compared == "saved":
        assert_close(json.loads(port[-1][1]), json.loads(ref[-1][1]), case)
        assert_same_text(port[0][1], ref[0][1])
    else:
        for (_, p), (_, r) in zip(port, ref):
            assert_same_text(p, r)


def _subparsers(parser):
    return next(a for a in parser._actions if a.dest == "command").choices


def _flags(sub) -> set:
    """Every argument of a subcommand: its option strings (or destination),
    destination, default, choices, count and action."""
    return {(tuple(sorted(a.option_strings)) or (a.dest,), a.dest, str(a.default),
             tuple(a.choices or ()), a.nargs, a.required, type(a).__name__)
            for a in sub._actions}


@pytest.mark.parametrize("command", sorted(PORTED_COMMANDS))
def test_parser_takes_the_reference_flags(command):
    # every ported command parses the reference's arguments, with the
    # reference's defaults and choices; the port adds --device alone
    want = _flags(_subparsers(j_build_parser())[command])
    got = _flags(_subparsers(build_parser())[command])
    assert {f[0] for f in got - want} == {("--device",)}
    assert want <= got


#: search command lines, and whether the daemon's request would lose a flag
FORWARDING = [
    ([], False), (["-k", "3", "--lang", "python", "--filter", "src/*"], False),
    (["--alpha", "0.5", "--rerank", "--body"], False),
    (["--worktree"], True), (["--project", "a"], True), (["--rrf"], True),
    (["--budget", "50"], True), (["--include-docs"], True), (["--type", "function"], True),
    (["--exclude-type", "class"], True), (["--name-only"], True), (["--threshold", "0"], True),
    (["--no-demote"], True), (["--pattern", "async"], True), (["--expand-parent"], True),
]


@pytest.mark.parametrize("flags,local", FORWARDING, ids=[" ".join(f) or "plain" for f, _ in FORWARDING])
def test_search_with_a_flag_the_daemon_drops_stays_local(flags, local):
    assert search_stays_local(build_parser().parse_args(["search", "x", *flags])) is local


def test_rrf_search_is_not_forwarded(trees, tmp_path, monkeypatch):
    # a live daemon answers plain searches; a --rrf search runs here
    import cqs_tpu_torch.daemon.client as client

    asked = []

    def daemon(index_dir, command, args):
        asked.append((command, args))
        return {"ok": True, "results": [], "elapsed_ms": 1.0}

    monkeypatch.setattr(client, "request", daemon)
    root = tmp_path / "a"
    shutil.copytree(trees / "port" / "a", root)
    rc, out = run("port", trees, root, ["search", "validate token", "--json"])
    assert rc == 0 and json.loads(out.splitlines()[-1])["_meta"]["daemon"] is True
    assert asked == [("search", {"query": "validate token", "limit": 10, "rerank": False,
                                 "body": False})]
    rc, out = run("port", trees, root, ["search", "validate token", "--rrf", "--json"])
    env = json.loads(out.splitlines()[-1])
    assert rc == 0 and len(asked) == 1 and "daemon" not in env["_meta"]
    assert env["_meta"]["strategy"].endswith("+rrf") and env["results"]
