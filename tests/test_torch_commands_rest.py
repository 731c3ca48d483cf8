"""The CLI's last commands against the JAX package's, through each package's
CLI ``main`` on the CPU (the port with ``--device cpu``): project set-up,
slots, the embedding cache, the models list, ``gc``, the file and chunk
readers (``brief``, ``context``, ``blame``, ``reconstruct``, ``stale``,
``diff``), the audits, ``telemetry``, ``doctor``, ``chat``, ``completions``,
``convert``, the git hook, and the LLM commands (``summaries``,
``improve-docs``, ``label-queries``) against one deterministic
OpenAI-compatible stub on 127.0.0.1 (``cqs_tpu_torch/llm/stub.py``) that both
packages talk to.

The projects are ``tests/test_torch_commands.py``'s two, indexed once by the
reference; here project ``a`` is also a git repository of one commit with a
fixed author and fixed dates (``blame``), and holds project ``b``'s index as
a second slot ``b`` (``slot``, ``diff``). Each package runs over a copy of
its own.

Tolerances: as in ``tests/test_torch_commands.py``: ``--json`` envelopes
equal with floats within 1e-5 (clock readings and the port's device field
left out); text equal line for line with printed numbers within one unit of
their last printed digit, once each package's project path reads
``<root>``; files written (converted documents, the staged patch, the
labeled query set and pools, the summaries table) equal; exit codes equal.
Where the port names its own program (the hook's command, completions, the
chat banner, the "run ... index" hints) or reads ``torch.cuda`` (``doctor``'s
first two rows), the test states the difference and holds the rest equal.
"""

import contextlib
import io
import json
import os
import re
import shutil
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cqs_tpu.cli.main import main as jmain
from cqs_tpu_torch.cli.main import main as tmain
from cqs_tpu_torch.llm import stub
import test_chm
from test_torch_commands import assert_close, assert_same_text, trees  # noqa: F401
from test_torch_slice import same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)

GIT_ENV = {"GIT_AUTHOR_NAME": "Ada Example", "GIT_AUTHOR_EMAIL": "ada@example.com",
           "GIT_AUTHOR_DATE": "2024-01-02T03:04:05+00:00",
           "GIT_COMMITTER_NAME": "Ada Example", "GIT_COMMITTER_EMAIL": "ada@example.com",
           "GIT_COMMITTER_DATE": "2024-01-02T03:04:05+00:00"}
HTML = ("<html><head><style>p {}</style></head><body><h1>Search guide</h1>"
        "<p>Run <code>index</code> first, then <b>search</b>.</p>"
        "<ul><li>exact scan</li><li>sparse <a href='s.html'>terms</a></li></ul>"
        "<pre>cqs index\ncqs search</pre></body></html>")
#: the port's program where the reference names its own: (reference, port)
SELF_NAMES = (("python -m cqs_tpu ci", "python -m cqs_tpu_torch ci"),
              ("`cqs-tpu hook`", "`python -m cqs_tpu_torch hook`"),
              ("# cqs-tpu pre-push", "# cqs-tpu-torch pre-push"),
              ("`cqs-tpu index`", "`python -m cqs_tpu_torch index`"),
              ("cqs-tpu chat", "cqs-tpu-torch chat"),
              ("_cqs_tpu()", "_cqs_tpu_torch()"),
              ("complete -F _cqs_tpu cqs-tpu", "complete -F _cqs_tpu_torch cqs-tpu-torch"))


def by_design(ref: str) -> str:
    """The reference's text with the port's program named where the
    reference names its own."""
    for old, new in SELF_NAMES:
        ref = ref.replace(old, new)
    return ref


@pytest.fixture(scope="module")
def rest(trees):  # noqa: F811
    """``trees`` with project ``a`` committed to git and holding ``b``'s index
    as slot ``b``; the documents ``convert`` reads; a query list."""
    for pkg in ("ref", "port"):
        a = trees / pkg / "a"
        shutil.copytree(trees / pkg / "b" / ".cqs-tpu" / "slots" / "default",
                        a / ".cqs-tpu" / "slots" / "b")
        env = {**os.environ, **GIT_ENV}
        for cmd in (["git", "-c", "init.defaultBranch=main", "init", "-q"],
                    ["git", "add", "src"], ["git", "commit", "-q", "-m", "fixture"]):
            subprocess.run(cmd, cwd=a, env=env, check=True, capture_output=True)
    docs = trees / "docs"
    docs.mkdir()
    (docs / "guide.html").write_text(HTML)
    (docs / "plain.pdf").write_bytes(test_chm.TestPurePdf._pdf(
        b"BT /F1 12 Tf 72 720 Td (Hello exact-scan world) Tj ET"))
    (docs / "flate.pdf").write_bytes(test_chm.TestPurePdf._pdf(
        b"BT /F1 10 Tf [(count-) -20 (sketch) -20 ( candidates)] TJ ET", compress=True))
    (docs / "manual.chm").write_bytes(test_chm.build_chm(test_chm.TestChmContainer.FILES))
    (docs / "notes.txt").write_text("not a document kind convert takes\n")
    (trees / "queries.txt").write_text("validate a token\ncreate a new session\n"
                                       "backoff delay\nretry a request\n")
    return trees


@pytest.fixture(scope="module")
def llm():
    srv, url = stub.start()
    try:
        yield url
    finally:
        srv.shutdown()
        srv.server_close()


def run(pkg: str, base: Path, root: Path, argv: list[str], stdin: str | None = None):
    """One command line through one package's CLI ``main``: exit code and
    standard output with the project's path as ``<root>`` and the fixture
    directory's as ``<base>``. ``{docs}``, ``{queries}``, ``{out}`` and
    ``{pool}`` name the fixture's files and this package's outputs."""
    names = {"docs": base / "docs", "queries": base / "queries.txt",
             "out": root / "out.json", "pool": root / "pool.json"}
    argv = [a.format(**names) for a in argv]
    argv += ["--path", str(root)] + (["--device", "cpu"] if pkg == "port" else [])
    out = io.StringIO()
    old_stdin = sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(out):
            rc = (tmain if pkg == "port" else jmain)(argv)
    finally:
        sys.stdin = old_stdin
    text = out.getvalue().replace(str(root), "<root>").replace(str(base), "<base>")
    return rc, re.sub(r"(?m)^(indexed .*) in \d+\.\ds$", r"\1", text)


def run_both(base, tmp_path, project, steps, prepare=None, stdin=None):
    """Each package over a fresh copy of ``project``: [(rc, text)] per step,
    and the copy's root."""
    outs, roots = {}, {}
    for pkg in ("ref", "port"):
        root = roots[pkg] = tmp_path / pkg
        shutil.copytree(base / pkg / project, root, symlinks=True)
        if prepare:
            prepare(root)
        outs[pkg] = [run(pkg, base, root, argv, stdin) for argv in steps]
    assert [rc for rc, _ in outs["port"]] == [rc for rc, _ in outs["ref"]], outs
    return outs["ref"], outs["port"], roots


def drop_index(root: Path) -> None:
    shutil.rmtree(root / ".cqs-tpu")


def edit_auth(root: Path) -> None:
    with open(root / "src" / "auth.py", "a") as f:
        f.write("\n\ndef added_after_index():\n    return 1\n")


#: (case, project, steps, prepare, env): text compared line for line, and
#: the last line as an envelope where it is one
HOST_CASES = [
    ("init", "a", [["init"], ["slot", "list"], ["stale"]], drop_index, {}),
    ("slot", "a", [["slot", "list"], ["slot", "promote", "b"], ["slot", "list"],
                   ["slot", "delete", "default"], ["slot", "list"], ["slot", "promote"]],
     None, {}),
    ("model", "a", [["model"]], None, {}),
    ("brief", "a", [["brief", "src/auth.py"], ["brief", "no/such/file.py"],
                    ["brief", "src/auth.py", "--json"]], None, {}),
    ("cache", "a", [["cache", "stats", "--per-model"], ["cache", "prune", "30", "--json"],
                    ["cache", "prune"], ["cache", "compact", "--json"],
                    ["cache", "clear"], ["cache", "stats", "--json"]], None, {}),
    ("diff", "a", [["diff", "b"], ["diff", "b", "--json"]], None, {}),
    ("audit-extraction", "a", [["audit-extraction", "--save", "{out}"],
                               ["audit-extraction", "--calls"]], None, {}),
    ("audit-mode", "a", [["audit-mode"]], None, {"CQST_NAME_BOOST": "0.3"}),
    ("telemetry", "a", [["telemetry"], ["search", "validate token"],
                        ["search", "validate token", "--filter", "nothing/*"],
                        ["search", "validate token", "--filter", "nothing/*"],
                        ["telemetry"], ["telemetry", "--mine"]],
     None, {"CQST_TELEMETRY": "1"}),
    ("context", "a", [["context", "validate_token", "--lines", "3"], ["context", "nope_zz"]],
     None, {}),
    ("blame", "a", [["blame", "validate_token"], ["blame", "nope_zz"]], None, {}),
    ("blame-no-git", "b", [["blame", "touch"]], None, {}),
    ("reconstruct", "a", [["reconstruct", "src/auth.py"], ["reconstruct", "no/such.py"]],
     None, {}),
    ("stale", "a", [["stale"], ["stale", "--json"]], edit_auth, {}),
    ("stale-fresh", "b", [["stale"], ["stale", "--json"]], None, {}),
    ("gc", "a", [["gc"], ["search", "validate token", "--json"]], None, {}),
    ("hook", "a", [["hook"], ["hook", "--uninstall"], ["hook", "--uninstall"]], None, {}),
    ("hook-no-git", "b", [["hook"]], None, {}),
    ("completions", "a", [["completions"], ["completions", "zsh"]], None, {}),
    ("convert", "a", [["convert", "{docs}/guide.html", "{docs}/plain.pdf", "{docs}/flate.pdf",
                       "{docs}/manual.chm", "{docs}/notes.txt", "--out", "md"]], None, {}),
    ("convert-none", "a", [["convert", "{docs}/notes.txt"]], None, {}),
]


def assert_same_steps(port, ref, design=False):
    for (_, p), (_, r) in zip(port, ref):
        r = by_design(r) if design else r
        lines = r.splitlines()
        if lines and lines[-1].startswith("{"):
            assert_close(json.loads(p.splitlines()[-1]), json.loads(lines[-1]))
            p, r = "\n".join(p.splitlines()[:-1]), "\n".join(lines[:-1])
        assert_same_text(p, r)


@pytest.mark.parametrize("case,project,steps,prepare,env", HOST_CASES,
                         ids=[c[0] for c in HOST_CASES])
def test_host_command_matches_reference(rest, tmp_path, monkeypatch, case, project, steps,
                                        prepare, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port, roots = run_both(rest, tmp_path, project, steps, prepare)
    if case == "model":
        # the port's one family the reference lacks: its preset's line, and
        # every other line as the reference prints it
        extra = [ln for ln in port[0][1].splitlines() if ln.startswith("deepseek-v2-lite ")]
        assert len(extra) == 1 and " deepseek dim=2048 " in extra[0]
        port = [(port[0][0], "".join(f"{ln}\n" for ln in port[0][1].splitlines()
                                     if ln not in extra))]
    by_self_name = case in ("hook", "completions", "convert", "convert-none")
    assert_same_steps(port, ref, design=by_self_name)
    if by_self_name:                     # the port names itself where the reference does
        assert port[0][1] != ref[0][1] or case == "hook"
    if case == "init":
        assert ref[1][1] == "* default\n" and ref[0][0] == 0
    elif case == "slot":
        assert [rc for rc, _ in ref] == [0, 0, 0, 0, 0, 2] and ref[4][1] == "* b\n"
    elif case == "brief":
        assert ref[1][0] == 1 and json.loads(ref[2][1])["results"]["total"] >= 3
    elif case == "cache":
        assert ref[2][0] == 2 and json.loads(ref[5][1])["results"]["total_entries"] == 0
        assert "entries" in ref[0][1] and ref[0][1].count("\n") >= 2
    elif case == "diff":
        assert json.loads(ref[1][1])["results"]
    elif case == "audit-extraction":
        assert_close(json.loads((roots["port"] / "out.json").read_text()),
                     json.loads((roots["ref"] / "out.json").read_text()))
        assert "python" in ref[0][1] and "call edges" in ref[1][1]
    elif case == "audit-mode":
        assert "name_boost = 0.3 [env CQST_NAME_BOOST]" in ref[0][1]
    elif case == "telemetry":
        assert ref[0][1].startswith("(no telemetry") and ref[4][1].startswith("3 events")
        assert ref[5][1].splitlines()[1].startswith("   2  ")
    elif case == "blame":
        assert "Ada Example" in ref[0][1] and ref[1][0] == 1
    elif case == "stale":
        assert ref[0][1] == "src/auth.py\n(1 stale files)\n"
    elif case == "stale-fresh":
        assert ref[0][1] == "(index is fresh)\n"
    elif case == "gc":
        assert json.loads(ref[1][1])["results"]
        for pkg in ("ref", "port"):
            assert (roots[pkg] / ".cqs-tpu" / "slots" / "default" / "dense.npz").is_file()
    elif case == "hook":
        # installed and removed; the port's hook runs the port
        assert [t for _, t in ref[:2]] == ["installed pre-push CI gate at "
                                           "<root>/.git/hooks/pre-push\n", "hook removed\n"]
        assert not (roots["port"] / ".git" / "hooks" / "pre-push").exists()
    elif case == "hook-no-git":
        assert ref[0] == (1, "not a git repository\n")
    elif case == "completions":
        assert "complete -F _cqs_tpu_torch cqs-tpu-torch" in port[0][1]
        assert port[0][1] == port[1][1]
    elif case == "convert":
        assert ref[0][1].count(" -> ") == 4 and "skip <base>/docs/notes.txt" in ref[0][1]
        got = sorted(p.name for p in (roots["port"] / "md").iterdir())
        assert got == ["flate.md", "guide.md", "manual.md", "plain.md"]
        for name in got:
            assert ((roots["port"] / "md" / name).read_text()
                    == (roots["ref"] / "md" / name).read_text()), name
        assert "Hello exact-scan world" in (roots["port"] / "md" / "plain.md").read_text()
    elif case == "convert-none":
        assert ref[0][0] == 1


def test_hook_script_runs_the_port(rest, tmp_path):
    ref, port, roots = run_both(rest, tmp_path, "a", [["hook"]])
    got = (roots["port"] / ".git" / "hooks" / "pre-push").read_text()
    want = (roots["ref"] / ".git" / "hooks" / "pre-push").read_text()
    assert got == by_design(want) != want
    assert "exec python -m cqs_tpu_torch ci --base @{u} --threshold High\n" in got
    assert os.access(roots["port"] / ".git" / "hooks" / "pre-push", os.X_OK)


def test_doctor_matches_reference_but_its_device_rows(rest, tmp_path):
    ref, port, _ = run_both(rest, tmp_path, "a", [["doctor"]])
    got, want = port[0][1].splitlines(), ref[0][1].splitlines()
    assert [ln[:30] for ln in want[:2]] == ["[ok ] jax devices             ",
                                           "[FAIL] tpu available          "]
    cuda = torch.cuda.is_available()
    assert got[0] == "[ok ] torch device             cpu (host)"
    assert got[1].startswith(f"[{'ok ' if cuda else 'FAIL'}] cuda available ")
    assert got[2:] == want[2:] and len(want) == 8
    assert want[4] == "[ok ] artifact dense.npz       valid"
    # the reference fails off a TPU, the port off a CUDA host
    assert ref[0][0] == 1 and port[0][0] == (0 if cuda else 1)


def chat_answers(text: str) -> tuple[str, list]:
    """The banner and each answer of a chat session's output."""
    banner, _, rest = text.partition("\n")
    return banner, [json.loads(part) for part in rest.split("cqs> ") if part.strip()]


def test_chat_matches_reference(rest, tmp_path):
    session = ('search "validate token" -k 3 | callers\n\nstats\n'
               'callees validate_token\nquit\nstats\n')
    ref, port, _ = run_both(rest, tmp_path, "a", [["chat"]], stdin=session)
    (_, r), (_, p) = ref[0], port[0]
    rb, ra = chat_answers(r)
    pb, pa = chat_answers(p)
    assert pb == by_design(rb) != rb
    # the pipeline fans the search's three hits out to callers; a blank line
    # is skipped, and nothing after quit runs
    assert len(ra) == 3 and [c["input"] for c in ra[0]][0] == "validate_token"
    assert len(ra[0]) == 3 and ra[1]["chunks"] == 11
    assert {c["name"] for c in ra[2]} == {"decode_jwt", "check_expiry"}
    assert_close(pa, ra)


def llm_env(monkeypatch, url: str | None) -> None:
    """Point both packages at the stub (or at no provider at all); never at
    the Anthropic API."""
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    if url is None:
        monkeypatch.delenv("CQST_LLM_BASE_URL", raising=False)
    else:
        monkeypatch.setenv("CQST_LLM_BASE_URL", url)


def summaries_of(root: Path) -> list:
    db = sqlite3.connect(root / ".cqs-tpu" / "slots" / "default" / "index.db")
    try:
        return db.execute("SELECT * FROM llm_summaries ORDER BY 1").fetchall()
    finally:
        db.close()


def test_summaries_then_index_then_search(rest, tmp_path, monkeypatch, llm):
    llm_env(monkeypatch, llm)
    steps = [["summaries", "--max", "6"], ["index"],
             ["search", "create a new session", "--json"],
             ["search", "is summarized here", "--json"], ["summaries", "--max", "6", "--no-hyde"]]
    ref, port, roots = run_both(rest, tmp_path, "a", steps)
    assert [rc for rc, _ in ref] == [0] * 5
    assert port[0][1] == by_design(ref[0][1]) != ref[0][1]
    assert ref[0][1].startswith("enriched 6 chunks with openai-compat")
    got, want = summaries_of(roots["port"]), summaries_of(roots["ref"])
    assert len(want) == 8 and got == want
    for i in (2, 3):
        p, r = json.loads(port[i][1].splitlines()[-1]), json.loads(ref[i][1].splitlines()[-1])
        assert r["results"]
        assert [h["id"] for h in p["results"]] == [h["id"] for h in r["results"]]
        assert_close(p, r)


def test_llm_commands_without_a_provider(rest, tmp_path, monkeypatch):
    llm_env(monkeypatch, None)
    steps = [["summaries"], ["improve-docs"], ["label-queries", "{queries}"]]
    ref, port, _ = run_both(rest, tmp_path, "a", steps)
    assert [rc for rc, _ in ref] == [1, 1, 1]
    assert_same_steps(port, ref)


def test_improve_docs_patch_matches_reference(rest, tmp_path, monkeypatch, llm):
    llm_env(monkeypatch, llm)
    ref, port, roots = run_both(rest, tmp_path, "a", [["index"], ["improve-docs", "--out", "{out}"],
                                                      ["improve-docs", "--max", "0"]],
                                prepare=edit_auth)
    assert_same_steps(port, ref)
    got, want = (roots["port"] / "out.json").read_text(), (roots["ref"] / "out.json").read_text()
    assert got == want and "+++ b/src/auth.py" in want and ref[0][0] == 0


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "stub"])
def test_label_queries_matches_reference(rest, tmp_path, monkeypatch, llm, mock):
    llm_env(monkeypatch, llm)
    argv = ["label-queries", "{queries}", "--out", "{out}", "--pool-out", "{pool}", "-k", "5"]
    ref, port, roots = run_both(rest, tmp_path, "a", [argv + (["--mock"] if mock else [])])
    assert ref[0][0] == 0
    assert_same_steps(port, ref)
    for name in ("out.json", "pool.json"):
        got = json.loads((roots["port"] / name).read_text())
        want = json.loads((roots["ref"] / name).read_text())
        assert_close(got, want, name)
    labeled = json.loads((roots["ref"] / "out.json").read_text())
    # mock judges both say 0 (every query labeled); the stub's judge names the
    # candidate sharing the most words with the query, or NONE
    assert labeled["n"] == 4 if mock else 1 <= labeled["n"] <= 4


def test_stub_replies_are_deterministic():
    from cqs_tpu_torch.llm.summaries import HYDE_SYSTEM, SUMMARY_SYSTEM, summary_prompt

    prompt = summary_prompt("LruCache.get", "python", "def get(self, key)", "def get(...)")
    assert stub.reply(SUMMARY_SYSTEM, prompt).startswith("LruCache.get is summarized")
    assert stub.reply(HYDE_SYSTEM, prompt).count(" | ") == 2
    judge = ("You are labeling a code-search eval. Query:\n\nevict the oldest entry\n\n"
             "Candidates (code chunks from the repository):\n[0] src/a.py:1 touch — def t()\n"
             "[1] src/a.py:9 evict_oldest — def e()\n\nWhich single candidate ...")
    assert stub.reply("", judge) == "1"
    assert stub.reply("", judge.replace("evict_oldest", "drop_all")) == "NONE"
