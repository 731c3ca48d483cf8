"""The enrichment pass builds each row's enriched NL from the stored base NL
(``nl_base``) while the store's ``nl_base_key`` says every row's was written
under the inputs the pass uses now. Whatever the store's history, each row's
enriched NL is the string the pass built before it reused the base:
``generate_nl_enriched`` over a chunk built from the row's own fields."""

from __future__ import annotations

import pytest
import torch

from cqs_tpu_torch import pipeline
from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.models import Embedder
from cqs_tpu_torch.nl import CallContext, compute_callee_doc_freq, generate_nl_enriched
from cqs_tpu_torch.parser import Chunk, ChunkType
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.utils.hashing import content_hash
from cqs_tpu_torch.utils.trace import recording

CPU = torch.device("cpu")


def _long_function(n: int) -> str:
    """A Python function long enough to be windowed (by tokens) at either
    hash preset's sequence length, calling the fixture's functions."""
    lines = [f"def replay_ledger_{n}(entries):", '    """Replay every ledger entry."""']
    for i in range(120):
        lines.append(f"    total_{i} = decode_jwt(entries[{i}]) + check_expiry(entries[{i}]) "
                     f"+ validate_token(entries[{i}])")
    lines.append("    return total_0")
    return "\n".join(lines) + "\n"


def _project(root) -> None:
    (root / "src" / "ledger.py").write_text(
        '"""Ledger replay."""\n\n' + _long_function(0) + "\n\n"
        "def settle_account(account):\n"
        '    """Settle an account against the ledger. ' + "Each entry is replayed in order. " * 24
        + '"""\n'
        "    return replay_ledger_0(account.entries) + validate_token(account.token)\n")
    (root / "docs").mkdir()
    (root / "docs" / "guide.md").write_text(
        "# Guide\n\nHow sessions are created and revoked.\n\n"
        "## Tokens\n\n" + "Tokens are validated against the signing key. " * 40 + "\n\n"
        "## Ledger\n\nThe ledger is replayed on every settlement.\n")


def _pull(root, k: int) -> None:
    """A later pull: one file edited, one file added."""
    (root / "src" / "ledger.py").write_text(
        (root / "src" / "ledger.py").read_text()
        + f"\n\ndef audit_{k}(account):\n    return settle_account(account) + decode_jwt(account)\n")
    (root / "src" / f"report_{k}.py").write_text(
        f"def report_{k}(session_store):\n"
        f'    """Report {k} on the open sessions."""\n'
        "    return session_store.create_session(validate_token('t'))\n")


def _todays_nl(store: Store, max_seq_len: int) -> list[tuple[str, str]]:
    """Each rebuilt row's id and enriched NL, in row order, as the pass built
    it before it reused the base: from a chunk of the row's own fields."""
    db = store.db
    callees_of: dict[str, list[str]] = {}
    for caller_id, callee in db.execute("SELECT caller_id, callee_name FROM function_calls"):
        callees_of.setdefault(caller_id, []).append(callee)
    name_of: dict[str, str] = {}
    ids_by_name: dict[str, list[str]] = {}
    for cid, name in db.execute("SELECT id, name FROM chunks"):
        name_of[cid] = name
        ids_by_name.setdefault(name, []).append(cid)
    callers_of: dict[str, list[str]] = {}
    for caller_id, callees in callees_of.items():
        for callee in callees:
            for target in ids_by_name.get(callee, []):
                callers_of.setdefault(target, []).append(name_of.get(caller_id, ""))
    df = compute_callee_doc_freq(list(callees_of.values()))
    summaries = store.get_summaries()
    lim = default_limits
    out = []
    for (cid, origin, name, parent_name, ctype, language, ls, le, sig, doc, body, ret,
         is_test) in db.execute(
            "SELECT id, origin, name, parent_name, chunk_type, language, line_start, line_end, "
            "signature, doc, body, return_type, is_test FROM chunks WHERE embedding IS NOT NULL"):
        ctx = CallContext(callers=sorted(set(callers_of.get(cid, [])))[: lim.nl_max_callers * 2],
                          callees=list(dict.fromkeys(callees_of.get(cid, []))))
        if not ctx.callers and not ctx.callees and cid not in summaries:
            continue
        chunk = Chunk(origin=origin, name=name, chunk_type=ChunkType(ctype), language=language,
                      line_start=ls, line_end=le, body=body, signature=sig, doc=doc,
                      parent_name=parent_name, return_type=ret, is_test=bool(is_test))
        summary, hyde = summaries.get(cid, (None, None))
        out.append((cid, generate_nl_enriched(chunk, ctx, callee_doc_freq=df, summary=summary,
                                              hyde=hyde, max_seq_len=max_seq_len, lim=lim)))
    return out


class _Index:
    """Indexes the project and records what the enrichment pass built."""

    def __init__(self, root, monkeypatch):
        self.root = root
        self.store = Store.open(root / ".cqs-tpu")
        self.built: list[str] = []
        self.counters: dict = {}
        inner = pipeline.generate_nl_enriched

        def record(*a, **k):
            nl = inner(*a, **k)
            self.built.append(nl)
            return nl
        monkeypatch.setattr(pipeline, "generate_nl_enriched", record)

    def __call__(self, model: str = "hash", force: bool = False) -> Embedder:
        embedder = Embedder(model, device=CPU)
        self.built.clear()
        with recording() as rec:
            pipeline.run_index_pipeline(self.root, self.store, embedder, force=force)
        self.counters = rec.summary()["counters"]
        return embedder

    def check(self, embedder: Embedder) -> None:
        """Every rebuilt row's NL is today's string, and stored under its hash."""
        want = _todays_nl(self.store, embedder.max_seq_len)
        assert len(want) > 0 and self.built == [nl for _, nl in want]
        stored = dict(self.store.db.execute("SELECT id, enrichment_hash FROM chunks"))
        assert all(stored[cid] == content_hash(nl) for cid, nl in want)
        assert self.counters["enrich.rebuilt"] == len(want)

    def key_holds(self, embedder: Embedder) -> bool:
        return self.store.get_meta(pipeline.NL_BASE_META) == pipeline.base_nl_key(embedder.max_seq_len)


def _fresh_with_summary(ix, monkeypatch):
    ix.check(e := ix())
    assert ix.key_holds(e)
    rows = ix.store.db.execute(
        "SELECT id, chunk_type FROM chunks ORDER BY rowid").fetchall()
    kinds = {t for _, t in rows}
    assert {ChunkType.WINDOW.value, ChunkType.SECTION.value, ChunkType.FUNCTION.value} <= kinds
    for cid, _ in rows[::3]:
        ix.store.put_summary(cid, "Replays and settles ledgers.", "how is a ledger replayed",
                             "stub")
    ix.check(ix())


def _later_pull(ix, monkeypatch):
    ix()
    for k in range(2):
        _pull(ix.root, k)
        ix.check(e := ix())
        assert ix.key_holds(e)


def _model_switch(ix, monkeypatch):
    ix()
    ix.check(e := ix("hash-tiny"))
    assert e.max_seq_len == 128 and not ix.key_holds(e)
    _pull(ix.root, 0)
    ix.check(ix("hash-tiny"))


def _extra_layers(ix, monkeypatch):
    ix()
    monkeypatch.setenv("CQST_NL_EXTRA_LAYERS", "filecontext,params,fields,methods,ctor")
    ix.check(e := ix())
    assert not ix.key_holds(e)
    _pull(ix.root, 0)
    ix.check(ix())


def _empty_base(ix, monkeypatch):
    """Rows with an empty nl_base, as in a store written before the key: some
    with the key holding (row-by-row fallback), then none (the whole pass)."""
    ix()
    with ix.store.write_txn() as db:
        db.execute("UPDATE chunks SET nl_base = '' WHERE rowid % 2 = 0")
    _pull(ix.root, 0)
    ix.check(e := ix())
    assert ix.key_holds(e) and 0 < ix.counters["enrich.base_reused"] < ix.counters["enrich.rebuilt"]
    with ix.store.write_txn() as db:
        db.execute("DELETE FROM metadata WHERE key = ?", (pipeline.NL_BASE_META,))
    _pull(ix.root, 1)
    ix.check(ix())
    assert ix.counters["enrich.base_reused"] == 0


def _force(ix, monkeypatch):
    ix()
    ix("hash-tiny")
    ix.check(e := ix("hash-tiny", force=True))
    assert ix.key_holds(e) and ix.counters["enrich.base_reused"] == ix.counters["enrich.rebuilt"]
    ix.check(ix("hash-tiny"))


@pytest.mark.parametrize("history", [_fresh_with_summary, _later_pull, _model_switch,
                                     _extra_layers, _empty_base, _force],
                         ids=lambda f: f.__name__.strip("_"))
def test_enriched_nl_is_todays_string_whatever_the_store_history(tmp_project, monkeypatch,
                                                                  history):
    monkeypatch.delenv("CQST_NL_EXTRA_LAYERS", raising=False)
    _project(tmp_project)
    ix = _Index(tmp_project, monkeypatch)
    try:
        history(ix, monkeypatch)
    finally:
        ix.store.close()


@pytest.mark.parametrize("key_matches", [True, False], ids=["key", "no_key"])
def test_base_reused_counts_every_rebuilt_row_only_under_the_key(tmp_project, monkeypatch,
                                                                 key_matches):
    monkeypatch.delenv("CQST_NL_EXTRA_LAYERS", raising=False)
    _project(tmp_project)
    ix = _Index(tmp_project, monkeypatch)
    try:
        ix()
        if not key_matches:
            ix.store.set_meta(pipeline.NL_BASE_META, "seq=1;layers=;parser=0")
        _pull(tmp_project, 0)
        ix()
        c = ix.counters
        assert c["enrich.rebuilt"] > 0
        assert c["enrich.base_reused"] == (c["enrich.rebuilt"] if key_matches else 0)
    finally:
        ix.store.close()
