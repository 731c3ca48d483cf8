"""What the index pipeline has to store for the repository generator's files,
worked out from the generator's manifest: every chunk (windows of long ones
included), its base NL, and the NL the enrichment pass leaves in the store.

A frozen copy, for the chunks the generator writes (Python functions and
Markdown sections) and at the program's defaults (no extra NL layers, 5
callers, 5 callees, callee cutoff 0.10, windows of ``max_seq_len - 8``
tokens with 0.2 overlap, 800 lines), of:

- the NL template (``cqs_tpu_torch/nl/__init__.py``: ``generate_nl``,
  ``generate_nl_enriched``, ``compute_callee_doc_freq``) over
  ``utils/text.py``'s ``tokenize_identifier`` and ``content_words``;
- the windowing of long chunks (``pipeline.py::apply_windowing``,
  ``models/embedder.py::Embedder.split_into_windows``), counting tokens with
  the reference's own tokenizer (``perfbench/reference/tokenizer.py``);
- the enrichment pass's rules (``pipeline.py::run_enrichment_pass``): a
  chunk with callers or callees gets the enriched NL of the store as it is
  after the call; one with neither keeps the NL it had (a new chunk: its
  base NL).
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass

from perfbench.reference import tokenizer as rtok

CHARS_PER_TOKEN = 4
MAX_CALLERS = 5
MAX_CALLEES = 5
CALLEE_DF_CUTOFF = 0.10
WINDOW_OVERLAP = 0.2
MAX_CHUNK_LINES = 800

HUMAN = {"function": "function", "test": "test function", "section": "documentation section",
         "window": "code window"}
LANGUAGE = {"function": "python", "section": "markdown"}

_CAMEL_1 = re.compile(r"([a-z0-9])([A-Z])")
_CAMEL_2 = re.compile(r"([A-Z]+)([A-Z][a-z])")
_SEP = re.compile(r"[_\-.:/\\]+")
_NON_WORD = re.compile(r"[^0-9A-Za-z ]+")
_NON_ASCII = re.compile(r"[^\x00-\x7f]+")
_WS = re.compile(r"\s+")
_STOPWORDS = frozenset(
    """a an and are as at be by for from has have in is it its of on or that the
    to was were will with this those these not no""".split())


def tokenize_identifier(ident: str) -> list[str]:
    ident = _NON_ASCII.sub(" ", ident)
    parts: list[str] = []
    for seg in _SEP.split(ident):
        if not seg:
            continue
        seg = _CAMEL_1.sub(r"\1 \2", _CAMEL_2.sub(r"\1 \2", seg))
        for w in seg.split():
            w = _NON_WORD.sub("", w)
            if w:
                parts.append(w.lower())
    return parts


def _fts_word(raw: str) -> str:
    cleaned = _NON_WORD.sub(" ", raw).strip()
    words = tokenize_identifier(raw)
    if cleaned and len(words) > 1:
        return " ".join(["".join(words)] + words)
    return " ".join(words)


def content_words(text: str) -> list[str]:
    norm = " ".join(f for f in map(_fts_word, _WS.split(text)) if f)
    return [w for w in norm.split() if w not in _STOPWORDS and len(w) > 1]


@dataclass(frozen=True)
class Chunk:
    origin: str
    name: str
    kind: str                 # function | test | section | window
    language: str
    line_start: int
    line_end: int
    body: str
    signature: str
    doc: str
    parent: str
    calls: tuple = ()

    @property
    def key(self) -> tuple:
        return (self.origin, self.name, self.line_start)


def token_count(text: str) -> int:
    return len(rtok.words(text)) + 2


def split_into_windows(text: str, max_seq_len: int) -> list[str]:
    max_len = max_seq_len - 8
    if token_count(text) <= max_len:
        return [text]
    lines = text.splitlines()
    counts = [max(1, token_count(ln)) for ln in lines]
    windows: list[str] = []
    cur: list[str] = []
    cur_tokens = 0
    step_back = int(max_len * WINDOW_OVERLAP)
    window_start = i = 0
    while i < len(lines):
        t = counts[i]
        if cur_tokens + t > max_len and cur:
            windows.append("\n".join(cur))
            back_tokens, j = 0, i - 1
            while j > window_start and back_tokens < step_back:
                back_tokens += counts[j]
                j -= 1
            i = max(window_start + 1, j + 1)
            window_start = i
            cur, cur_tokens = [], 0
            continue
        cur.append(lines[i])
        cur_tokens += t
        i += 1
    if cur:
        windows.append("\n".join(cur))
    return windows or [text]


def chunks_of(item, max_seq_len: int) -> list[Chunk]:
    """The rows a generated function or section becomes: itself, and its
    windows where it is too long for one."""
    kind = item.kind
    if kind == "function" and item.name.startswith("test_"):
        kind = "test"
    c = Chunk(item.origin, item.name, kind, LANGUAGE[item.kind], item.line_start, item.line_end,
              item.body, item.signature, item.doc, item.parent, tuple(item.calls))
    if (c.line_end - c.line_start) < MAX_CHUNK_LINES and token_count(c.body) <= max_seq_len - 8:
        return [c]
    windows = split_into_windows(c.body, max_seq_len)
    if len(windows) == 1:
        return [c]
    out, offset = [c], 0
    for wi, text in enumerate(windows):
        n = text.count("\n") + 1
        out.append(Chunk(c.origin, f"{c.name}#w{wi}", "window", c.language, c.line_start + offset,
                         min(c.line_start + offset + n - 1, c.line_end), text, c.signature,
                         c.doc if wi == 0 else "", c.parent))
        offset += max(1, n // 2)
    return out


def base_nl(c: Chunk, max_seq_len: int) -> str:
    budget = max_seq_len * CHARS_PER_TOKEN
    if not c.name and not c.doc and not c.signature:
        return c.origin or "(unnamed)"
    name_words = " ".join(tokenize_identifier(c.name)) or c.name
    head = f"{name_words} {HUMAN[c.kind]}"
    if c.parent:
        head += f" in {' '.join(tokenize_identifier(c.parent))}"
    if c.language and c.kind != "section":
        head += f" ({c.language})"
    parts = [head]
    if c.signature and c.signature != c.name:
        parts.append(c.signature)
    if c.doc:
        parts.append(c.doc.strip()[: budget // 2])
    if c.kind == "section":
        parts.append(c.body[: budget - sum(len(p) for p in parts)])
    else:
        own = set(tokenize_identifier(c.name))
        counts = Counter(w for w in content_words(c.body) if w not in own)
        kw = [w for w, _ in counts.most_common(16)]
        if kw:
            parts.append("keywords: " + " ".join(kw))
    return ". ".join(p.strip().rstrip(".") for p in parts if p.strip())[:budget]


def enriched_nl(base: str, callers: list[str], callees: list[str], df: dict,
                max_seq_len: int) -> str:
    extras = []
    words = [w for w in (" ".join(tokenize_identifier(c)) for c in callers[:MAX_CALLERS]) if w]
    if words:
        extras.append("Called by: " + ", ".join(words))
    kept = [c for c in callees if df.get(c, 0.0) < CALLEE_DF_CUTOFF]
    words = [w for w in (" ".join(tokenize_identifier(c)) for c in kept[:MAX_CALLEES]) if w]
    if words:
        extras.append("Calls: " + ", ".join(words))
    nl = base if not extras else f"{base}. {'. '.join(extras)}"
    return nl[: max_seq_len * CHARS_PER_TOKEN]


@dataclass
class Expected:
    chunk: Chunk
    nl_base: str
    nl: str
    #: the enrichment pass wrote ``nl`` in this call (the ``embedding``
    #: column was embedded anew)
    enriched_now: bool


class Repository:
    """The stored NL of a project that the index pipeline keeps, call by
    call: :meth:`index` takes the files present at a call, and returns every
    chunk with the NL that the store has to hold after it."""

    def __init__(self, max_seq_len: int):
        self.max_seq_len = max_seq_len
        self._chunks: dict[str, list[Chunk]] = {}
        self._base: dict[tuple, str] = {}
        self._nl: dict[tuple, str] = {}

    def index(self, files) -> dict[tuple, Expected]:
        present = {f.origin for f in files}
        for origin in [o for o in self._chunks if o not in present]:
            for c in self._chunks.pop(origin):
                self._base.pop(c.key, None)
                self._nl.pop(c.key, None)
        new = set()
        for f in files:
            if f.origin not in self._chunks:
                cs = [c for it in f.items for c in chunks_of(it, self.max_seq_len)]
                self._chunks[f.origin] = cs
                for c in cs:
                    self._base[c.key] = base_nl(c, self.max_seq_len)
                    new.add(c.key)
        chunks = [c for f in files for c in self._chunks[f.origin]]
        callees_of = {c.key: list(c.calls) for c in chunks if c.calls}
        by_name: dict[str, list[tuple]] = {}
        for c in chunks:
            by_name.setdefault(c.name, []).append(c.key)
        name_of = {c.key: c.name for c in chunks}
        callers_of: dict[tuple, list[str]] = {}
        for key, calls in callees_of.items():
            for callee in calls:
                for target in by_name.get(callee, []):
                    callers_of.setdefault(target, []).append(name_of[key])
        n = max(1, len(callees_of))
        df_count: Counter = Counter()
        for calls in callees_of.values():
            for name in set(calls):
                df_count[name] += 1
        df = {name: k / n for name, k in df_count.items()}
        out = {}
        for c in chunks:
            base = self._base[c.key]
            callers = sorted(set(callers_of.get(c.key, [])))[: MAX_CALLERS * 2]
            callees = list(dict.fromkeys(callees_of.get(c.key, [])))
            before = base if c.key in new else self._nl[c.key]
            if callers or callees:
                nl = enriched_nl(base, callers, callees, df, self.max_seq_len)
                now = c.key in new or nl != before
            else:
                nl, now = before, False
            self._nl[c.key] = nl
            out[c.key] = Expected(c, base, nl, now)
        return out
