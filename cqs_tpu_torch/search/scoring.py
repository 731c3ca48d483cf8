"""Host-side candidate scoring: boosts, demotions, dedup, provenance.

Reference analog: ``src/search/scoring/`` — ``score_candidate`` with name
boost (``name_match.rs:103``), note boost (``note_boost.rs``), type-hint
boost, test/vendored demotion, cosine threshold, RRF with the FTS5 leg
(``fusion.rs:72``), parent-window dedup + boost, and rank-signal provenance.

This stage runs on the hydrated candidate pool (a few hundred rows), so host
Python is the right altitude — the heavy lifting already happened on device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.parser.types import ChunkType
from cqs_tpu_torch.store.store import ChunkRow
from cqs_tpu_torch.utils.text import tokenize_identifier

_VENDOR_RE = re.compile(r"(^|/)(vendor|third_party|thirdparty|node_modules|external)/")
_TEST_PATH_RE = re.compile(r"(^|/)tests?(/|$)|_test\.|\.test\.|\.spec\.")
_DOC_ORIGIN_RE = re.compile(r"\.(md|markdown|rst|txt)$", re.I)
_DOC_INTENT_WORDS = frozenset({
    "doc", "docs", "documentation", "documented", "readme", "guide",
    "tutorial", "changelog", "plan", "plans", "spec", "design", "audit",
    "findings", "note", "notes"})


def doc_demotion_exempt(name: str | None, query_words: set[str]) -> bool:
    """Doc chunk anchored on an identifier the query names.

    A prose file's section whose heading IS a short identifier ("Store",
    "metadata", "language") behaves like symbol documentation — when the
    query names that symbol, the flat doc demotion buries the only chunk the
    corpus has for it (r3 triage: gold doc chunks at leg rank 0-4 pushed out
    of the final top-20). Long sentence-shaped headings (audit files quoting
    whole query-like phrases) keep the demotion: the exemption requires a
    single space-free identifier token whose every word appears in the query.
    """
    if not name or len(name) > 40 or " " in name:
        return False
    toks = set(tokenize_identifier(name))
    return bool(toks) and toks <= query_words


@dataclass
class Candidate:
    row: ChunkRow
    fused: float
    dense: float | None = None
    sparse: float | None = None
    boosts: dict[str, float] = field(default_factory=dict)   # provenance
    final: float = 0.0

    @property
    def signals(self) -> dict:
        out = {"fused": round(self.fused, 6)}
        if self.dense is not None and self.dense > -1e30:
            out["dense"] = round(self.dense, 6)
        if self.sparse is not None and self.sparse > -1e30:
            out["sparse"] = round(self.sparse, 6)
        out.update({k: (round(v, 6) if isinstance(v, (int, float)) else v)
                    for k, v in self.boosts.items()})
        return out


@dataclass
class ScoringContext:
    query: str
    type_hints: list[ChunkType] | None = None
    lang_hints: tuple[str, ...] = ()        # languages named in the query
    note_mentions: dict[str, int] = field(default_factory=dict)
    path_filter: str | None = None          # glob on origin
    lang_filter: str | None = None
    threshold: float | None = None
    lim: Limits = field(default_factory=lambda: default_limits)
    category: str = ""                      # router category (doc-demotion gate)
    code_only: bool = False                 # default search: non-code excluded
    include_types: frozenset | None = None  # explicit --type filter (values)

    _query_words: set[str] = field(default_factory=set)

    def __post_init__(self):
        self._query_words = set(tokenize_identifier(self.query))
        if not self._query_words:
            self._query_words = set(self.query.lower().split())
        self._is_test_query = bool({"test", "tests", "testing"} & self._query_words)
        # snapshot the per-candidate knobs once per query: Limits attribute
        # access resolves the env every time, and score_candidate runs ~500x
        # per search (measured ~6 ms/query of pure knob lookups)
        lim = self.lim
        self._score_threshold = lim.score_threshold
        self._name_boost = lim.name_boost
        self._sig_boost = lim.sig_boost
        # callable-seeking queries must not hand the name boost to the type
        # they mention as an argument ("functions taking a reference to
        # ChunkIdentity" vs the struct ChunkIdentity itself) — R@1 mining
        # found 43/598 pool near-misses with a name_boost-dominant imposter
        self._nb_callable_gate = lim.name_boost_callable_gate
        self._name_abbrev = lim.name_abbrev
        self._exact_name_boost = lim.exact_name_boost
        # identifier-shaped raw tokens, lowered, len>=4 (short names like
        # `run` would hand the boost to dozens of rows)
        from cqs_tpu_torch.search.router import _looks_like_identifier as _lli
        self._exact_name_tokens = frozenset(
            w.lower() for w in self.query.replace(",", " ").split()
            if len(w) >= 4 and _lli(w))
        # hint VALUES as strings: enum construction per candidate is ~1 us
        # x pool 500 on the hot path
        self._type_hint_values = (frozenset(t.value for t in self.type_hints)
                                  if self.type_hints else frozenset())
        self._sig_kind_gate = lim.sig_boost_kind_gate
        self._seeks_callable = bool(
            {"function", "functions", "method", "methods", "fn", "func"}
            & self._query_words)
        # Identifier-shaped raw query tokens (CamelCase / snake_case / pathy)
        # matched against candidate signatures: "functions that take a Vec of
        # NamedStore" — "NamedStore" in the signature is the structural signal
        # the dense leg blurs (ref: NameMatcher hybrid boost, name_match.rs:103,
        # extended to the signature text).
        from cqs_tpu_torch.search.router import _looks_like_identifier
        self._sig_ident_words = tuple(
            w for w in self.query.replace(",", " ").split()
            if _looks_like_identifier(w) and len(w) >= 3)
        self._type_boost = lim.type_boost
        self._lang_boost = lim.lang_hint_boost
        self._note_boost = lim.note_boost
        self._test_demotion = lim.test_demotion
        self._vendored_demotion = lim.vendored_demotion
        self._data_demotion = lim.data_demotion
        self._doc_demotion = lim.doc_demotion
        self._name_cover_max_ratio = lim.name_cover_max_ratio
        # queries that ASK about docs keep doc chunks un-demoted
        self._wants_docs = bool(_DOC_INTENT_WORDS & self._query_words)
        cats = {c.strip() for c in lim.doc_demotion_categories.split(",") if c.strip()}
        self._doc_demotion_on = bool(self._doc_demotion) and not self._wants_docs \
            and (not cats or self.category in cats)
        # explicit in-query path scoping ("struct definitions in src/impact"):
        # path-shaped tokens boost candidates whose origin contains them —
        # high-intent but soft (a hard filter would break when the user's
        # path guess is slightly off)
        import re as _re
        # negation demotion (negation category only): words EXCLUSIVE to the
        # post-negation clause are what the user excludes ("search by path
        # glob NOT by function name" -> {function, name}); candidates whose
        # NAME matches them are the thing being negated (r4 dev triage 11:
        # top-1 search_by_name is exactly the negated concept)
        self._neg_words: frozenset = frozenset()
        self._negation_demotion = lim.negation_demotion
        if self.category == "negation" and self._negation_demotion > 0:
            from cqs_tpu_torch.search.router import NEGATION_TOKENS

            qwords = self.query.lower().split()
            hit = next((i for i, w in enumerate(qwords)
                        if w in NEGATION_TOKENS), None)
            if hit is not None:
                pre = set(tokenize_identifier(" ".join(qwords[:hit])))
                post = set(tokenize_identifier(" ".join(qwords[hit + 1:])))
                self._neg_words = frozenset(post - pre)
        self._path_boost = lim.path_affinity_boost
        self._query_paths = tuple(
            p.rstrip("/.") for p in _re.findall(r"[\w.-]+/[\w./-]+", self.query)
        ) if "/" in self.query else ()

    def path_matches(self, origin: str) -> bool:
        if not self.path_filter:
            return True
        from fnmatch import fnmatch
        pat = self.path_filter
        return fnmatch(origin, pat) or fnmatch(origin, f"*{pat}*") or pat in origin


import functools


@functools.lru_cache(maxsize=65536)
def _origin_flags(origin: str) -> tuple[bool, bool, bool]:
    """(test_path, vendored, doc) origin classification. Origins repeat
    across every query's ~500-row pool; caching keeps three regex scans per
    candidate off the warm serving path."""
    return (bool(_TEST_PATH_RE.search(origin)),
            bool(_VENDOR_RE.search(origin)),
            bool(_DOC_ORIGIN_RE.search(origin)))


#: Identifier-abbreviation table: code names abbreviate what queries spell
#: out ("statistics about the cache" must name-match `stats`). Curated from
#: the r4 dev triage (miss 35: gold at FTS rank 1, name boost never fired)
#: + the ubiquitous C-family abbreviation conventions. The expansion joins
#: the NAME side only: a name token `stats` also answers to `statistics`,
#: while a query saying `stats` already matches the name token directly.
_NAME_ABBREV: dict[str, tuple[str, ...]] = {
    "stats": ("statistics", "statistic"), "config": ("configuration",),
    "auth": ("authentication", "authorization"), "init": ("initialize", "initialization"),
    "impl": ("implementation",), "util": ("utility", "utilities"),
    "utils": ("utility", "utilities"), "func": ("function",),
    "fn": ("function",), "arg": ("argument",), "args": ("arguments",),
    "param": ("parameter",), "params": ("parameters",),
    "doc": ("documentation", "document"), "docs": ("documentation", "documents"),
    "dir": ("directory",), "cmd": ("command",), "env": ("environment",),
    "spec": ("specification",), "ctx": ("context",), "idx": ("index",),
    "buf": ("buffer",), "len": ("length",), "num": ("number",),
    "str": ("string",), "msg": ("message",), "req": ("request",),
    "resp": ("response",), "res": ("result",), "db": ("database",),
    "repo": ("repository",), "pkg": ("package",), "gen": ("generate",),
    "calc": ("calculate",), "val": ("value",), "var": ("variable",),
    "def": ("definition", "define"), "desc": ("description",),
    "info": ("information",), "max": ("maximum",), "min": ("minimum",),
    "temp": ("temporary",), "tmp": ("temporary",), "sync": ("synchronize",),
    "async": ("asynchronous",), "ref": ("reference",), "refs": ("references",),
    "deps": ("dependencies",), "dep": ("dependency",), "addr": ("address",),
    "err": ("error",), "prev": ("previous",), "cur": ("current",),
    "src": ("source",), "dst": ("destination",), "dest": ("destination",),
}


@functools.lru_cache(maxsize=1)
def reverse_abbrev() -> dict[str, tuple[str, ...]]:
    """spelled-out form -> identifier abbreviations ('statistics' ->
    ('stats',)), inverted from _NAME_ABBREV for the QUERY-side FTS rescue
    (fts_abbrev knob): queries spell out what code abbreviates."""
    rev: dict[str, list[str]] = {}
    for abbr, fulls in _NAME_ABBREV.items():
        for f in fulls:
            rev.setdefault(f, []).append(abbr)
    return {k: tuple(v) for k, v in rev.items()}


@functools.lru_cache(maxsize=65536)
def _name_words(name: str) -> frozenset:
    """Tokenized chunk names repeat across queries (pool ~500 every search);
    caching keeps host scoring off the regex path."""
    return frozenset(tokenize_identifier(name))


@functools.lru_cache(maxsize=65536)
def _name_words_expanded(name: str) -> frozenset:
    """Name tokens plus their spelled-out abbreviation expansions
    (name_abbrev knob): `get_stats` answers to `statistics`."""
    words = set(tokenize_identifier(name))
    for w in list(words):
        words.update(_NAME_ABBREV.get(w, ()))
    return frozenset(words)


#: Type-declaration kinds a callable-seeking query is NOT asking for
#: (impl stays un-gated: impl blocks hold the methods being sought).
_TYPE_DECL_KINDS = frozenset(
    ("struct", "enum", "class", "trait", "type_alias"))


def name_match_boost(query_words: set[str], row: ChunkRow, amount: float,
                     cover_max_ratio: float = 0.0,
                     abbrev: bool | None = None) -> float:
    """Hybrid name matcher: full boost when the chunk name covers all query
    words (or vice versa), partial boost per overlapping word.

    ``cover_max_ratio`` (off at 0) caps the full-coverage rule: a 30-word
    doc-section header that happens to contain every query word is a quote,
    not a name match (r3 triage: `docs/audit-*.md` headers quoting eval
    queries verbatim outrank the code gold at rank 1) — names longer than
    ratio x the query fall back to the partial-overlap boost."""
    if abbrev is None:       # callers on the per-candidate hot path pass the
        abbrev = default_limits.name_abbrev   # snapshot (a knob resolve each
    name_words = (_name_words_expanded(row.name)   # costs ~7 us x pool 500)
                  if abbrev else _name_words(row.name))
    if not name_words or not query_words:
        return 0.0
    overlap = len(query_words & name_words)
    if overlap == 0:
        return 0.0
    if query_words <= name_words or name_words <= query_words:
        # the cover cap measures the RAW name length: abbreviation
        # expansions only add matches, they must not deny the full boost
        if (cover_max_ratio <= 0
                or len(_name_words(row.name)) <= cover_max_ratio * len(query_words)):
            return amount
    # expansions can only ADD matches; the denominator stays the RAW name
    # length so expanded names aren't penalized for their breadth
    return amount * overlap / max(len(query_words), len(_name_words(row.name)))


def score_candidate(cand: Candidate, ctx: ScoringContext) -> bool:
    """Apply boosts/demotions in place; returns False when the candidate is
    filtered out entirely."""
    row = cand.row
    if not ctx.path_matches(row.origin):
        return False
    if ctx.lang_filter and row.language != ctx.lang_filter:
        return False
    threshold = ctx.threshold if ctx.threshold is not None else ctx._score_threshold
    if cand.dense is not None and cand.dense > -1e30 and cand.dense < threshold:
        return False

    score = cand.fused
    # Exact whole-name match: an identifier-shaped query token that IS the
    # candidate's name ("fn reindex_files" -> reindex_files). The word-cover
    # name boost can't separate the definition from its derived names
    # (test_reindex_files_hits_global covers the same words) — r5 R@1
    # mining: 39/608 near-misses had a test head over an exact-name gold.
    if ctx._exact_name_boost and ctx._exact_name_tokens:
        if row.name.lower() in ctx._exact_name_tokens:
            cand.boosts["exact_name"] = ctx._exact_name_boost
            score += ctx._exact_name_boost
    nb = name_match_boost(ctx._query_words, row, ctx._name_boost,
                          ctx._name_cover_max_ratio, ctx._name_abbrev)
    if (nb and ctx._nb_callable_gate < 1.0 and ctx._seeks_callable
            and row.chunk_type in _TYPE_DECL_KINDS):
        nb *= ctx._nb_callable_gate
    if nb:
        cand.boosts["name_boost"] = nb
        score += nb
    if ctx._sig_ident_words:
        sig_text = f"{row.signature or ''} {row.qualified_name}"
        hits = sum(1 for w in ctx._sig_ident_words if w in sig_text)
        if hits:
            sb = ctx._sig_boost * hits / len(ctx._sig_ident_words)
            # kind-hinted queries ("structs that ... CallerInfo") must not let
            # wrong-kind candidates (methods with CallerInfo in their
            # signature) ride the sig boost past the hinted-kind gold
            if (ctx.type_hints and ctx._sig_kind_gate < 1.0
                    and row.chunk_type not in ctx._type_hint_values):
                sb *= ctx._sig_kind_gate
            cand.boosts["sig_boost"] = sb
            score += sb
    if ctx.type_hints and row.chunk_type in ctx._type_hint_values:
        cand.boosts["type_boost"] = ctx._type_boost
        score += ctx._type_boost
    if ctx.lang_hints and ctx._lang_boost and row.language in ctx.lang_hints:
        cand.boosts["lang_boost"] = ctx._lang_boost
        score += ctx._lang_boost
    if ctx._query_paths and ctx._path_boost:
        if any(p in row.origin for p in ctx._query_paths):
            cand.boosts["path_boost"] = ctx._path_boost
            score += ctx._path_boost
    if ctx._neg_words:
        nw = _name_words(row.name)
        if nw & ctx._neg_words:
            cand.boosts["negation_demotion"] = -ctx._negation_demotion
            score -= ctx._negation_demotion
    if ctx.note_mentions:      # common case: no notes — skip the set build
        mention_keys = {row.name, row.qualified_name, row.origin}
        mentions = 0
        for target, count in ctx.note_mentions.items():
            if target in mention_keys or target in row.name or row.name in target:
                mentions += count
        if mentions:
            nb2 = min(ctx._note_boost * mentions, 2 * ctx._note_boost)
            cand.boosts["note_boost"] = nb2
            score += nb2
    o_test, o_vendor, o_doc = _origin_flags(row.origin)
    if (row.is_test or o_test) and not ctx._is_test_query:
        wants_tests = ctx.type_hints and ChunkType.TEST in ctx.type_hints
        if not wants_tests:
            cand.boosts["test_demotion"] = -ctx._test_demotion
            score -= ctx._test_demotion
    if o_vendor:
        cand.boosts["vendored_demotion"] = -ctx._vendored_demotion
        score -= ctx._vendored_demotion
    # Whole-file config/data chunks (giant machine-generated JSON etc.) match
    # many lexical queries by sheer token mass; demote them unless the query
    # explicitly asked for configs (CONFIG type hint).
    if (row.chunk_type == ChunkType.CONFIG.value
            and not (ctx.type_hints and ChunkType.CONFIG in ctx.type_hints)):
        cand.boosts["data_demotion"] = -ctx._data_demotion
        score -= ctx._data_demotion
    # Code-seeking queries: prose files (audit logs, plans, specs) lexically
    # shadow the implementation — the corpus's own docs quote query-shaped
    # phrases verbatim. Demote unless the query asks about docs.
    if (ctx._doc_demotion_on and o_doc
            and not doc_demotion_exempt(row.name, ctx._query_words)):
        cand.boosts["doc_demotion"] = -ctx._doc_demotion
        score -= ctx._doc_demotion
    cand.final = score
    return True


def dedup_windows(cands: list[Candidate], lim: Limits | None = None,
                  hydrate_parent=None, hydrate_parents=None) -> list[Candidate]:
    """Parent-window dedup: multiple windows of one parent collapse to one
    entry, boosted slightly per extra matching window; when a hydrator is
    provided the surviving window is SWAPPED for its parent row so users see
    the real chunk, not a '#w3' slice (ref: parent dedup + boost at scoring).

    Callers must re-sort afterwards — boosts mutate ``final``.
    """
    lim = lim or default_limits
    # Group by the LOGICAL chunk: a window's parent id, or the row's own id.
    # Keying only windows by parent_id let a hydrated window and the parent
    # chunk's own candidate coexist as duplicates, burning top-k slots
    # (measured -3 hits@5 on the reference-corpus eval; 41% of its chunks
    # are windows).
    # Batch parent hydration when a list hydrator is given: per-window
    # ``get_chunk`` round trips were ~50 SQL point queries per search.
    parent_rows: dict[str, object] = {}
    if hydrate_parents is not None:
        want, seen_gid = [], set()
        for c in cands:
            pid = c.row.parent_id
            gid = pid or c.row.id
            if pid and gid not in seen_gid:
                want.append(pid)
            seen_gid.add(gid)
        parent_rows = hydrate_parents(want)
        hydrate_parent = parent_rows.get
    by_gid: dict[str, Candidate] = {}
    out: list[Candidate] = []
    for c in cands:
        pid = c.row.parent_id
        gid = pid or c.row.id
        prev = by_gid.get(gid)
        if prev is None:
            if pid and hydrate_parent is not None:
                parent_row = hydrate_parent(pid)
                if parent_row is not None:
                    c = Candidate(row=parent_row, fused=c.fused, dense=c.dense,
                                  sparse=c.sparse, boosts=dict(c.boosts), final=c.final)
                    c.boosts["from_window"] = 1
            by_gid[gid] = c
            out.append(c)
        else:
            # Cap the stacked boost: an oversized chunk can have dozens of
            # windows in the pool, and an uncapped sum (0.02 x 29 windows)
            # out-scores genuinely better-matching chunks.
            if prev.boosts.get("parent_boost", 0.0) < 3 * lim.parent_boost:
                prev.boosts["parent_boost"] = prev.boosts.get("parent_boost", 0.0) + lim.parent_boost
                prev.final += lim.parent_boost
    return out


def impl_twin_demote(cands: list["Candidate"], amount: float) -> None:
    """Demote an ``impl`` container when a same-named TYPE DECLARATION
    (struct/enum/trait/class) is also a candidate: `struct OnboardArgs` is
    the definition the query names; its impl block is the aggregate riding
    the same tokens. r5 R@1 mining: 30/608 near-misses were an impl head
    over its own same-named decl gold at gap <=0.003. In-place; caller
    re-sorts."""
    if not amount:
        return
    decl_names = {c.row.name for c in cands
                  if c.row.chunk_type in _TYPE_DECL_KINDS}
    if not decl_names:
        return
    for c in cands:
        if c.row.chunk_type == "impl" and c.row.name in decl_names:
            c.boosts["impl_twin_demotion"] = -amount
            c.final -= amount


def dedup_exact_duplicates(cands: list[Candidate],
                           digest_of=None) -> list[Candidate]:
    """Cross-file exact-duplicate collapse: the same section/chunk content
    replicated across files (e.g. versioned audit docs repeating identical
    findings) burns one top-k slot per copy. Key = (name sans window,
    whitespace-normalized body digest); ``digest_of(chunk_id)`` supplies the
    digest from the engine's per-corpus cache (hashing ~500 hydrated bodies
    per query cost a measured 31 ms — and the raw id hash is too strict:
    whitespace-differing copies survive, −1.8pp dev R@5). Falls back to the
    content hash embedded in the id when no cache is given. The best-scoring
    copy survives. Run on a sorted list.
    """
    seen: set[tuple[str, str]] = set()
    out: list[Candidate] = []
    for c in cands:
        cid = c.row.id
        d = digest_of(cid) if digest_of is not None else None
        key = (c.row.name.split("#w")[0], d or cid.rsplit(":", 1)[-1])
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def collapse_same_name(cands: list[Candidate]) -> list[Candidate]:
    """Same-symbol collapse: candidates sharing (origin, base name) merge
    into the best-ranked row (ref corpus: 504 duplicate (origin, name) groups
    — e.g. four ``impl Language`` blocks in one file, r3 triage: three of them
    filled the top-5 while the queried ``fmt`` method sat just below the
    cutoff). Keep-first preserves every gold's rank or improves it — the
    surviving row is the group's best — so this is monotone-safe for recall;
    the dropped siblings' start lines are recorded on the survivor
    (``same_name_lines``) so no location information is lost, one slot is
    just no longer spent per duplicate. Run on a sorted list.
    """
    seen: dict[tuple[str, str], Candidate] = {}
    out: list[Candidate] = []
    for c in cands:
        key = (c.row.origin, c.row.name.split("#w")[0])
        prev = seen.get(key)
        if prev is not None:
            lines = prev.boosts.setdefault("same_name_lines", [])
            if c.row.line_start not in lines and len(lines) < 8:
                lines.append(c.row.line_start)
            continue
        seen[key] = c
        out.append(c)
    return out


def collapse_canonical_twins(cands: list[Candidate], canon_of) -> list[Candidate]:
    """Cross-origin quotation collapse: a doc-file chunk sharing a CODE
    chunk's (base name, whitespace-normalized signature) is that code QUOTED
    in prose — a markdown fence twin. Exact-hash matching alone misses most
    of them: the reference corpus's audit-fix docs quote *draft variants*
    whose bodies drifted from src while the signatures stayed identical, and
    on signature-shaped queries those quotations filled 3 of the top 5 ahead
    of the src originals they quote. Signature-less chunks fall back to the
    canonical (content) hash. Within a twin group the doc rows fold into the
    best code row: if a quotation ranks higher, the code twin takes its slot
    AND score — the quotation's rank evidence transfers to the code it
    quotes. Code-only groups are untouched (two real copies in the codebase
    stay two results; same-signature code twins are real overload/impl
    duplicates); doc-only groups keep one quotation. Dropped quotation
    origins are recorded on the survivor (``twin_origins``).
    Run on a sorted list; monotone-safe for every code gold."""
    slot_of: dict[tuple[str, str], int] = {}
    out: list[Candidate] = []
    for c in cands:
        sig = " ".join((c.row.signature or "").split())
        h = sig or canon_of(c.row.id)
        if not h:
            out.append(c)
            continue
        key = (h, c.row.name.split("#w")[0])
        i = slot_of.get(key)
        if i is None:
            slot_of[key] = len(out)
            out.append(c)
            continue
        prev = out[i]
        prev_doc = _origin_flags(prev.row.origin)[2]
        cur_doc = _origin_flags(c.row.origin)[2]
        if prev_doc and not cur_doc:
            # the quotation outranked the code it quotes: promote the code
            # twin into the quotation's slot and score
            c.final = prev.final
            tw = c.boosts.setdefault("twin_origins", [])
            for o in prev.boosts.get("twin_origins", []) + [prev.row.origin]:
                if o not in tw and len(tw) < 8:
                    tw.append(o)
            out[i] = c
        elif cur_doc:
            tw = prev.boosts.setdefault("twin_origins", [])
            if c.row.origin not in tw and len(tw) < 8:
                tw.append(c.row.origin)
        else:
            out.append(c)      # two real code copies: both stay
    return out


def rrf_with_fts(cands: list[Candidate], fts_hits: list[tuple[str, float]],
                 lim: Limits | None = None,
                 extra_legs: list[tuple[list[tuple[str, float]], float]] | None = None) -> None:
    """Optional RRF pass blending the FTS5 leg(s) into the final ordering
    (ref: fusion.rs:72, k=60). Mutates ``final`` scores in place: candidates
    are re-scored by RRF of (current order, FTS order, *extra leg orders).
    ``extra_legs`` entries are (leg, weight) — e.g. the BM25-over-code body
    leg at a fractional weight."""
    lim = lim or default_limits
    legs = [(fts_hits, 1.0), *(extra_legs or [])]
    legs = [(leg, w) for leg, w in legs if leg and w > 0]
    if not legs:
        return
    k = lim.rrf_k
    leg_ranks = [({cid: r for r, (cid, _) in enumerate(leg)}, w) for leg, w in legs]
    current = sorted(cands, key=lambda c: (-c.final, c.row.id))
    for rank, c in enumerate(current):
        score = 1.0 / (k + 1 + rank)
        contrib = 0.0
        for ranks, w in leg_ranks:
            fr = ranks.get(c.row.id)
            if fr is not None:
                contrib += w / (k + 1 + fr)
        if contrib:
            score += contrib
            c.boosts["rrf_fts"] = round(contrib, 6)
        c.final = score


def rrf_tail_rescue(cands: list[Candidate], legs: list[tuple[list[tuple[str, float]], float]],
                    lim: Limits | None = None, pin: int = 5) -> list[Candidate]:
    """Head-pinned RRF: keep the top-``pin`` score-ordered candidates as-is
    (protecting R@1/R@5) and reorder the REST by RRF of (score order, leg
    orders). This is the candidate-generation rescue for categories where
    full-RRF reordering measurably hurts the head (r3 dev split: structural
    full-RRF cost -1.8pp R@5): a gold at FTS-name rank 1 that the fused score
    buried at 300 surfaces into the top-20 without touching the top-5.

    ``cands`` must be sorted by final desc; returns the new ordering with
    tail finals rewritten monotonically below the head.
    """
    lim = lim or default_limits
    legs = [(leg, w) for leg, w in legs if leg and w > 0]
    if not legs or len(cands) <= pin:
        return cands
    head, tail = cands[:pin], cands[pin:]
    k = lim.rrf_k
    leg_ranks = [({cid: r for r, (cid, _) in enumerate(leg)}, w) for leg, w in legs]
    scored = []
    for rank, c in enumerate(tail):
        s = 1.0 / (k + 1 + pin + rank)
        contrib = sum(w / (k + 1 + fr) for ranks, w in leg_ranks
                      if (fr := ranks.get(c.row.id)) is not None)
        if contrib:
            c.boosts["rrf_rescue"] = round(contrib, 6)
        scored.append((s + contrib, c))
    scored.sort(key=lambda t: (-t[0], t[1].row.id))
    floor = min((c.final for c in head), default=0.0)
    for i, (_, c) in enumerate(scored):
        c.final = floor - 1e-6 * (i + 1)
    return head + [c for _, c in scored]


def mmr_diversify(cands: list[Candidate], lam: float | None = None,
                  limit: int | None = None) -> list[Candidate]:
    """Surface-feature MMR (ref: src/search/mmr.rs — same-file 0.4, same-name
    0.2, same-dir 0.15; default lambda 1.0 = OFF, measured regression below 1)."""
    lam = lam if lam is not None else default_limits.mmr_lambda
    if lam >= 1.0 or len(cands) <= 2:
        return cands
    picked: list[Candidate] = []
    remaining = list(cands)
    limit = limit or len(cands)
    while remaining and len(picked) < limit:
        best, best_score = None, -1e30
        for c in remaining:
            sim = 0.0
            for p in picked:
                s = 0.0
                if c.row.origin == p.row.origin:
                    s += 0.4
                if c.row.name == p.row.name:
                    s += 0.2
                cd = c.row.origin.rsplit("/", 1)[0]
                pd = p.row.origin.rsplit("/", 1)[0]
                if cd == pd:
                    s += 0.15
                sim = max(sim, s)
            mmr = lam * c.final - (1 - lam) * sim
            if mmr > best_score:
                best, best_score = c, mmr
        picked.append(best)
        remaining.remove(best)
    return picked
