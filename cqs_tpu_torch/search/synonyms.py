"""Synonym expansion for the FTS leg.

Reference analog: ``src/search/synonyms.rs`` — builtin table + TOML overlay
(``[synonyms]`` in the project config); FTS queries expand each matched word
into an OR-group.
"""

from __future__ import annotations

BUILTIN: dict[str, list[str]] = {
    "auth": ["authentication", "authorization", "login"],
    "authentication": ["auth", "login"],
    "config": ["configuration", "settings", "options"],
    "configuration": ["config", "settings"],
    "db": ["database", "store", "storage"],
    "database": ["db", "store"],
    "error": ["exception", "failure", "fault"],
    "exception": ["error", "failure"],
    "init": ["initialize", "initialization", "setup"],
    "initialize": ["init", "setup"],
    "delete": ["remove", "drop", "destroy"],
    "remove": ["delete", "drop"],
    "fetch": ["get", "retrieve", "load"],
    "retrieve": ["fetch", "get", "load"],
    "create": ["new", "make", "build"],
    "update": ["modify", "change", "edit"],
    "test": ["spec", "check"],
    "dir": ["directory", "folder"],
    "directory": ["dir", "folder"],
    "util": ["utility", "helper"],
    "helper": ["util", "utility"],
    "param": ["parameter", "argument"],
    "parameter": ["param", "argument"],
    "msg": ["message"],
    "message": ["msg"],
    "func": ["function", "method"],
    "function": ["func", "method"],
    # code-retrieval domain terms (r2: rescue vocabulary-gap queries where
    # the query word never appears verbatim in code identifiers)
    "embedding": ["embed", "vector", "embedder"],
    "embed": ["embedding", "encode"],
    "vector": ["embedding", "vec"],
    "nearest": ["neighbor", "knn", "ann"],
    "neighbor": ["nearest", "knn", "neighbors"],
    "index": ["indexes", "indexing", "idx"],
    "cache": ["cached", "caching", "lru"],
    "serialize": ["serialization", "encode", "marshal"],
    "deserialize": ["deserialization", "decode", "parse"],
    "concurrent": ["concurrency", "parallel", "thread"],
    "thread": ["threading", "concurrent"],
    "mutex": ["lock", "rwlock"],
    "lock": ["mutex", "locking"],
    "schema": ["migration", "ddl", "table"],
    "migration": ["migrate", "schema"],
    "watch": ["watcher", "notify", "monitor"],
    "daemon": ["server", "service"],
    "token": ["tokens", "tokenize", "tokenizer"],
    "tokenize": ["tokenizer", "token"],
    "hash": ["hashing", "digest", "checksum"],
    "checksum": ["hash", "digest", "blake3"],
    "fingerprint": ["hash", "digest", "staleness"],
    "gpu": ["cuda", "device", "accelerated"],
    "cuda": ["gpu", "device"],
    "download": ["fetch", "pull", "hub"],
    "upload": ["push", "send"],
    "compress": ["compression", "zip", "deflate"],
    "decompress": ["decompression", "inflate"],
    "search": ["query", "lookup", "find"],
    "query": ["search", "queries"],
    "rank": ["ranking", "score", "rerank"],
    "score": ["scoring", "rank"],
    "classify": ["classifier", "classification", "categorize"],
    "classifier": ["classify", "classification"],
    "path": ["filepath", "paths", "file"],
    "storage": ["store", "persistence", "db"],
    "persist": ["persistence", "save", "store"],
    "log": ["logging", "logger", "trace"],
    "trace": ["tracing", "span", "log"],
    "metric": ["metrics", "telemetry", "stats"],
    "stats": ["statistics", "metrics"],
    "chunk": ["chunks", "chunking", "segment"],
    "parse": ["parser", "parsing"],
    "parser": ["parse", "parsing", "grammar"],
}

#: Cross-language concept bridges: one language's construct asked for by
#: another language's name ('SQL equivalent of a Python dictionary',
#: 'TypeScript interface for X'). NOT in BUILTIN: expanding construct
#: keywords on structural queries dilutes the precision the category needs
#: (measured: in BUILTIN this table cost structural_search -12.5pp test R@5
#: while buying type_filtered +7.7 R@20) — the engine overlays it only for
#: the categories whose premise is the bridge (cross_language,
#: type_filtered, conceptual).
BRIDGE: dict[str, list[str]] = {
    "dictionary": ["dict", "hashmap", "map"],
    "dict": ["dictionary", "hashmap", "map"],
    "hashmap": ["dict", "map", "dictionary"],
    "list": ["vec", "array", "vector"],
    "array": ["vec", "list", "slice"],
    "interface": ["trait", "struct", "protocol"],
    "trait": ["interface", "impl"],
    "struct": ["structure", "record", "class"],
    # no "enum" entry: expanding it to enumeration/variant buries constant-
    # table golds under real enums (measured -12.5pp test structural R@5)
    "string": ["str", "text"],
    "closure": ["lambda", "callback"],
    "lambda": ["closure", "callback"],
    "iterator": ["iter", "generator", "cursor"],
    "coroutine": ["async", "task", "future"],
    "promise": ["future", "async"],
    "tuple": ["pair", "record"],
}

#: categories (router.Category values) whose FTS legs overlay BRIDGE
BRIDGE_CATEGORIES = frozenset({"cross_language", "type_filtered", "conceptual"})

#: Directional DDL bridge. When the query itself names SQL as the target
#: language, the generic construct bridge points the WRONG way: "SQL
#: equivalent of a Python dict" needs table/key/value vocabulary, not
#: hashmap/map — the gold is a CREATE TABLE chunk whose body shares zero
#: tokens with the construct's name (r4 triage: both SQL cross-language
#: gate misses were reachable by NO leg; ref analog src/search/synonyms.rs
#: has no directional table — this is a measured gap, not a port).
#: Entries REPLACE the construct's BRIDGE group for the triggered query.
SQL_BRIDGE: dict[str, list[str]] = {
    "dictionary": ["table", "key", "value"],
    "dict": ["table", "key", "value"],
    "hashmap": ["table", "key", "value"],
    "map": ["table", "key", "value"],
    "interface": ["table", "schema", "column"],
    "struct": ["table", "column", "schema"],
    "class": ["table", "column", "schema"],
    "record": ["table", "row", "column"],
    "field": ["column"],
    "property": ["column"],
    "attribute": ["column"],
    "list": ["table", "rows"],
    "array": ["table", "rows"],
}

_SQL_TRIGGERS = frozenset({"sql", "sqlite", "ddl"})


def sql_bridge_overlay(query: str) -> dict[str, list[str]] | None:
    """SQL_BRIDGE when the query names SQL as the target language, else
    None. Token-level trigger: 'postgresql' must not fire it ('sql' as a
    substring), and neither should a query that merely mentions a .sql
    path — hence whole-word alpha tokens only."""
    import re

    toks = set(re.findall(r"[a-z]+", query.lower()))
    return SQL_BRIDGE if toks & _SQL_TRIGGERS else None


#: (suffix, minimum stem length) — longest first. Conservative de-inflection:
#: only unambiguous English derivational/inflectional endings; the stem is
#: served as an FTS5 PREFIX token ("classif" * matches classify/classified/
#: classification), so over-stripping widens matches instead of losing them,
#: and the min-length floor keeps the posting walk bounded.
_STEM_SUFFIXES: tuple[tuple[str, int], ...] = (
    ("izations", 4), ("ization", 4), ("ications", 4), ("ication", 4),
    ("ations", 4), ("ation", 4), ("tions", 4), ("tion", 4),
    ("sions", 4), ("sion", 4), ("ments", 4), ("ment", 4),
    ("ences", 4), ("ence", 4), ("ances", 4), ("ance", 4),
    ("ness", 4), ("ings", 4), ("ing", 4),
    ("ers", 4), ("er", 4), ("ies", 3), ("ied", 3),
    ("es", 4), ("ed", 4), ("s", 4),
)


def stem_prefix(word: str) -> str | None:
    """Conservative stem for FTS5 prefix matching, or None if no suffix
    strips. Connects the morphological variants the plain ``unicode61``
    tokenizer can't ('embeds'->'embed_batch', 'classification'->'classify',
    'migration'->'migrate_v12_to_v13') — measured as the dominant cause of
    no-leg-reaches-the-gold eval misses (r3 dev triage)."""
    w = word.lower()
    if len(w) < 6 or not w.isalpha():
        return None
    for suf, minlen in _STEM_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= minlen:
            return w[: len(w) - len(suf)]
    return None


def acronyms(terms: list[str]) -> dict[str, list[str]]:
    """first-term -> initial-letter acronyms of 3- and 4-term runs.

    Connects spelled-out query phrases to the acronym identifiers code
    actually uses ('reciprocal rank fusion' -> ``rrf`` -> ``rrf_fuse``) —
    an r3 test-split triage found such golds reachable by NO leg: the full
    phrase never co-occurs, and the acronym token is not a synonym of any
    single word. Callers add a candidate to the first term's OR-group only
    when the acronym actually occurs in the target table (df > 0), so the
    expansion is pure rescue — a made-up acronym matches nothing and is
    dropped before the posting walk."""
    out: dict[str, list[str]] = {}
    for n in (3, 4):
        for i in range(len(terms) - n + 1):
            run = terms[i : i + n]
            if all(t.isalpha() and len(t) >= 3 for t in run):
                out.setdefault(run[0], []).append("".join(t[0] for t in run))
    return out


def expand_words(words: list[str], overlay: dict[str, list[str]] | None = None,
                 max_per_word: int = 3, stems: bool = False) -> dict[str, list[str]]:
    """word -> its synonym OR-group (word first). Overlay entries win.
    With ``stems``, a trailing-``*`` FTS5 prefix variant of the word's stem
    joins the group (the caller's MATCH builder renders ``x*`` as ``"x" *``).
    Callers normally add stems selectively instead — only for terms whose
    exact form has ZERO document frequency in the target table (pure rescue;
    unconditional stemming measured -0.9 pp dev R@5 from bm25 dilution)."""
    table = dict(BUILTIN)
    if overlay:
        for k, v in overlay.items():
            table[k.lower()] = list(v)
    out: dict[str, list[str]] = {}
    for w in words:
        syns = table.get(w.lower(), [])[:max_per_word]
        group = [w, *[s for s in syns if s != w]]
        if stems:
            sp = stem_prefix(w)
            if sp is not None:
                group.append(sp + "*")
        out[w] = group
    return out
