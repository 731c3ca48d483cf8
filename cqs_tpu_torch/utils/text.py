"""Identifier tokenization and FTS normalization.

Reference analog: ``tokenize_identifier`` / ``normalize_for_fts`` in
``src/nl/fts.rs`` — camelCase/snake_case/kebab-case splitting so that
"searchFiltered", "search_filtered" and "search-filtered" all index and match
as the words "search filtered". This text shapes both the FTS index and the
NL that gets embedded, so it is recall-critical.
"""

from __future__ import annotations

import functools
import re

# camelCase boundaries, including acronym runs: "HTTPServer" -> "HTTP Server",
# "parseJSONFast" -> "parse JSON Fast".
_CAMEL_1 = re.compile(r"([a-z0-9])([A-Z])")
_CAMEL_2 = re.compile(r"([A-Z]+)([A-Z][a-z])")
_SEP = re.compile(r"[_\-.:/\\]+")
_NON_WORD = re.compile(r"[^0-9A-Za-z ]+")
_WS = re.compile(r"\s+")


def split_camel(word: str) -> list[str]:
    word = _CAMEL_2.sub(r"\1 \2", word)
    word = _CAMEL_1.sub(r"\1 \2", word)
    return [w for w in word.split() if w]


_NON_ASCII = re.compile(r"[^\x00-\x7f]+")


def tokenize_identifier(ident: str) -> list[str]:
    """Split an identifier into lowercase words.

    ``"HnswIndex::search_filtered"`` -> ``["hnsw", "index", "search", "filtered"]``

    Non-ASCII bytes act as separators (keeps the pure-Python tokenizer
    bit-identical to the native byte-oriented scanner).
    """
    ident = _NON_ASCII.sub(" ", ident)
    parts: list[str] = []
    for seg in _SEP.split(ident):
        if not seg:
            continue
        for w in split_camel(seg):
            w = _NON_WORD.sub("", w)
            if w:
                parts.append(w.lower())
    return parts


@functools.lru_cache(maxsize=1 << 17)
def _fts_word(raw: str) -> str:
    """Normalized fragment for ONE whitespace token (see normalize_for_fts).
    Cached: source-code words repeat enormously (keywords, common
    identifiers) — the 3-regex tokenization per OCCURRENCE was half the
    whole indexing pipeline's host time (21 s of 41 s on a 120-file slice,
    1.95M tokenize_identifier calls)."""
    cleaned = _NON_WORD.sub(" ", raw).strip()
    words = tokenize_identifier(raw)
    if cleaned and len(words) > 1:
        # keep the joined form as well as the split words
        return " ".join(["".join(words)] + words)
    return " ".join(words)


def normalize_for_fts(text: str) -> str:
    """Normalize arbitrary text for the FTS index: split identifiers embedded
    in prose, keep the original tokens too (so exact-identifier queries still
    hit), lowercase, single-space."""
    return " ".join(f for f in map(_fts_word, _WS.split(text)) if f)


_STOPWORDS = frozenset(
    """a an and are as at be by for from has have in is it its of on or that the
    to was were will with this those these not no""".split()
)


def content_words(text: str) -> list[str]:
    """Lowercased word stream with stopwords removed — used for body-keyword
    extraction in NL generation."""
    return [w for w in normalize_for_fts(text).split() if w not in _STOPWORDS and len(w) > 1]
