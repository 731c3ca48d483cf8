"""A frozen copy of the port's hash tokenizer (``cqs_tpu_torch/models/
tokenizer.py::HashTokenizer`` over ``utils/text.py::tokenize_identifier``,
tokenizer version 2), in plain Python, so the reference tokenizes the texts
itself. Words: identifier-aware pieces (camelCase and snake_case split,
lower case, a light stemmer), hashed by 64-bit FNV-1a into ids 4..vocab-1;
``[CLS] body [SEP]`` with ids 1 and 2.
"""

from __future__ import annotations

import re

import numpy as np

_CAMEL_1 = re.compile(r"([a-z0-9])([A-Z])")
_CAMEL_2 = re.compile(r"([A-Z]+)([A-Z][a-z])")
_SEP = re.compile(r"[_\-.:/\\]+")
_NON_WORD = re.compile(r"[^0-9A-Za-z ]+")
_NON_ASCII = re.compile(r"[^\x00-\x7f]+")
_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")
_SUFFIXES = (("ingly", ""), ("edly", ""), ("ing", ""), ("ied", "y"), ("ies", "y"),
             ("ed", ""), ("es", ""), ("s", ""))

CLS, SEP = 1, 2


def identifier_words(ident: str) -> list[str]:
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


def stem(word: str) -> str:
    for suf, repl in _SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            word = word[: len(word) - len(suf)] + repl
            break
    if len(word) > 3 and word[-1] == word[-2] and word[-1] not in "aeiou":
        word = word[:-1]
    if len(word) > 3 and word.endswith("e"):
        word = word[:-1]
    return word


def words(text: str) -> list[str]:
    out: list[str] = []
    for raw in _WORD_RE.findall(text):
        if raw.isidentifier():
            parts = [stem(w) for w in identifier_words(raw)]
            if not parts and raw.isascii():
                parts = [raw.lower()]
            out.extend(parts)
        elif raw.isascii():
            out.append(raw.lower())
    return out


def word_id(word: str, vocab_size: int) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return 4 + h % (vocab_size - 4)


def encode(text: str, vocab_size: int, max_len: int) -> np.ndarray:
    """The ids of ``[CLS] body [SEP]``, the body cut to ``max_len - 2``
    words, unpadded."""
    body = [word_id(w, vocab_size) for w in words(text)[: max_len - 2]]
    return np.asarray([CLS, *body, SEP], dtype=np.int64)


def encode_batch(texts: list[str], vocab_size: int, max_len: int,
                 length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Ids and mask ``[N, length]`` (default: the longest), padded with 0."""
    encs = [encode(t, vocab_size, max_len) for t in texts]
    n = length or max(len(e) for e in encs)
    ids = np.zeros((len(encs), n), np.int64)
    mask = np.zeros((len(encs), n), np.int64)
    for i, e in enumerate(encs):
        ids[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return ids, mask
