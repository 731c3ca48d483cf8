"""Tokenization: HF tokenizer files when present, hash tokenizer otherwise.

Reference analog: the ``tokenizers`` crate usage inside ``src/embedder/core.rs``
and ``src/splade/mod.rs`` (vocab-mismatch fail-fast at SPLADE init).

Offline stance: real model checkpoints/tokenizers may not exist in the
environment. Every tokenizer here implements the same protocol, so the whole
retrieval stack (dense + SPLADE vocab space) runs identically on the
deterministic :class:`HashTokenizer` — the production-grade analog of the
reference's MockEmbedder test tier (``tests/common/mod.rs:139``) — and
switches to real vocab files when a model directory provides them.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from cqs_tpu_torch.utils.text import tokenize_identifier


#: Bumped when tokenization output changes (hash function, splitting rules);
#: folded into model fingerprints so stale embeddings rebuild.
TOKENIZER_VERSION = 2


@dataclass
class Encoded:
    ids: np.ndarray        # [L] int32
    mask: np.ndarray       # [L] int32 (1 = real token)


class BaseTokenizer:
    vocab_size: int
    pad_id: int = 0
    cls_id: int | None = None
    sep_id: int | None = None

    def encode(self, text: str, max_len: int) -> Encoded:
        raise NotImplementedError

    def encode_batch(self, texts: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        encs = [self.encode(t, max_len) for t in texts]
        ids = np.stack([e.ids for e in encs])
        mask = np.stack([e.mask for e in encs])
        return ids, mask

    def token_count(self, text: str) -> int:
        # default: count via a no-pad encode; subclasses override with
        # cheaper paths (padding to max_len here would be O(max_len) per call)
        return int(self.encode(text, 4096).mask.sum())


_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")


class HashTokenizer(BaseTokenizer):
    """Deterministic hash tokenizer over identifier-aware word pieces.

    Words are split camelCase/snake_case (so code identifiers share tokens
    with their NL descriptions), then hashed into a fixed vocab. Collisions
    are rare at 32k for typical corpora and harmless for retrieval tests.
    IDs 0-3 are reserved (pad/cls/sep/unk).
    """

    def __init__(self, vocab_size: int = 32768):
        self.vocab_size = vocab_size
        self.pad_id, self.cls_id, self.sep_id, self.unk_id = 0, 1, 2, 3
        self._reserved = 4
        self._id_cache: dict[str, int] = {}

    def _tok_id(self, word: str) -> int:
        # FNV-1a 64 — bit-identical to the native C++ scanner's hash
        # (cqs_tpu/native), so both paths produce the same token ids.
        hit = self._id_cache.get(word)
        if hit is not None:
            return hit
        h = 0xCBF29CE484222325
        for b in word.encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        tid = self._reserved + h % (self.vocab_size - self._reserved)
        if len(self._id_cache) < 1 << 20:
            self._id_cache[word] = tid
        return tid

    @staticmethod
    def _stem(word: str) -> str:
        """Light suffix stripping so 'validated'/'validates'/'validating' all
        hash with 'validate' — cheap stand-in for subword vocab sharing."""
        for suf, repl in (("ingly", ""), ("edly", ""), ("ing", ""), ("ied", "y"),
                          ("ies", "y"), ("ed", ""), ("es", ""), ("s", "")):
            if word.endswith(suf) and len(word) - len(suf) >= 3:
                word = word[: len(word) - len(suf)] + repl
                break
        # normalize trailing doubled consonant ("runn" -> "run") and
        # trailing 'e' ("validate" -> "validat") so -ing/-ed forms converge
        if len(word) > 3 and word[-1] == word[-2] and word[-1] not in "aeiou":
            word = word[:-1]
        if len(word) > 3 and word.endswith("e"):
            word = word[:-1]
        return word

    def tokenize_words(self, text: str) -> list[str]:
        words: list[str] = []
        for raw in _WORD_RE.findall(text):
            if raw.isidentifier():
                parts = [self._stem(w) for w in tokenize_identifier(raw)]
                if not parts and raw.isascii():
                    parts = [raw.lower()]
                words.extend(parts)
            elif raw.isascii():
                # non-ASCII punctuation is dropped (matches the native scanner,
                # which operates on UTF-8 bytes)
                words.append(raw.lower())
        return words

    def _hash_ids(self, text: str, max_tokens: int) -> np.ndarray:
        """Token ids for the text body — native C++ scanner when available,
        bit-identical Python fallback otherwise."""
        from cqs_tpu_torch.native import tokenize_hash

        native = tokenize_hash(text, self.vocab_size, max_tokens)
        if native is not None:
            return native
        words = self.tokenize_words(text)[:max_tokens]
        return np.asarray([self._tok_id(w) for w in words], dtype=np.int32)

    def encode(self, text: str, max_len: int) -> Encoded:
        body = self._hash_ids(text, max_len - 2)
        n = len(body) + 2
        ids_arr = np.zeros(max_len, dtype=np.int32)
        ids_arr[0] = self.cls_id
        ids_arr[1 : 1 + len(body)] = body
        ids_arr[min(1 + len(body), max_len - 1)] = self.sep_id
        mask = np.zeros(max_len, dtype=np.int32)
        mask[: min(n, max_len)] = 1
        return Encoded(ids=ids_arr, mask=mask)

    def token_count(self, text: str) -> int:
        return len(self._hash_ids(text, 1 << 16)) + 2


class HFTokenizer(BaseTokenizer):
    """Wrapper over a ``tokenizer.json`` (HF tokenizers lib) in a model dir."""

    def __init__(self, model_dir: str | Path):
        from tokenizers import Tokenizer  # baked-in dependency

        path = Path(model_dir) / "tokenizer.json"
        if not path.is_file():
            raise FileNotFoundError(path)
        self._tok = Tokenizer.from_file(str(path))
        self.vocab_size = self._tok.get_vocab_size()
        vocab = self._tok.get_vocab()
        self.pad_id = vocab.get("[PAD]", vocab.get("<pad>", 0))
        self.cls_id = vocab.get("[CLS]", vocab.get("<s>", vocab.get("<bos>")))
        self.sep_id = vocab.get("[SEP]", vocab.get("</s>", vocab.get("<eos>")))

    def encode(self, text: str, max_len: int) -> Encoded:
        enc = self._tok.encode(text)
        ids = enc.ids[:max_len]
        n = len(ids)
        ids = ids + [self.pad_id] * (max_len - n)
        mask = np.zeros(max_len, dtype=np.int32)
        mask[:n] = 1
        return Encoded(ids=np.asarray(ids, dtype=np.int32), mask=mask)


def load_tokenizer(model_dir: str | Path | None, vocab_size: int = 32768) -> BaseTokenizer:
    """HF tokenizer if the model dir has one, else the hash tokenizer."""
    if model_dir is not None and (Path(model_dir) / "tokenizer.json").is_file():
        return HFTokenizer(model_dir)
    return HashTokenizer(vocab_size=vocab_size)


def pick_bucket(length: int, buckets: list[int]) -> int:
    """Smallest bucket >= length (last bucket if none fits) — static shapes
    for XLA: every batch pads to a bucket length so compilation is reused."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
