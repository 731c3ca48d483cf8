"""Sparse encoder facade, ``splade-hash`` family.

Port of ``cqs_tpu/models/splade.py``: text -> fixed-width (token ids int32
[T], weights f32 [T]) with zero-weight padding. The hash family is host
numpy (log1p term frequencies over the shared hash vocabulary, top-T by
(count desc, id asc)); it touches no device. The neural SPLADE encoder is not
ported yet (ROADMAP "Neural model families").
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cqs_tpu.config import limits as default_limits
from cqs_tpu.models.registry import ModelPreset, get_preset
from cqs_tpu.models.tokenizer import TOKENIZER_VERSION, HashTokenizer
from cqs_tpu.utils.hashing import content_hash


class SpladeEncoder:
    def __init__(self, model: str = "splade-hash", model_path: str | Path | None = None,
                 doc_terms: int | None = None, query_terms: int | None = None,
                 seed: int = 0):
        self.preset: ModelPreset = get_preset(model)
        if self.preset.family != "hash":
            raise NotImplementedError(
                f"sparse model {model!r}: ROADMAP 'Neural model families' "
                f"(not yet ported)")
        self.model_path = Path(model_path) if model_path else None
        self.doc_terms = doc_terms or default_limits.splade_doc_terms
        self.query_terms = query_terms or default_limits.splade_query_terms
        self._seed = seed
        self.tokenizer = HashTokenizer(vocab_size=self.preset.dim)
        self._q_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def vocab_size(self) -> int:
        return self.preset.dim

    @property
    def fingerprint(self) -> str:
        src = str(self.model_path) if self.model_path else f"seed{self._seed}"
        return (f"{self.preset.name}:{self.vocab_size}:"
                f"t{TOKENIZER_VERSION}:{content_hash(src)[:12]}")

    def encode(self, text: str, is_query: bool = False) -> tuple[np.ndarray, np.ndarray]:
        if is_query:
            hit = self._q_cache.get(text)
            if hit is not None:
                return hit
        ids, w = self.encode_batch([text], is_query=is_query)
        out = (ids[0], w[0])
        if is_query:
            if len(self._q_cache) >= 512:
                self._q_cache.clear()
            self._q_cache[text] = out
        return out

    def encode_batch(self, texts: list[str], is_query: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(token_ids [N, T] int32, weights [N, T] f32), zero-padded."""
        T = self.query_terms if is_query else self.doc_terms
        ids_out = np.zeros((len(texts), T), dtype=np.int32)
        w_out = np.zeros((len(texts), T), dtype=np.float32)
        for i, text in enumerate(texts):
            toks = self.tokenizer._hash_ids(text, 1 << 15)
            if len(toks) == 0:
                continue
            uniq, counts = np.unique(toks, return_counts=True)
            order = np.lexsort((uniq, -counts))[:T]
            n = len(order)
            ids_out[i, :n] = uniq[order]
            w_out[i, :n] = np.log1p(counts[order].astype(np.float32))
        return ids_out, w_out
