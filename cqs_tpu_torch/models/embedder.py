"""The dense embedder facade, hash family: tokenize -> bucket-pad -> table
gather -> masked mean -> L2 norm, on an explicit device.

Port of the hash family of ``cqs_tpu/models/embedder.py`` (:139-156). The
table is the reference's ``jax.random.normal`` table, reproduced in numpy
(:mod:`cqs_tpu_torch.models.hash_table`) and row-normalized on the device,
and the fingerprint is the reference's, so indexes, caches and the packaged
router centroids keyed on it carry over. The neural families (bert, hybrid,
gemma, qwen3) are not ported yet (ROADMAP "Neural model families").
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from cqs_tpu.config import limits as default_limits
from cqs_tpu.models.registry import ModelPreset, get_preset
from cqs_tpu.models.tokenizer import TOKENIZER_VERSION, BaseTokenizer, load_tokenizer, pick_bucket
from cqs_tpu.utils.hashing import content_hash
from cqs_tpu.utils.trace import span
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models.hash_table import normal_table

_NEURAL_TODO = "ROADMAP 'Neural model families' (not yet ported)"


def _buckets_from_limits(max_seq_len: int) -> list[int]:
    raw = default_limits.embed_buckets
    buckets = sorted({int(b) for b in str(raw).split(",") if b.strip()})
    return [b for b in buckets if b <= max_seq_len] or [max_seq_len]


class Embedder:
    """Dense embedding facade (hash family)."""

    def __init__(self, model: str = "hash", model_path: str | Path | None = None,
                 seed: int = 0, *, device: str | torch.device):
        self.preset: ModelPreset = get_preset(model)
        if self.preset.family != "hash":
            raise NotImplementedError(
                f"model family {self.preset.family!r} ({model}): {_NEURAL_TODO}")
        self.device = resolve_device(device)
        self.model_path = Path(model_path) if model_path else None
        self.tokenizer: BaseTokenizer = load_tokenizer(self.model_path, vocab_size=32768)
        self.max_seq_len = self.preset.max_seq_len
        self.query_prefix = self.preset.query_prefix
        self.doc_prefix = self.preset.doc_prefix
        self.buckets = _buckets_from_limits(self.max_seq_len)
        self._seed = seed
        self._lock = threading.Lock()
        self._table: torch.Tensor | None = None
        self._query_lru: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lru_cap = default_limits.query_cache_entries

    @property
    def dim(self) -> int:
        return self.preset.dim

    @property
    def fingerprint(self) -> str:
        """The reference's model identity (``embedder.py:117-126``)."""
        src = str(self.model_path) if self.model_path else f"seed{self._seed}"
        return (f"{self.preset.name}:{self.preset.dim}:"
                f"t{TOKENIZER_VERSION}:{content_hash(src)[:12]}")

    # -- parameters --------------------------------------------------------

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Install parameters (``{"table": [vocab, dim] f32}``, row-normalized),
        e.g. from :func:`cqs_tpu_torch.models.convert.embedder_params_from_jax`."""
        table = params["table"]
        want = (self.tokenizer.vocab_size, self.preset.dim)
        if tuple(table.shape) != want:
            raise ValueError(f"table shape {tuple(table.shape)} != {want}")
        with self._lock:
            self._table = table.to(self.device, torch.float32)

    def _ensure_model(self) -> None:
        if self._table is not None:
            return
        with self._lock:
            if self._table is not None:
                return
            raw = normal_table(self._seed, self.tokenizer.vocab_size, self.preset.dim)
            table = torch.from_numpy(np.array(raw)).to(self.device)
            self._table = table / torch.linalg.vector_norm(table, dim=-1, keepdim=True)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        self._ensure_model()
        ids_t = torch.from_numpy(ids).to(self.device, torch.int64)
        m = torch.from_numpy(mask).to(self.device, torch.float32)[..., None]
        vecs = self._table[ids_t]                                   # [B, L, D]
        pooled = (vecs * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return (pooled / torch.clamp(norm, min=1e-12)).cpu().numpy()

    # -- public API --------------------------------------------------------

    def embed_documents(self, texts: list[str]) -> np.ndarray:
        """Batch-encode documents with the doc prefix. Returns [N, D] f32."""
        return self._embed(texts, self.doc_prefix)

    def embed_query(self, text: str) -> np.ndarray:
        """Encode one query (LRU-cached) with the query prefix."""
        hit = self._query_lru.get(text)
        if hit is not None:
            self._query_lru.move_to_end(text)
            return hit
        vec = self._embed([text], self.query_prefix)[0]
        if self._lru_cap > 0:
            self._query_lru[text] = vec
            while len(self._query_lru) > self._lru_cap:
                self._query_lru.popitem(last=False)
        return vec

    def _embed(self, texts: list[str], prefix: str) -> np.ndarray:
        """Bucket-padded batches, as the reference pads them (same shapes,
        so the same masked sums)."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        encs = [self.tokenizer.encode(prefix + t, self.max_seq_len) for t in texts]
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        by_bucket: dict[int, list[int]] = {}
        for i, e in enumerate(encs):
            by_bucket.setdefault(pick_bucket(int(e.mask.sum()), self.buckets), []).append(i)
        for bucket, idxs in sorted(by_bucket.items()):
            max_bsz = self.preset.batch_size(bucket)
            bsz = next((r for r in (8, 32, 128) if len(idxs) <= r <= max_bsz), max_bsz)
            with span("embed_bucket", bucket=bucket, n=len(idxs)):
                for s in range(0, len(idxs), bsz):
                    batch = idxs[s: s + bsz]
                    ids = np.stack([encs[i].ids[:bucket] for i in batch])
                    mask = np.stack([encs[i].mask[:bucket] for i in batch])
                    pad = bsz - len(batch)
                    if pad > 0:
                        ids = np.concatenate([ids, np.zeros((pad, bucket), np.int32)])
                        mask = np.concatenate([mask, np.zeros((pad, bucket), np.int32)])
                        mask[len(batch):, 0] = 1
                    out[batch] = self._forward(ids, mask)[: len(batch)]
        return out

    # -- windowing (long inputs) ------------------------------------------

    def split_into_windows(self, text: str, overlap_frac: float | None = None) -> list[str]:
        """Split text into max_seq_len token windows with overlap (the
        reference's line-sliced windowing, ``embedder.py:342``)."""
        overlap = (overlap_frac if overlap_frac is not None
                   else default_limits.window_overlap_frac)
        max_len = self.max_seq_len - 8
        if self.tokenizer.token_count(text) <= max_len:
            return [text]
        lines = text.splitlines()
        counts = [max(1, self.tokenizer.token_count(ln)) for ln in lines]
        windows: list[str] = []
        cur: list[str] = []
        cur_tokens = 0
        step_back = int(max_len * overlap)
        window_start = 0
        i = 0
        while i < len(lines):
            t = counts[i]
            if cur_tokens + t > max_len and cur:
                windows.append("\n".join(cur))
                back_tokens = 0
                j = i - 1
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

    def token_count(self, text: str) -> int:
        return self.tokenizer.token_count(text)
