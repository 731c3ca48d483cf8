"""Sparse encoder facade: text -> fixed-width (token ids int32 [T], weights
f32 [T]) with zero-weight padding.

Port of ``cqs_tpu/models/splade.py``:

- ``splade-hash``: host numpy, log1p term frequencies over the shared hash
  vocabulary, top-T by (count desc, id asc); it touches no device;
- a neural preset (``splade-distil``): ``models/bert.py::SpladeModel`` on
  an explicit device, always in bf16 as in the reference, its weights from a
  HF BertForMaskedLM checkpoint. Activations under the threshold are
  zeroed, the top T taken with ties to the lower id
  (``ops/fusion.py::stable_topk``, ``lax.top_k``'s order), and zero weights
  cleaned to (id 0, weight 0).

One difference of shape, none of value: the reference runs each bucket's
group at its own row count. Here documents are padded to 8, 32 or the
bucket's batch, as the dense embedder pads them, and queries always run in
groups of exactly 8 rows. A query encoded alone and the same query in a
daemon's batch then run the same shapes, so on a GPU they get the same
kernels and bit-equal weights: rows are independent, but a GEMM's result
for a row can depend on the row count through the library's choice of
kernel.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models.registry import ModelPreset, get_preset
from cqs_tpu_torch.models.tokenizer import TOKENIZER_VERSION, HashTokenizer, load_tokenizer, pick_bucket
from cqs_tpu_torch.utils.hashing import content_hash


class SpladeEncoder:
    def __init__(self, model: str = "splade-hash", model_path: str | Path | None = None,
                 doc_terms: int | None = None, query_terms: int | None = None,
                 seed: int = 0, allow_random_weights: bool = False, *,
                 device: str | torch.device | None = None):
        self.preset: ModelPreset = get_preset(model)
        self.model_path = Path(model_path) if model_path else None
        if self.preset.family != "hash" and self.model_path is None \
                and not allow_random_weights:
            from cqs_tpu_torch.models.embedder import WeightlessModelError

            raise WeightlessModelError(
                f"SPLADE preset {model!r} is a neural model but no weights were "
                f"given; set sparse model_path, use 'splade-hash', or pass "
                f"allow_random_weights=True (tests only).")
        self.doc_terms = doc_terms or default_limits.splade_doc_terms
        self.query_terms = query_terms or default_limits.splade_query_terms
        self.threshold = default_limits.splade_threshold
        self._seed = seed
        self._q_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._lock = threading.Lock()
        self._model: torch.nn.Module | None = None
        self.device: torch.device | None = None
        if self.preset.family == "hash":
            self.tokenizer = HashTokenizer(vocab_size=self.preset.dim)
        else:
            if device is None:
                raise ValueError(f"SPLADE preset {model!r} runs a model: pass device= "
                                 f"('cuda' or 'cpu')")
            self.device = resolve_device(device)
            self.tokenizer = load_tokenizer(self.model_path, vocab_size=self.preset.vocab_size)
            # vocab-mismatch fail-fast (ref: src/splade/mod.rs init)
            if self.tokenizer.vocab_size > self.preset.dim:
                raise ValueError(
                    f"SPLADE vocab mismatch: tokenizer has {self.tokenizer.vocab_size} "
                    f"tokens but model activations cover {self.preset.dim}")

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
        if not texts:
            return (np.zeros((0, T), np.int32), np.zeros((0, T), np.float32))
        if self.preset.family == "hash":
            return self._encode_hash(texts, T)
        return self._encode_model(texts, T, is_query)

    def _encode_hash(self, texts: list[str], T: int) -> tuple[np.ndarray, np.ndarray]:
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

    # -- the model (neural presets) ----------------------------------------

    def _ensure_model(self) -> torch.nn.Module:
        model = self._model
        if model is not None:
            return model
        with self._lock:
            if self._model is None:
                self._model = self._build_model()
            return self._model

    def _build_model(self) -> torch.nn.Module:
        """``SpladeModel`` at the preset's geometry in bf16, weights from a HF
        checkpoint in ``model_path`` when it has one (``splade.py:126-152``)."""
        from cqs_tpu_torch.models.bert import BertConfig, SpladeModel
        from cqs_tpu_torch.models.embedder import build_module
        from cqs_tpu_torch.models.loader import load_safetensors_params

        p = self.preset
        cfg = BertConfig(vocab_size=self.tokenizer.vocab_size, hidden_size=p.hidden_size,
                         num_layers=p.num_layers, num_heads=p.num_heads,
                         intermediate_size=p.intermediate_size, max_position=p.max_seq_len)
        module = build_module(lambda: SpladeModel(cfg), self.device, self._seed)
        if self.model_path is not None:
            loaded = load_safetensors_params(self.model_path, module.state_dict(), p.family)
            if loaded is not None:
                with torch.no_grad():
                    module.load_state_dict(loaded)
        return module

    def _encode_model(self, texts: list[str], T: int, is_query: bool
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Bucketed forward passes (``splade.py:154-189``): buckets 64, 128,
        256 and the preset's length; documents up to ``min(64, 4096 //
        (bucket // 64))`` rows a pass, queries 8, padded as the module
        docstring says."""
        from cqs_tpu_torch.ops.fusion import stable_topk

        model = self._ensure_model()
        max_len = self.preset.max_seq_len
        ladder = [64, 128, 256, max_len]
        encs = [self.tokenizer.encode(t, max_len) for t in texts]
        buckets = [pick_bucket(int(e.mask.sum()), ladder) for e in encs]
        ids_out = np.zeros((len(texts), T), dtype=np.int32)
        w_out = np.zeros((len(texts), T), dtype=np.float32)
        for bucket in sorted(set(buckets)):
            rows = [i for i, b in enumerate(buckets) if b == bucket]
            bsz = 8 if is_query else max(1, min(64, 4096 // max(1, bucket // 64)))
            for s in range(0, len(rows), bsz):
                batch = rows[s: s + bsz]
                padded = next((r for r in (8, 32) if len(batch) <= r <= bsz), bsz)
                ids = np.zeros((padded, bucket), np.int64)
                mask = np.zeros((padded, bucket), np.int32)
                mask[len(batch):, 0] = 1
                for j, i in enumerate(batch):
                    ids[j] = encs[i].ids[:bucket]
                    mask[j] = encs[i].mask[:bucket]
                with torch.inference_mode():
                    acts = model(torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))[: len(batch)]
                    acts = torch.where(acts >= self.threshold, acts, torch.zeros_like(acts))
                    w, idx = stable_topk(acts, T)
                    w, idx = w.cpu().numpy(), idx.cpu().numpy().astype(np.int32)
                keep = w > 0
                ids_out[batch] = np.where(keep, idx, 0)
                w_out[batch] = np.where(keep, w, 0.0)
        return ids_out, w_out
