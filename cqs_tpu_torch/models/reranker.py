"""Cross-encoder reranker facade.

Port of ``cqs_tpu/models/reranker.py``: opt-in (the reference measured
MiniLM rerank net-negative, so the default is :class:`NoopReranker`). All
(query, passage) pairs of a call are packed into one batch of
``max_len`` tokens, scored by ``models/bert.py::CrossEncoder`` on an
explicit device (f32 unless the device is a GPU, bf16 there, as the
embedder's bert family) and ordered by a stable descending sort.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models.registry import get_preset
from cqs_tpu_torch.models.tokenizer import load_tokenizer


class NoopReranker:
    """Default: keep the fused order untouched."""

    def rerank(self, query: str, passages: list[str]) -> list[int]:
        return list(range(len(passages)))


class CrossEncoderReranker:
    """MiniLM-geometry cross-encoder scoring (query, passage) pairs."""

    def __init__(self, model: str = "minilm-l6", model_path: str | Path | None = None,
                 max_len: int = 256, seed: int = 0, allow_random_weights: bool = False, *,
                 device: str | torch.device):
        from cqs_tpu_torch.models.embedder import WeightlessModelError

        self.preset = get_preset(model)
        self.model_path = Path(model_path) if model_path else None
        if self.preset.family != "hash" and self.model_path is None \
                and not allow_random_weights:
            raise WeightlessModelError(
                f"reranker preset {model!r} is a neural model but no weights "
                f"were given; set rerank model_path or pass "
                f"allow_random_weights=True (tests only).")
        self.device = resolve_device(device)
        self.tokenizer = load_tokenizer(self.model_path, vocab_size=self.preset.vocab_size)
        self.max_len = max_len
        self._seed = seed
        self._lock = threading.Lock()
        self._model: torch.nn.Module | None = None

    def _ensure(self) -> torch.nn.Module:
        model = self._model
        if model is not None:
            return model
        with self._lock:
            if self._model is None:
                self._model = self._build()
            return self._model

    def _build(self) -> torch.nn.Module:
        """The preset's geometry, or a native checkpoint's (whose
        ``max_position`` also sets ``max_len``); weights from a native or HF
        checkpoint in ``model_path`` (``reranker.py:52-93``)."""
        from cqs_tpu_torch.models.bert import BertConfig, CrossEncoder
        from cqs_tpu_torch.models.embedder import (WeightlessModelError, build_module,
                                                   compute_dtype, native_config)
        from cqs_tpu_torch.models.loader import load_cross_encoder_params

        native = native_config(self.model_path)
        if native:
            self.max_len = int(native.get("max_position", self.max_len))
        p = self.preset
        cfg = BertConfig(
            vocab_size=int(native.get("vocab_size", self.tokenizer.vocab_size)),
            hidden_size=int(native.get("hidden_size", p.hidden_size)),
            num_layers=int(native.get("num_layers", p.num_layers)),
            num_heads=int(native.get("num_heads", p.num_heads)),
            intermediate_size=int(native.get("intermediate_size", p.intermediate_size)),
            max_position=self.max_len, dtype=compute_dtype(self.device))
        module = build_module(lambda: CrossEncoder(cfg), self.device, self._seed)
        if self.model_path is not None:
            loaded = load_cross_encoder_params(self.model_path, module.state_dict())
            if loaded is None:
                raise WeightlessModelError(
                    f"no loadable cross-encoder checkpoint at {self.model_path}")
            with torch.no_grad():
                module.load_state_dict(loaded)
        return module

    def score(self, query: str, passages: list[str]) -> np.ndarray:
        """One relevance score a passage: ``[query tokens][passage tokens]``
        in ``max_len`` positions, the query cut to ``max_len // 2 - 2``
        tokens, the passage's type ids 1 (``reranker.py:95-117``)."""
        model = self._ensure()
        L = self.max_len
        q_enc = self.tokenizer.encode(query, L // 2 - 2)
        q_n = int(q_enc.mask.sum())
        ids = np.zeros((len(passages), L), dtype=np.int64)
        mask = np.zeros((len(passages), L), dtype=np.int64)
        types = np.zeros((len(passages), L), dtype=np.int64)
        for i, p in enumerate(passages):
            p_enc = self.tokenizer.encode(p, L - q_n)
            p_n = int(p_enc.mask.sum())
            ids[i, :q_n] = q_enc.ids[:q_n]
            ids[i, q_n: q_n + p_n] = p_enc.ids[:p_n]
            mask[i, : q_n + p_n] = 1
            types[i, q_n: q_n + p_n] = 1
        with torch.inference_mode():
            out = model(*(torch.from_numpy(a).to(self.device) for a in (ids, mask, types)))
            return out.float().cpu().numpy()

    def rerank(self, query: str, passages: list[str]) -> list[int]:
        if not passages:
            return []
        scores = self.score(query, passages)
        return list(np.argsort(-scores, kind="stable"))
