"""The dense embedder facade: tokenize -> bucket-pad -> forward on an
explicit device -> pooled, L2-normalized vectors.

Port of ``cqs_tpu/models/embedder.py``. Every family runs:

- ``hash``: the reference's ``jax.random.normal`` table, reproduced in numpy
  (:mod:`cqs_tpu_torch.models.hash_table`) and row-normalized on the device;
  a gather, a masked mean and an L2 norm;
- ``bert`` (``models/bert.py``), ``hybrid`` (``models/hybrid.py``), ``gemma``
  and ``qwen3`` (``models/gemma.py``), ``deepseek`` (``models/deepseek.py``,
  the port's own): ``torch.nn.Module``s built on the device, their weights
  from a native ``cqs_config.json`` checkpoint or a HF safetensors
  checkpoint (``models/loader.py``). The reference runs bert and hybrid in
  f32 off the TPU; here they and deepseek run in f32 unless the device is a
  GPU, where they run in bf16. Gemma and qwen3 keep their config's bf16
  everywhere, as in the reference.

Shapes are the reference's: sequence buckets from ``embed_buckets``, the
batch padded to 8/32/128 or the preset's device batch, so the same rows see
the same masked sums. A neural preset without weights is refused
(:class:`WeightlessModelError`) unless the caller allows random weights; a
model that fails to load or to run raises, on every device.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.models.registry import ModelPreset, get_preset
from cqs_tpu_torch.models.tokenizer import TOKENIZER_VERSION, BaseTokenizer, load_tokenizer, pick_bucket
from cqs_tpu_torch.utils.hashing import content_hash
from cqs_tpu_torch.utils.trace import recorder, span
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models.hash_table import normal_table


class WeightlessModelError(RuntimeError):
    """A neural preset was requested without weights. A random-init
    transformer produces a functioning-looking but garbage index, so this is
    a hard error unless the caller opts in explicitly (tests do)."""


def _buckets_from_limits(max_seq_len: int) -> list[int]:
    raw = default_limits.embed_buckets
    buckets = sorted({int(b) for b in str(raw).split(",") if b.strip()})
    return [b for b in buckets if b <= max_seq_len] or [max_seq_len]


def native_config(model_path: Path | None) -> dict:
    """A native checkpoint's ``cqs_config.json``, or ``{}``."""
    if model_path is None or not (model_path / "cqs_config.json").is_file():
        return {}
    with open(model_path / "cqs_config.json") as f:
        return json.load(f)


def compute_dtype(device: torch.device) -> torch.dtype:
    """The dtype of the bert-family models: bf16 on a GPU, f32 elsewhere
    (the reference's TPU / off-TPU switch)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def build_module(factory, device: torch.device, seed: int) -> torch.nn.Module:
    """``factory()`` with its parameters allocated on ``device``, randomly
    initialized from ``seed`` (``models/layers.py::init_module``), in eval
    mode."""
    from cqs_tpu_torch.models.layers import init_module

    with torch.device(device):
        module = factory()
    return init_module(module, seed).eval()


class Embedder:
    """Dense embedding inference facade."""

    def __init__(self, model: str = "hash", model_path: str | Path | None = None,
                 seed: int = 0, allow_random_weights: bool = False, *,
                 device: str | torch.device):
        self.preset: ModelPreset = get_preset(model)
        self.device = resolve_device(device)
        self.model_path = Path(model_path) if model_path else None
        if self.preset.family != "hash" and self.model_path is None \
                and not allow_random_weights:
            raise WeightlessModelError(
                f"model preset {model!r} is a neural model but no weights were "
                f"given: a random-init transformer embeds noise and would build "
                f"a garbage index. Set embedding.model_path (or --model-path) to "
                f"a local checkpoint of {self.preset.hf_repo or model}, use the "
                f"'hash' lexical model, or pass allow_random_weights=True "
                f"(tests only).")
        # gemma and qwen3 hash into 32768 ids, as the reference does; bert and
        # deepseek into their preset's vocabulary
        self.tokenizer: BaseTokenizer = load_tokenizer(
            self.model_path, vocab_size=self.preset.vocab_size
            if self.preset.family in ("bert", "deepseek") else 32768)
        # a native checkpoint carries its own sequence length, dim and
        # prefixes, which win over the preset's
        self.max_seq_len = self.preset.max_seq_len
        self._native_dim: int | None = None
        self.query_prefix = self.preset.query_prefix
        self.doc_prefix = self.preset.doc_prefix
        native = native_config(self.model_path)
        if native:
            self.max_seq_len = int(native.get("max_position", self.preset.max_seq_len))
            self._native_dim = int(native["hidden_size"])
            if native.get("family") == "hybrid":
                self._native_dim += int(native.get("hash_dim", 256))
            self.query_prefix = native.get("query_prefix", self.query_prefix)
            self.doc_prefix = native.get("doc_prefix", self.doc_prefix)
        elif self.preset.family == "deepseek" and self.model_path is not None \
                and (self.model_path / "config.json").is_file():
            # the vectors are the checkpoint's hidden states, at its width
            with open(self.model_path / "config.json") as f:
                self._native_dim = int(json.load(f)["hidden_size"])
        self.buckets = _buckets_from_limits(self.max_seq_len)
        self._seed = seed
        self._lock = threading.Lock()
        #: the hash family's [vocab, dim] table, or the neural family's module
        self._model: torch.Tensor | torch.nn.Module | None = None
        self._query_lru: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lru_cap = default_limits.query_cache_entries

    @property
    def dim(self) -> int:
        if self._native_dim is not None:
            return self._native_dim
        # weightless gemma/qwen3 run the small test geometry (embedder.py:106-113)
        if self.preset.family in ("gemma", "qwen3") and self.model_path is None:
            from cqs_tpu_torch.models.gemma import GemmaConfig

            cfg = GemmaConfig.small_test()
            return cfg.hidden_size if self.preset.family == "qwen3" else cfg.embed_dim
        if self.preset.family == "deepseek" and self.model_path is None:
            from cqs_tpu_torch.models.deepseek import DeepseekV2Config

            return DeepseekV2Config.small_test().hidden_size
        return self.preset.dim

    @property
    def fingerprint(self) -> str:
        """The reference's model identity (``embedder.py:117-126``)."""
        src = str(self.model_path) if self.model_path else f"seed{self._seed}"
        return (f"{self.preset.name}:{self.preset.dim}:"
                f"t{TOKENIZER_VERSION}:{content_hash(src)[:12]}")

    # -- parameters --------------------------------------------------------

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Install parameters: for the hash family ``{"table": [vocab, dim]
        f32}`` (row-normalized, e.g. from
        :func:`cqs_tpu_torch.models.convert.embedder_params_from_jax`); for a
        neural family the module's state dict (e.g. from
        :func:`cqs_tpu_torch.models.convert.params_from_flax`)."""
        if self.preset.family == "hash":
            table = params["table"]
            want = (self.tokenizer.vocab_size, self.preset.dim)
            if tuple(table.shape) != want:
                raise ValueError(f"table shape {tuple(table.shape)} != {want}")
            with self._lock:
                self._model = table.to(self.device, torch.float32)
            return
        module = self._ensure_model()
        with torch.no_grad():
            module.load_state_dict(params)

    def _ensure_model(self) -> torch.Tensor | torch.nn.Module:
        """The device-resident table or module, built when absent (first
        use, or the first use after :meth:`clear_session`)."""
        model = self._model
        if model is not None:
            return model
        with self._lock:
            if self._model is None:
                self._model = self._build_model()
            return self._model

    def _build_model(self) -> torch.Tensor | torch.nn.Module:
        fam = self.preset.family
        if fam == "hash":
            raw = normal_table(self._seed, self.tokenizer.vocab_size, self.preset.dim)
            table = torch.from_numpy(np.array(raw)).to(self.device)
            return table / torch.linalg.vector_norm(table, dim=-1, keepdim=True)
        native = native_config(self.model_path)
        if fam in ("bert", "hybrid"):
            from cqs_tpu_torch.models.bert import BertConfig, BertDenseEmbedder
            from cqs_tpu_torch.models.hybrid import HybridConfig, HybridDenseEmbedder

            # geometry: the preset's, or a native checkpoint's own
            p = self.preset
            geo = {"vocab_size": self.tokenizer.vocab_size, "hidden_size": p.hidden_size,
                   "num_layers": p.num_layers, "num_heads": p.num_heads,
                   "intermediate_size": p.intermediate_size, "max_position": p.max_seq_len}
            geo.update({k: int(native[k]) for k in geo if k in native})
            cfg = BertConfig(**geo, dtype=compute_dtype(self.device))
            pooling = native.get("pooling", self.preset.pooling)
            if fam == "bert":
                module = build_module(lambda: BertDenseEmbedder(cfg, pooling=pooling),
                                      self.device, self._seed)
            else:
                hcfg = HybridConfig(bert=cfg, hash_dim=int(native.get("hash_dim", 256)),
                                    hash_seed=int(native.get("hash_seed", 0)), pooling=pooling)
                module = build_module(lambda: HybridDenseEmbedder(hcfg), self.device, self._seed)
        elif fam in ("gemma", "qwen3"):
            from cqs_tpu_torch.models.gemma import GemmaConfig, GemmaEmbedder

            if self.model_path is not None and (self.model_path / "config.json").is_file():
                cfg = GemmaConfig.from_hf_config(self.model_path)
            else:
                # random init at full size is pointless: the test geometry
                cfg = GemmaConfig.small_test(vocab_size=self.tokenizer.vocab_size)
                if fam == "qwen3":
                    cfg = cfg.as_qwen3()
            module = build_module(lambda: GemmaEmbedder(cfg), self.device, self._seed)
        elif fam == "deepseek":
            from cqs_tpu_torch.models.deepseek import DeepseekEmbedder, DeepseekV2Config

            dtype = compute_dtype(self.device)
            if self.model_path is not None and (self.model_path / "config.json").is_file():
                cfg = DeepseekV2Config.from_hf_config(self.model_path, dtype=dtype)
            else:
                # random init at full size is pointless: the test geometry
                cfg = DeepseekV2Config.small_test(vocab_size=self.tokenizer.vocab_size,
                                                  dtype=dtype)
            if self.tokenizer.vocab_size > cfg.vocab_size:
                raise ValueError(f"the tokenizer's {self.tokenizer.vocab_size} ids exceed the "
                                 f"model's vocabulary of {cfg.vocab_size}")
            module = build_module(lambda: DeepseekEmbedder(cfg), self.device, self._seed)
        else:
            raise ValueError(f"unknown model family {fam!r}")
        self._maybe_load_weights(module)
        return module

    def _maybe_load_weights(self, module: torch.nn.Module) -> None:
        """Weights from ``model_path``: a native checkpoint, else a HF one
        (``embedder.py:259-273``); a path with neither raises."""
        if self.model_path is None:
            return
        from cqs_tpu_torch.models.loader import load_native_checkpoint, load_safetensors_params

        template = module.state_dict()
        loaded = load_native_checkpoint(self.model_path, template)
        if loaded is None:
            loaded = load_safetensors_params(self.model_path, template, self.preset.family)
        if loaded is None:
            raise WeightlessModelError(
                f"no loadable safetensors checkpoint found at {self.model_path} "
                f"for preset {self.preset.name!r}")
        with torch.no_grad():
            module.load_state_dict(loaded)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        # one read of the model: a concurrent clear_session cannot pull it
        # from under a forward pass that has started
        model = self._ensure_model()
        ids_t = torch.from_numpy(ids).to(self.device, torch.int64)
        mask_t = torch.from_numpy(mask).to(self.device)
        if isinstance(model, torch.nn.Module):
            kw = {}
            if self.preset.family == "deepseek":
                from cqs_tpu_torch.models.deepseek import real_positions

                # the rows its MLPs take, from the host's mask: no wait on the device
                kw["real"] = real_positions(mask).to(self.device)
            with torch.inference_mode():
                out = model(ids_t, mask_t, **kw).float().cpu().numpy()
            # counts a model kept on the device land with its vectors
            flush = getattr(model, "flush_counters", None)
            if flush is not None:
                flush()
            return out
        m = mask_t.float()[..., None]
        vecs = model[ids_t]                                         # [B, L, D]
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
        with span("embed_texts", n=len(texts)):
            with span("tokenize"):
                encs = [self.tokenizer.encode(prefix + t, self.max_seq_len) for t in texts]
                lengths = [int(e.mask.sum()) for e in encs]
                by_bucket: dict[int, list[int]] = {}
                for i, n in enumerate(lengths):
                    by_bucket.setdefault(pick_bucket(n, self.buckets), []).append(i)
            out = np.zeros((len(texts), self.dim), dtype=np.float32)
            rec = recorder()
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
                        if rec is not None:
                            # a pad row's forced first position is padding
                            rec.count("embed.positions", mask.size)
                            rec.count("embed.real_positions",
                                      sum(min(lengths[i], bucket) for i in batch))
                        with span("forward"):
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

    # -- daemon lifecycle ----------------------------------------------------

    def warm(self) -> None:
        """Embed one short text on the engine's device, so the table or the
        model's weights are resident before the first real query
        (``embedder.py:390``)."""
        self._embed(["warmup"], "")

    def clear_session(self) -> None:
        """Drop the device-resident state (``embedder.py:395``; the daemon's
        idle unload). What is freed: the hash family's ``[vocab, dim]`` f32
        table (32768 x 256 x 4 bytes on the hash tier), or a neural family's
        module with all its parameters (about 300M for EmbeddingGemma). On a
        GPU the blocks also go back from PyTorch's caching allocator to CUDA
        (``torch.cuda.empty_cache``), so other processes on the card can have
        the memory. A forward pass already running keeps its own reference
        until it returns. The next query rebuilds the table from the seed or
        reloads the checkpoint; parameters installed with :meth:`load_params`
        are not kept. The host-side query LRU stays: its vectors do not depend
        on the model being resident."""
        with self._lock:
            self._model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
