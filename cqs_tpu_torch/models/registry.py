"""Embedding model presets.

Reference analog: the presets macro in ``src/embedder/models.rs:219-789`` —
8 presets with per-model dims, sequence lengths, pooling modes, doc/query
prompt prefixes, and dim/seq-scaled batch sizes. The default is
embeddinggemma-300m (768-d, 2048 seq, prompt prefixes below,
``src/embedder/models.rs:455``).

The ``hash`` preset is first-class here: the deterministic lexical embedder
(TPU-resident random-projection bag-of-words) used for tests and for
environments without model weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelPreset:
    name: str
    family: str                  # gemma | bert | hash
    dim: int
    max_seq_len: int
    pooling: str                 # mean | cls | last_token | model (in-graph)
    doc_prefix: str = ""
    query_prefix: str = ""
    hf_repo: str = ""            # where weights come from when available
    # architecture hints for the bert family
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 30522

    @property
    def lexical_tier(self) -> bool:
        """Presets whose dense leg lives in the hash-word vocabulary (the
        deterministic hash projection AND self-trained cqs models): they get
        the lexical-tier routing — per-category alpha overrides, FTS RRF +
        leg union. Pretrained semantic models use the reference's defaults."""
        return self.family == "hash" or self.name.startswith("cqs-")

    def batch_size(self, seq_len: int) -> int:
        """Dim/seq-scaled device batch size (ref: models.rs:789). Sized for a
        ~16 GB-HBM chip with bf16 activations."""
        budget = 1 << 22            # ~4M token-dim units per batch
        return max(8, min(512, budget // max(1, seq_len) // max(1, self.dim // 256)))


_PRESETS: dict[str, ModelPreset] = {}


def register(p: ModelPreset) -> ModelPreset:
    _PRESETS[p.name] = p
    return p


def get_preset(name: str) -> ModelPreset:
    if name not in _PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name]


def all_presets() -> list[ModelPreset]:
    return list(_PRESETS.values())


register(ModelPreset(
    name="embeddinggemma-300m", family="gemma", dim=768, max_seq_len=2048,
    pooling="model",
    query_prefix="task: search result | query: ",
    doc_prefix="title: none | text: ",
    hf_repo="google/embeddinggemma-300m",
))
register(ModelPreset(
    name="bge-large", family="bert", dim=1024, max_seq_len=512, pooling="cls",
    query_prefix="Represent this sentence for searching relevant passages: ",
    hf_repo="BAAI/bge-large-en-v1.5",
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
))
register(ModelPreset(
    name="bge-base", family="bert", dim=768, max_seq_len=512, pooling="cls",
    query_prefix="Represent this sentence for searching relevant passages: ",
    hf_repo="BAAI/bge-base-en-v1.5",
))
register(ModelPreset(
    name="e5-base", family="bert", dim=768, max_seq_len=512, pooling="mean",
    doc_prefix="passage: ", query_prefix="query: ",
    hf_repo="intfloat/e5-base-v2",
))
register(ModelPreset(
    name="minilm-l6", family="bert", dim=384, max_seq_len=256, pooling="mean",
    hf_repo="sentence-transformers/all-MiniLM-L6-v2",
    hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536,
))
register(ModelPreset(
    name="qwen3-embedding-8b", family="qwen3", dim=4096, max_seq_len=4096,
    pooling="last_token",
    query_prefix="Instruct: Given a code search query, retrieve relevant code "
                 "passages\nQuery: ",
    hf_repo="Qwen/Qwen3-Embedding-8B",
))
register(ModelPreset(
    name="qwen3-embedding-4b", family="qwen3", dim=2560, max_seq_len=4096,
    pooling="last_token",
    query_prefix="Instruct: Given a code search query, retrieve relevant code "
                 "passages\nQuery: ",
    hf_repo="Qwen/Qwen3-Embedding-4B",
))
register(ModelPreset(
    name="bge-large-ft", family="bert", dim=1024, max_seq_len=512, pooling="cls",
    query_prefix="Represent this sentence for searching relevant passages: ",
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
))
register(ModelPreset(
    name="v9-200k", family="bert", dim=768, max_seq_len=512, pooling="mean",
))
register(ModelPreset(
    name="nomic-coderank", family="bert", dim=768, max_seq_len=2048, pooling="mean",
    doc_prefix="search_document: ", query_prefix="search_query: ",
    hf_repo="nomic-ai/CodeRankEmbed",
))
register(ModelPreset(
    name="hash", family="hash", dim=256, max_seq_len=512, pooling="mean",
))
register(ModelPreset(
    # self-trained contrastive BERT over the hash-word vocab (the `train`
    # command's output; geometry comes from the checkpoint's cqs_config.json)
    name="cqs-mini", family="bert", dim=256, max_seq_len=128, pooling="mean",
    hidden_size=256, num_layers=4, num_heads=8, intermediate_size=512,
    vocab_size=32768,
))
register(ModelPreset(
    name="hash-tiny", family="hash", dim=64, max_seq_len=128, pooling="mean",
))
register(ModelPreset(
    # wide-and-deep trained tier: frozen hash leg (256) + learned BERT leg
    # (hidden_size), concat + L2 (models/hybrid.py). Geometry comes from the
    # checkpoint's cqs_config.json; these are the init-time defaults.
    name="cqs-hybrid", family="hybrid", dim=640, max_seq_len=256, pooling="mean",
    hidden_size=384, num_layers=4, num_heads=8, intermediate_size=1536,
    vocab_size=32768,
))

register(ModelPreset(
    # self-trained cross-encoder over the hash-word vocab (train-reranker);
    # geometry from the checkpoint's cqs_config.json
    name="cqs-rerank", family="bert", dim=1, max_seq_len=256, pooling="cls",
    hidden_size=256, num_layers=4, num_heads=8, intermediate_size=1024,
    vocab_size=32768,
))

# SPLADE presets (aux models; ref: naver ensembledistil default)
register(ModelPreset(
    name="splade-distil", family="bert", dim=30522, max_seq_len=256, pooling="model",
    hf_repo="naver/splade-cocondenser-ensembledistil",
))
register(ModelPreset(
    name="splade-hash", family="hash", dim=32768, max_seq_len=512, pooling="model",
))
