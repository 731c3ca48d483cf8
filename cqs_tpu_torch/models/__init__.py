"""Models: dense embedders (hash, bert, hybrid, gemma, qwen3), the sparse
encoders (splade-hash, SPLADE) and the cross-encoder reranker."""

from cqs_tpu_torch.models.registry import ModelPreset, all_presets, get_preset  # noqa: F401
from cqs_tpu_torch.models.embedder import Embedder, WeightlessModelError  # noqa: F401
from cqs_tpu_torch.models.reranker import CrossEncoderReranker, NoopReranker  # noqa: F401
from cqs_tpu_torch.models.splade import SpladeEncoder  # noqa: F401
