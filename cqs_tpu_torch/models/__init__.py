"""Models: dense embedders (hash, bert, hybrid, gemma, qwen3, deepseek), the
sparse encoders (splade-hash, SPLADE) and the cross-encoder reranker."""

from cqs_tpu_torch.models.registry import ModelPreset, all_presets, get_preset, register  # noqa: F401
from cqs_tpu_torch.models.embedder import Embedder, WeightlessModelError  # noqa: F401
from cqs_tpu_torch.models.reranker import CrossEncoderReranker, NoopReranker  # noqa: F401
from cqs_tpu_torch.models.splade import SpladeEncoder  # noqa: F401

# The port's own family, which the reference lacks (``models/registry.py``
# stays the reference's copy): a decoder as a code embedder, causal, last
# token, L2 (``models/deepseek.py``); its geometry comes from the
# checkpoint's ``config.json``, its hash tokenizer has the published
# vocabulary.
register(ModelPreset(
    name="deepseek-v2-lite", family="deepseek", dim=2048, max_seq_len=2048,
    pooling="last_token", hf_repo="deepseek-ai/DeepSeek-V2-Lite", vocab_size=102400,
))
