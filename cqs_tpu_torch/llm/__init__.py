"""LLM enrichment: per-chunk summaries, HyDE queries, doc-comment writing.

Reference analog: ``src/llm/`` — Claude Batches API path (50%-discount batch
endpoint) and an OpenAI-compatible local provider (``src/llm/local.rs``),
feeding the enrichment pass: summaries are PREPENDED to NL before embedding,
HyDE synthetic queries are appended; plus the ``--improve-docs`` staged-patch
doc writer (``src/doc_writer/``) and a prompt-injection validation layer.

Providers are pluggable; network calls go through ``urllib`` (no extra deps)
and every response passes the validation layer before touching the store.
"""

from cqs_tpu_torch.llm.provider import (  # noqa: F401
    AnthropicBatchProvider, LLMProvider, MockProvider, OpenAICompatProvider,
    provider_from_env,
)
from cqs_tpu_torch.llm.summaries import llm_summary_pass, summary_prompt, validate_llm_output  # noqa: F401
