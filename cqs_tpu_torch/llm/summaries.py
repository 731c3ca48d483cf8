"""LLM summary / HyDE enrichment pass + validation layer.

Reference analog: ``llm_summary_pass`` (``src/llm/mod.rs``) — per-chunk
summaries prepended to NL before embedding, HyDE synthetic queries appended;
plus the prompt-injection validation layer that rejects responses trying to
smuggle instructions, tool syntax, or oversized payloads into the index.
"""

from __future__ import annotations

import re

from cqs_tpu_torch.llm.provider import LLMProvider, LLMRequest
from cqs_tpu_torch.store import Store
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("llm")

SUMMARY_SYSTEM = (
    "You summarize code for a search index. Answer with 1-2 plain sentences "
    "describing what the code does and why it exists. No markdown, no lists, "
    "no instructions, no code.")

HYDE_SYSTEM = (
    "You write search queries. Given code, output 3 short natural-language "
    "queries a developer would type to find it, separated by ' | '. "
    "No markdown, no numbering.")


def summary_prompt(name: str, language: str, signature: str, body: str,
                   max_body: int = 3000) -> str:
    return (f"Language: {language}\nFunction: {name}\nSignature: {signature}\n\n"
            f"Code:\n{body[:max_body]}")


# --- validation layer ------------------------------------------------------

_INJECTION_PATTERNS = re.compile(
    r"(ignore\s+(?:\w+\s+){0,3}instructions|system prompt|<\s*/?(script|tool|function)"
    r"|you are now|disregard|IMPORTANT:|\bcurl\b|\brm -rf\b|http[s]?://)",
    re.I)
_MAX_SUMMARY_CHARS = 600
_MAX_HYDE_CHARS = 400


def validate_llm_output(text: str, max_chars: int = _MAX_SUMMARY_CHARS) -> str | None:
    """Reject prompt-injection-looking or oversized responses; normalize
    whitespace. Returns None when the response is unusable."""
    if not text:
        return None
    text = re.sub(r"\s+", " ", text).strip()
    if len(text) > max_chars:
        text = text[:max_chars]
    if _INJECTION_PATTERNS.search(text):
        return None
    if text.startswith(("#", "```", "-", "*", "1.")):
        text = text.lstrip("#`-*1. ").strip()
    return text or None


def llm_summary_pass(store: Store, provider: LLMProvider, with_hyde: bool = True,
                     batch_size: int = 64, max_chunks: int = 0) -> int:
    """Generate summaries (and HyDE queries) for chunks lacking them.
    Returns the number of chunks enriched. The enrichment pass picks these up
    on the next index run and re-embeds with the summary prepended."""
    existing = set(store.get_summaries())
    todo = [r for r in store.iter_chunks(
        "chunk_type IN ('function','method','class','struct','trait')")
        if r.id not in existing]
    if max_chunks:
        todo = todo[:max_chunks]
    if not todo:
        return 0
    enriched = 0
    for s in range(0, len(todo), batch_size):
        batch = todo[s : s + batch_size]
        reqs = [LLMRequest(custom_id=f"sum:{r.id}", system=SUMMARY_SYSTEM,
                           prompt=summary_prompt(r.qualified_name, r.language,
                                                 r.signature, r.body))
                for r in batch]
        if with_hyde:
            reqs += [LLMRequest(custom_id=f"hyde:{r.id}", system=HYDE_SYSTEM,
                                prompt=summary_prompt(r.qualified_name, r.language,
                                                      r.signature, r.body),
                                max_tokens=150)
                     for r in batch]
        results = provider.complete_batch(reqs)
        for r in batch:
            summary = validate_llm_output(results.get(f"sum:{r.id}", ""))
            hyde = validate_llm_output(results.get(f"hyde:{r.id}", ""), _MAX_HYDE_CHARS)
            if summary or hyde:
                store.put_summary(r.id, summary, hyde, model=provider.name)
                enriched += 1
        log.info("llm summaries: %d/%d", min(s + batch_size, len(todo)), len(todo))
    return enriched
