"""Candidate-pool building + dual-judge gold labeling.

Reference analog: the ``evals/`` pool-building and dual-judge scripts
(``v3_all_pool_dryrun.json``, ``calibration_1k_claude/gemma.jsonl``,
``calibration_agreement.json``): run queries through the production path,
collect top-k candidate pools, have TWO LLM judges pick the gold chunk
independently, and keep only agreements (the "dual-judge consensus" behind
the reference's 218-query v3.v2 gate).

Offline environments exercise this with MockProvider; live runs use the
Anthropic Batches / OpenAI-compatible providers from ``cqs_tpu_torch.llm``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from cqs_tpu_torch.llm.provider import LLMProvider, LLMRequest


def build_pools(engine, queries: list[str], k: int = 10) -> list[dict]:
    """Per-query candidate pools through the production search path."""
    pools = []
    for q in queries:
        res = engine.search(q, limit=k)
        pools.append({
            "query": q,
            "category": res.category,
            "candidates": [{
                "idx": i,
                "name": h.row.name.split("#w")[0],
                "origin": h.row.origin,
                "line_start": h.row.line_start,
                "signature": h.row.signature[:200],
                "nl": (h.row.nl or "")[:400],
            } for i, h in enumerate(res.hits)],
        })
    return pools


_JUDGE_PROMPT = """You are labeling a code-search eval. Query:

{query}

Candidates (code chunks from the repository):
{candidates}

Which single candidate best answers the query? Reply with ONLY the number
(0-{max_idx}), or the word NONE if no candidate is a correct answer."""


def _render(pool: dict) -> str:
    lines = []
    for c in pool["candidates"]:
        lines.append(f"[{c['idx']}] {c['origin']}:{c['line_start']} "
                     f"{c['name']} — {c['signature']}")
    return _JUDGE_PROMPT.format(
        query=pool["query"], candidates="\n".join(lines),
        max_idx=len(pool["candidates"]) - 1)


_ANSWER_RE = re.compile(r"\b(\d+|NONE)\b", re.I)


def parse_verdict(text: str, n_candidates: int) -> int | None:
    """First integer (or NONE) in the judge's reply; out-of-range -> None."""
    m = _ANSWER_RE.search(text or "")
    if not m:
        return None
    tok = m.group(1)
    if tok.upper() == "NONE":
        return None
    idx = int(tok)
    return idx if 0 <= idx < n_candidates else None


def judge_pools(pools: list[dict], judges: dict[str, LLMProvider]) -> list[dict]:
    """Run every judge over every pool; attach per-judge verdicts and the
    consensus gold (all judges agree on the same candidate)."""
    for name, provider in judges.items():
        reqs = [LLMRequest(custom_id=str(i), prompt=_render(p))
                for i, p in enumerate(pools) if p["candidates"]]
        replies = provider.complete_batch(reqs)
        for i, p in enumerate(pools):
            verdict = parse_verdict(replies.get(str(i), ""), len(p["candidates"]))
            p.setdefault("judges", {})[name] = verdict
    for p in pools:
        verdicts = set((p.get("judges") or {}).values())
        p["consensus"] = verdicts.pop() if len(verdicts) == 1 else None
    return pools


def pools_to_query_set(pools: list[dict], split: str = "labeled") -> dict:
    """Consensus-labeled pools -> a v3-format query JSON usable by `eval`,
    `sweep`, and `train-data --labeled`."""
    queries = []
    for p in pools:
        gold_idx = p.get("consensus")
        if gold_idx is None:
            continue
        c = p["candidates"][gold_idx]
        queries.append({
            "query": p["query"],
            "category": p.get("category"),
            "source": "dual_judge",
            "gold_chunk": {"name": c["name"], "origin": c["origin"],
                           "line_start": c["line_start"]},
            "judges": {name: {"verified": True,
                              "gold_chunk": {"name": c["name"],
                                             "origin": c["origin"]}}
                       for name in (p.get("judges") or {})},
        })
    return {"schema_version": "v3-consensus", "split": split,
            "n": len(queries), "queries": queries}


def agreement_report(pools: list[dict]) -> dict:
    judged = [p for p in pools if p.get("judges")]
    agree = sum(1 for p in judged if p.get("consensus") is not None)
    return {"pools": len(pools), "judged": len(judged), "consensus": agree,
            "agreement_rate": round(agree / len(judged), 4) if judged else 0.0}
