"""Fine-tuning pair/triplet generation.

Reference analog: ``src/train_data/`` — triplet generation from git history
(commit messages as queries, touched functions as positives, BM25-ranked
hard negatives, checkpointed mining) feeding the offline fine-tuning scripts.

Here the consumers are first-class TPU trainers (``cqs_tpu/parallel/train.py``),
so generation emits (query, positive, negatives) records directly from:
- git history mining: commit subject -> functions changed by that commit
- store mining: NL descriptions -> their own chunks (self-supervised), with
  lexical hard negatives from the FTS index
"""

from __future__ import annotations

import json
import re
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

from cqs_tpu_torch.store import Store


@dataclass
class TrainPair:
    query: str
    positive: str                   # the text to embed (NL or body)
    positive_id: str = ""
    negatives: list[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"query": self.query, "positive": self.positive,
                "positive_id": self.positive_id, "negatives": self.negatives}


_SUBJECT_NOISE = re.compile(
    r"^(merge|revert|bump|wip|fixup|squash)|^\[.*\]$|^v?\d+\.\d+", re.I)


def _git(root: Path, *args: str, timeout: float = 60.0) -> str:
    try:
        out = subprocess.run(["git", "-C", str(root), *args],
                             capture_output=True, text=True, timeout=timeout)
        return out.stdout
    except (subprocess.SubprocessError, OSError):
        return ""


def mine_git_history(root: Path, store: Store, max_commits: int = 500,
                     negatives_per: int = 3) -> list[TrainPair]:
    """Commit subjects as queries; functions overlapping the commit's hunks
    as positives; FTS-adjacent non-touched chunks as hard negatives."""
    log = _git(root, "log", f"--max-count={max_commits}",
               "--pretty=format:%H\t%s")
    pairs: list[TrainPair] = []
    for line in log.splitlines():
        if "\t" not in line:
            continue
        sha, subject = line.split("\t", 1)
        subject = subject.strip()
        if len(subject) < 15 or _SUBJECT_NOISE.search(subject):
            continue
        # files + hunks touched by this commit
        diff = _git(root, "show", "--unified=0", "--pretty=format:", sha)
        from cqs_tpu_torch.analysis.diffs import parse_unified_diff

        touched: list = []
        for hunk in parse_unified_diff(diff)[:20]:
            rows = [r for r in store.iter_chunks(
                "origin = ? AND line_start <= ? AND line_end >= ?",
                (hunk.path, hunk.end, hunk.start))
                if r.chunk_type in ("function", "method")]
            touched.extend(rows)
        if not touched:
            continue
        touched_ids = {r.id for r in touched}
        # hard negatives: lexically close but untouched
        negs = []
        for cid, _score in store.fts_search(subject, limit=negatives_per * 3):
            if cid in touched_ids:
                continue
            row = store.get_chunk(cid)
            if row is not None:
                negs.append(row.nl or row.body[:500])
            if len(negs) >= negatives_per:
                break
        best = max(touched, key=lambda r: r.line_end - r.line_start)
        pairs.append(TrainPair(query=subject, positive=best.nl or best.body[:500],
                               positive_id=best.id, negatives=negs))
    return pairs


def generate_pairs_from_store(store: Store, max_pairs: int = 2000,
                              negatives_per: int = 3,
                              styles: bool = True) -> list[TrainPair]:
    """Self-supervised pairs: query-STYLE variants per chunk -> its NL as the
    positive, FTS-adjacent other chunks as negatives.

    Styles mirror the eval query distribution (identifier lookup, behavioral
    'how does X', type-filtered '<type> <name>', doc-sentence) so the learned
    space sees realistic query surface forms, not just doc prose — the
    reference's training mix does the same via telemetry mining."""
    from cqs_tpu_torch.utils.text import tokenize_identifier

    pairs: list[TrainPair] = []

    def negs_for(query: str, own_id: str) -> list[str]:
        negs = []
        for cid, _ in store.fts_search(query, limit=negatives_per * 3):
            if cid == own_id:
                continue
            other = store.get_chunk(cid)
            if other is not None:
                negs.append(other.nl or other.body[:500])
            if len(negs) >= negatives_per:
                break
        return negs

    def add(query: str, row, with_negs: bool = False) -> None:
        if len(query) < 4 or len(pairs) >= max_pairs:
            return
        pairs.append(TrainPair(
            query=query[:160], positive=row.nl or row.body[:500],
            positive_id=row.id,
            negatives=negs_for(query, row.id) if with_negs else []))

    human = {"function": "function", "method": "method", "struct": "struct",
             "class": "class", "interface": "interface", "enum": "enum"}
    for row in store.iter_chunks(
            "chunk_type IN ('function','method','struct','class','interface',"
            "'enum','section') AND parent_id IS NULL"):
        if len(pairs) >= max_pairs:
            break
        words = " ".join(tokenize_identifier(row.name))
        doc_first = (row.doc or "").split(".")[0].strip()[:120]
        if doc_first and len(doc_first) >= 15:
            add(doc_first, row, with_negs=True)          # doc-sentence query
        if not styles:
            continue
        if words and words != row.name.lower():
            add(row.name, row, with_negs=True)           # identifier lookup
        if doc_first and len(doc_first) >= 15:
            add(f"how does {words or row.name} {doc_first.lower()}", row)
        kind = human.get(row.chunk_type)
        if kind and words:
            add(f"{kind} {words}", row, with_negs=True)  # type-filtered style
        if row.chunk_type == "section" and words:
            add(words, row)
    return pairs


def save_pairs(pairs: list[TrainPair], path: str | Path) -> None:
    with open(path, "w") as f:
        for p in pairs:
            f.write(json.dumps(p.as_dict()) + "\n")


def load_pairs(path: str | Path) -> list[TrainPair]:
    out = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out.append(TrainPair(query=d["query"], positive=d["positive"],
                                 positive_id=d.get("positive_id", ""),
                                 negatives=d.get("negatives", [])))
    return out


def _confusable_negatives(store: Store, row, negatives_per: int = 3) -> list[str]:
    """In-corpus confusables (VERDICT r2: make the task HARDER than lexical
    matching): same-name chunks in other files, same-file siblings, then
    FTS-adjacent fallback. These force the model to separate near-identical
    lexical surfaces by context — in-batch negatives alone teach only topic
    separation (r2 measured 97% in-batch acc with flat eval recall)."""
    negs: list[str] = []
    seen = {row.id}

    def push(r) -> bool:
        if r is None or r.id in seen:
            return False
        seen.add(r.id)
        t = r.nl or r.body[:500]
        if t:
            negs.append(t)
        return len(negs) >= negatives_per

    # same name, different file — the archetypal confusable ("new", "save")
    for r in store.find_by_name(row.name, exact=True):
        if r.origin != row.origin and push(r):
            return negs
    # same-file siblings (adjacent functions share vocabulary, differ in role)
    for r in store.iter_chunks("origin = ? AND parent_id IS NULL", (row.origin,)):
        if push(r):
            return negs
    for cid, _ in store.fts_search(row.name, limit=negatives_per * 3):
        if push(store.get_chunk(cid)):
            return negs
    return negs


def mine_labeled_queries(store: Store, paths: list, exclude_paths: list | None = None,
                         negatives_per: int = 3) -> list[TrainPair]:
    """Supervised pairs from v3-format labeled eval JSONs: real (query ->
    gold chunk) judgments over THIS corpus (the reference ships these as its
    train split, ``evals/queries/v3_train.json``; its own reranker/centroid
    training consumes them the same way). Queries appearing in any
    ``exclude_paths`` file (held-out test/dev splits) are dropped."""
    from cqs_tpu_torch.eval import load_query_set

    held_out: set[str] = set()
    for p in exclude_paths or []:
        held_out |= {q.query for q in load_query_set(p)}
    by_key: dict[tuple[str, str], object] = {}
    rows = store.db.execute(
        "SELECT id FROM chunks WHERE parent_id IS NULL").fetchall()
    pairs: list[TrainPair] = []
    seen_q: set[str] = set()
    for p in paths:
        for q in load_query_set(p):
            if q.gold is None or q.query in held_out or q.query in seen_q:
                continue
            seen_q.add(q.query)
            cand = store.db.execute(
                "SELECT id FROM chunks WHERE origin = ? AND "
                "(name = ? OR name LIKE ? || '#w%') LIMIT 1",
                (q.gold.origin, q.gold.name, q.gold.name)).fetchone()
            if not cand:
                continue
            row = store.get_chunk(cand[0])
            if row is None:
                continue
            if row.parent_id:                      # resolve window -> parent
                row = store.get_chunk(row.parent_id) or row
            pairs.append(TrainPair(
                query=q.query, positive=row.nl or row.body[:500],
                positive_id=row.id,
                negatives=_confusable_negatives(store, row, negatives_per)))
    return pairs


def attach_engine_negatives(engine, pairs: list[TrainPair], per: int = 4,
                            depth: int = 12) -> int:
    """Mine hard negatives from the ENGINE'S OWN top-ranked wrong answers.

    The r2/r3 post-mortem (docs/trained-tier.md): FTS-confusable negatives
    leave the contrastive task easier than serving reality — 97% in-batch
    accuracy, flat eval recall. Here each labeled query runs through the full
    production pipeline (dense + sketch + FTS legs + fusion + boosts) and the
    top non-gold results become that pair's negatives: exactly the documents
    the serving stack confuses with the gold, in serving order. The reference
    mines its reranker negatives the same way — from its own pool files
    (evals/build_pool.py writes ranked non-gold pool rows per query).

    Mutates ``pairs`` in place (prepends engine negatives, keeps existing
    ones as tail fallback). Returns the number of pairs that got at least
    one engine negative."""
    store = engine.store
    got = 0
    for p in pairs:
        gold = store.get_chunk(p.positive_id) if p.positive_id else None
        gold_keys = set()
        if gold is not None:
            gold_keys.add((gold.origin, gold.name.split("#w")[0]))
        try:
            res = engine.search(p.query, limit=depth)
        except Exception:
            continue
        negs: list[str] = []
        for hit in res.hits:
            r = hit.row
            if (r.origin, r.name.split("#w")[0]) in gold_keys:
                continue
            t = r.nl or r.body[:500]
            if t and t != p.positive and t not in negs:
                negs.append(t)
            if len(negs) >= per:
                break
        if negs:
            got += 1
            keep = [n for n in p.negatives if n not in negs]
            p.negatives = negs + keep[: max(0, per + 2 - len(negs))]
    return got


def mine_callgraph_pairs(store: Store, max_pairs: int = 1000,
                         negatives_per: int = 2) -> list[TrainPair]:
    """Cross-file call-graph pairs: the CALLER's doc/NL describes intent; the
    CALLEE implements it. Query tokens need not share surface with the target
    name — exactly the lexical-tier failure mode the trained tier must cover
    (behavioral/conceptual queries)."""
    pairs: list[TrainPair] = []
    rows = store.db.execute(
        "SELECT fc.caller_id, fc.callee_name FROM function_calls fc "
        "LIMIT 20000").fetchall()
    seen: set[tuple[str, str]] = set()
    for caller_id, callee_name in rows:
        if len(pairs) >= max_pairs:
            break
        key = (caller_id, callee_name)
        if key in seen:
            continue
        seen.add(key)
        caller = store.get_chunk(caller_id)
        if caller is None or not caller.doc:
            continue
        doc_first = caller.doc.split(".")[0].strip()
        if len(doc_first) < 20:
            continue
        callees = store.find_by_name(callee_name, exact=True)
        target = next((r for r in callees if r.origin != caller.origin), None)
        if target is None or not (target.nl or target.body):
            continue
        pairs.append(TrainPair(
            query=doc_first[:160], positive=target.nl or target.body[:500],
            positive_id=target.id,
            negatives=_confusable_negatives(store, target, negatives_per)))
    return pairs
