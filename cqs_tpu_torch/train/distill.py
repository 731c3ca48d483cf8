"""Teacher-label generation + batching for fused-ordering distillation.

VERDICT r3 item 1: the last uncosted neural lever — teacher = the FULL
production pipeline (hybrid device program + FTS legs + boosts + rescue,
the thing that scores 66.5% aggregate), student = a dense dual encoder
trained to reproduce the teacher's candidate ordering. The r3 campaign
measured every 1-gold contrastive recipe into a dead end
(docs/trained-tier.md); the distillation signal differs in kind: ~K soft
scores per query in serving order, not one binary label.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np


def generate_teacher_labels(engine, queries, k: int = 32,
                            out_path: str | Path | None = None,
                            progress=None) -> list[dict]:
    """Run each query through the production engine; record the top-k final
    ordering as (chunk_id, final_score) soft labels. ``queries`` is a list
    of EvalQuery (gold optional — the teacher score IS the label)."""
    labels: list[dict] = []
    for i, q in enumerate(queries):
        try:
            res = engine.search(q.query, limit=k)
        except Exception:
            continue
        if not res.hits:
            continue
        labels.append({
            "query": q.query,
            "category": getattr(q, "category", None),
            "candidates": [[h.row.id, round(float(h.score), 6)]
                           for h in res.hits],
        })
        if progress and (i + 1) % 50 == 0:
            progress(i + 1, len(queries))
    if out_path:
        with open(out_path, "w") as f:
            for row in labels:
                f.write(json.dumps(row) + "\n")
    return labels


def load_teacher_labels(path: str | Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class DistillBatcher:
    """Tokenized (query, K candidates, teacher scores) batches.

    Doc text = the chunk's NL (the same text the production tier embeds);
    tokenized once and cached. Candidates pad to K with valid=0.
    """

    def __init__(self, store, labels: list[dict], tokenizer, seq_len: int,
                 k: int = 16, query_prefix: str = "q: ",
                 doc_prefix: str = "d: ", seed: int = 0):
        self.store = store
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.k = k
        self.qp, self.dp = query_prefix, doc_prefix
        self.rng = random.Random(seed)
        self.labels = [l for l in labels if len(l["candidates"]) >= 2]
        # resolve + cache candidate doc tokens lazily
        self._doc_tok: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._nl: dict[str, str] = {}

    def _doc(self, cid: str) -> tuple[np.ndarray, np.ndarray] | None:
        if cid in self._doc_tok:       # None entries cache missing chunks too
            return self._doc_tok[cid]
        nl = self._nl.get(cid)
        if nl is None:
            rows = self.store.get_chunks_by_ids([cid])
            if not rows:
                self._doc_tok[cid] = None
                return None
            nl = rows[0].nl or rows[0].name
            self._nl[cid] = nl
        enc = self.tokenizer.encode(self.dp + nl, self.seq_len)
        self._doc_tok[cid] = (enc.ids, enc.mask)
        return self._doc_tok[cid]

    def batch(self, batch_size: int):
        """One randomly sampled batch:
        (q_ids, q_mask [B,L], d_ids, d_mask [B,K,L], t_scores, valid [B,K])."""
        L, K = self.seq_len, self.k
        rows = self.rng.sample(self.labels, min(batch_size, len(self.labels)))
        B = len(rows)
        q_ids = np.zeros((B, L), np.int32)
        q_mask = np.zeros((B, L), np.int32)
        d_ids = np.zeros((B, K, L), np.int32)
        d_mask = np.zeros((B, K, L), np.int32)
        # padded candidate lanes still pass through the encoder: an all-zero
        # attention mask makes mean-pooling divide by zero -> nan forward ->
        # nan vjp through the loss mask (0 * nan = nan) — the first TPU run
        # diverged by step 25 from exactly this. One live pad token keeps
        # the forward finite; the loss mask (valid=0) removes the lane.
        d_mask[:, :, 0] = 1
        t_scores = np.full((B, K), -1e30, np.float32)
        valid = np.zeros((B, K), np.int32)
        for b, row in enumerate(rows):
            enc = self.tokenizer.encode(self.qp + row["query"], L)
            q_ids[b], q_mask[b] = enc.ids, enc.mask
            j = 0
            for cid, score in row["candidates"]:
                if j >= K:
                    break
                tok = self._doc(cid)
                if tok is None:
                    continue
                d_ids[b, j], d_mask[b, j] = tok
                t_scores[b, j] = score
                valid[b, j] = 1
                j += 1
        return q_ids, q_mask, d_ids, d_mask, t_scores, valid
