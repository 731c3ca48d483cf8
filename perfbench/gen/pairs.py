"""The training-pair generator of the ``train_pairs`` driver: a pool of mined
(query, positive, hard negatives) pairs, as a pair file that ``cmd_train``
loads, and for each step a batch of distinct pairs drawn from it.

Parameters come from the traffic file: ``pool_pairs`` pairs in the pool;
``batch`` pairs a step and ``negatives`` hard negatives a pair;
``query_words`` [lo, hi], uniform; ``doc_words`` {median, sigma, lo, hi}:
positives and negatives are code descriptions whose length in words is
lognormal, clipped; ``identifier_share`` of a description's words are
snake_case identifiers of two words; ``vocabulary`` and ``zipf_s``. Lengths
come from the shape stream, words and the pairs each step draws from the
content stream (``perfbench/textgen.py``).
"""

from __future__ import annotations

import numpy as np

from perfbench.textgen import Words, content_rng, shape_rng


class PairGenerator:
    def __init__(self, traffic: dict, seed: int):
        t = self.t = traffic
        self.seed = seed
        self.words = Words(seed, int(t["vocabulary"]), float(t["zipf_s"]))
        P, K = int(t["pool_pairs"]), int(t["negatives"])
        shape = shape_rng(0)
        qlo, qhi = t["query_words"]
        q_len = shape.integers(qlo, qhi + 1, size=P)
        dw = t["doc_words"]
        d_len = np.exp(shape.normal(np.log(dw["median"]), dw["sigma"], size=(P, K + 1)))
        d_len = np.clip(np.rint(d_len), dw["lo"], dw["hi"]).astype(int)
        rng = content_rng(seed, 0, 2)
        self.queries = [self.words.text(rng, int(n)) for n in q_len]
        self.docs = [[self._description(rng, int(n)) for n in row] for row in d_len]

    def _description(self, rng, n: int) -> str:
        words = self.words.draw(rng, n)
        ident = rng.random(n) < float(self.t["identifier_share"])
        extra = iter(self.words.draw(rng, int(ident.sum())))
        return " ".join(f"{w}_{next(extra)}" if i else w for w, i in zip(words, ident))

    def step(self, i: int) -> tuple[list[str], list[str], list[str]]:
        """Step ``i``'s queries and positives (``batch`` each, distinct
        pairs) and negatives (``batch * negatives``, a pair's in a row)."""
        B = int(self.t["batch"])
        idx = content_rng(self.seed, i, 3).choice(len(self.queries), size=B, replace=False)
        return ([self.queries[k] for k in idx], [self.docs[k][0] for k in idx],
                [n for k in idx for n in self.docs[k][1:]])
