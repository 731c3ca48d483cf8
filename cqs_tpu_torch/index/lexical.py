"""Host inverted index with FTS5-parity BM25 — the warm serving path's
lexical legs without SQLite in the loop.

Reference analog: the reference builds its own in-memory inverted index for
sparse retrieval (``src/splade/index.rs:177``) and leans on SQLite FTS5 for
the lexical legs (``src/search/query.rs:908``). This module replaces the
FTS5 *query* path for the hot legs: SQLite's MATCH walks postings row by row
through the VM (~13-25 ms per leg at 35k chunks on a 1-core host — the
single largest cold-query cost), while the same walk as a numpy slice +
bincount accumulation is ~1 ms.

Parity contract: scores replicate FTS5's bm25() (k1=1.2, b=0.75, idf =
ln((N - df + 0.5) / (df + 0.5)), equal column weights — equal weights let
the per-row columns concatenate into one document, which is exactly how
``fts_search`` calls ``bm25(table)``). The per-posting factor
``idf(t) * tf * (k1+1) / (tf + k1 * (1 - b + b * dl / avgdl))`` is precomputed at
build, so a query is a pure weighted posting walk. ``tests/test_lexical.py``
pins host-vs-SQLite agreement on real stores.

The engine builds one per store coherence token (search/engine.py
``_host_lex``); SQLite remains the source of truth and serves the rare
column-restricted legs (sig_norm) and the NameOnly path.
"""

from __future__ import annotations

import bisect
import math
import re as _re

import numpy as np

K1 = np.float32(1.2)
B = np.float32(0.75)


class _Table:
    """One FTS table's postings: CSR over a term vocabulary."""

    __slots__ = ("terms", "indptr", "post_rows", "post_w", "post_tf", "df",
                 "n_rows", "dl", "avgdl")

    def __init__(self, docs: list[str]):
        """``docs``: per-row normalized text (already ``normalize_for_fts``'d
        and column-concatenated — equal bm25 column weights make the columns
        one document)."""
        n = len(docs)
        self.n_rows = n
        tok_rows = [d.split() for d in docs]
        self.dl = np.array([len(t) for t in tok_rows], np.float32)
        self.avgdl = float(self.dl.mean()) if n else 1.0
        # vocab: sorted unique terms (sorted => prefix queries are ranges)
        vocab: dict[str, int] = {}
        flat_t: list[int] = []
        flat_r: list[int] = []
        for r, toks in enumerate(tok_rows):
            counts: dict[str, int] = {}
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
            for t, c in counts.items():
                tid = vocab.get(t)
                if tid is None:
                    tid = len(vocab)
                    vocab[t] = tid
                flat_t.append(tid)
                flat_r.append(r)
                flat_t.append(c)          # interleave tf to avoid a 3rd list
        self.terms = sorted(vocab)
        remap = np.empty(len(vocab), np.int32)
        for new, term in enumerate(self.terms):
            remap[vocab[term]] = new
        tids = remap[np.asarray(flat_t[0::2], np.int32)]
        tfs = np.asarray(flat_t[1::2], np.float32)
        rows = np.asarray(flat_r, np.int32)
        order = np.argsort(tids, kind="stable")
        tids, tfs, rows = tids[order], tfs[order], rows[order]
        v = len(self.terms)
        self.indptr = np.zeros(v + 1, np.int64)
        np.cumsum(np.bincount(tids, minlength=v), out=self.indptr[1:])
        self.post_rows = rows
        self.post_tf = tfs
        self.df = np.diff(self.indptr).astype(np.int64)
        # precomputed per-posting bm25 contribution (idf folded in)
        norm = tfs * (K1 + 1.0) / (tfs + K1 * (1.0 - B + B * self.dl[rows] / np.float32(self.avgdl)))
        idf = self._idf(self.df.astype(np.float64))
        self.post_w = (norm * idf[tids].astype(np.float32)).astype(np.float32)

    def _idf(self, df):
        n = max(self.n_rows, 1)
        return np.maximum(np.log((n - df + 0.5) / (df + 0.5)), 1e-6)

    # -- term access -------------------------------------------------------

    def term_id(self, term: str) -> int:
        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def term_df(self, term: str) -> int:
        tid = self.term_id(term)
        return int(self.df[tid]) if tid >= 0 else 0

    def prefix_range(self, prefix: str) -> tuple[int, int]:
        lo = bisect.bisect_left(self.terms, prefix)
        hi = bisect.bisect_left(self.terms, prefix + "￿")
        return lo, hi

    # -- scoring -----------------------------------------------------------

    def _phrase_walk(self, member: str):
        """(rows, weights) of one phrase's postings — precomputed weights for
        exact terms; prefix phrases ("stem*") merge their term range and pay
        the normalization live (tf sums across the range first, and df is
        the distinct-row count, exactly FTS5's phrase-prefix semantics)."""
        if member.endswith("*"):
            lo, hi = self.prefix_range(member[:-1])
            if lo == hi:
                return None
            a, b_ = self.indptr[lo], self.indptr[hi]
            rows = self.post_rows[a:b_]
            tfs = self.post_tf[a:b_]
            if hi - lo > 1:
                order = np.argsort(rows, kind="stable")
                rows, tfs = rows[order], tfs[order]
                uniq, start = np.unique(rows, return_index=True)
                tf_sum = np.add.reduceat(tfs, start)
                rows, tfs = uniq, tf_sum.astype(np.float32)
            idf = float(self._idf(np.float64(len(rows))))
            norm = tfs * (K1 + 1.0) / (tfs + K1 * (1.0 - B + B * self.dl[rows] / np.float32(self.avgdl)))
            return rows, (norm * np.float32(idf)).astype(np.float32)
        tid = self.term_id(member)
        if tid < 0:
            return None
        a, b_ = self.indptr[tid], self.indptr[tid + 1]
        return self.post_rows[a:b_], self.post_w[a:b_]

    def score(self, groups: dict[str, list[str]], require_all: bool = False):
        """Accumulated bm25 over the group phrases -> (rows, scores), rows
        restricted to matching docs (OR: any phrase; AND: >=1 phrase of
        EVERY group)."""
        n = self.n_rows
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        acc = np.zeros(n, np.float32)
        matched_any = np.zeros(n, bool)
        and_ok: np.ndarray | None = None
        for _t, members in groups.items():
            g_match = np.zeros(n, bool) if require_all else None
            for m in members:
                walk = self._phrase_walk(m)
                if walk is None:
                    continue
                rows, w = walk
                np.add.at(acc, rows, w)
                matched_any[rows] = True
                if g_match is not None:
                    g_match[rows] = True
            if require_all:
                and_ok = g_match if and_ok is None else (and_ok & g_match)
        ok = and_ok if require_all and and_ok is not None else matched_any
        rows = np.nonzero(ok)[0]
        return rows, acc[rows]


class HostLexicalIndex:
    """The two FTS tables (meta: name+nl+doc; body: sig+body) as host
    inverted indexes, plus the ``fts_search``-mirror query evaluator."""

    def __init__(self, ids: list[str], meta_docs: list[str], body_docs: list[str]):
        self.ids = ids
        self.meta = _Table(meta_docs)
        self.body = _Table(body_docs)

    @classmethod
    def from_store(cls, store) -> "HostLexicalIndex":
        """Build from the store's own FTS content tables — the *_norm text
        the SQLite legs search, so host and SQLite legs see identical
        documents."""
        db = store._read_db()
        metas = {r[0]: (r[1] or "") + " " + (r[2] or "") + " " + (r[3] or "")
                 for r in db.execute(
                     "SELECT id, name_norm, nl_norm, doc_norm FROM chunks_fts")}
        bodys = {r[0]: (r[1] or "") + " " + (r[2] or "")
                 for r in db.execute(
                     "SELECT id, sig_norm, body_norm FROM chunks_fts_body")}
        ids = list(metas)
        return cls(ids, [metas[i] for i in ids],
                   [bodys.get(i, "") for i in ids])

    def search(self, query: str, limit: int = 50,
               synonyms: dict[str, list[str]] | None = None,
               scope: str = "meta", require_all: bool = False,
               stems: str = "zero-df") -> list[tuple[str, float]]:
        """Mirror of ``Store.fts_search`` (same df-filter, synonym OR-groups,
        zero-df stem-prefix expansion, bm25 ranking); returns
        (chunk_id, score) with HIGHER = better, ties broken by row order —
        the same contract the engine's legs consume."""
        from cqs_tpu_torch.search.synonyms import expand_words, stem_prefix
        from cqs_tpu_torch.utils.text import normalize_for_fts

        from cqs_tpu_torch.config import limits as _lim

        table = self.body if scope == "body" else self.meta
        all_terms = terms = [t for t in normalize_for_fts(query).split() if t]
        if not terms:
            return []
        cutoff = max(200, int(_lim.fts_df_cutoff * max(table.n_rows, 1)))
        if not require_all:
            dfs = {t: table.term_df(t) for t in terms}
            keep = {t for t in terms if dfs.get(t, 0) <= cutoff}
            if not keep:
                by_df = sorted(terms, key=lambda t: dfs.get(t, 0))
                keep = set(by_df[:3])
            terms = [t for t in terms if t in keep]
        groups = expand_words(terms, overlay=synonyms)
        if stems != "off":
            # fts_stem_df_max widens the zero-df rescue to near-zero df
            # (mirrors Store.fts_search — 'watcher' occurs in prose while
            # watch_* holds the gold)
            stem_df_max = _lim.fts_stem_df_max if stems == "zero-df" else 0
            for t, g in groups.items():
                if stems == "all" or table.term_df(t) <= stem_df_max:
                    sp = stem_prefix(t)
                    if sp is not None:
                        g.append(sp + "*")
        # abbreviation rescue (fts_abbrev) — mirrors Store.fts_search:
        # a spelled-out query term ORs its identifier abbreviation in when
        # that token exists ('statistics' -> stats)
        if _lim.fts_abbrev and not require_all:
            from cqs_tpu_torch.search.scoring import reverse_abbrev

            rev = reverse_abbrev()
            for t, g in groups.items():
                for a in rev.get(t, ()):
                    if 0 < table.term_df(a) <= cutoff and a not in g:
                        g.append(a)
        # acronym rescue — mirrors Store.fts_search (same pre-filter term
        # sequence, same df>0 pure-rescue gate)
        if _lim.fts_acronym and not require_all:
            from cqs_tpu_torch.search.synonyms import acronyms

            for first, acrs in acronyms(all_terms).items():
                g = groups.get(first)
                if g is None:
                    continue
                for a in acrs:
                    if 0 < table.term_df(a) <= cutoff and a not in g:
                        g.append(a)
        rows, scores = table.score(groups, require_all=require_all)
        if not len(rows):
            return []
        # deterministic ordering: (-score, row). SQLite's tie order among
        # equal bm25 is arbitrary; ours is stable ascending-row (boundary
        # ties beyond the +64 partition margin stay partition-arbitrary but
        # deterministic for fixed input).
        if limit + 64 < len(rows):
            sel = np.argpartition(-scores, limit + 63)[: limit + 64]
        else:
            sel = np.arange(len(rows))
        order = np.lexsort((rows[sel], -scores[sel]))
        sel = sel[order][:limit]
        return [(self.ids[rows[i]], float(scores[i])) for i in sel]


_SIG_PUNCT = _re.compile(r"[^0-9A-Za-z_]+")


def sig_doc(signature: str) -> str:
    """Signature -> the token document the SignatureIndex scores.

    ``normalize_for_fts`` deletes punctuation WITHOUT splitting on it
    ("Result<usize" -> the single token "resultusize"), which preserves
    adjacency but makes the plain "result" unreachable. Signatures are
    punctuation-dense, so the index folds BOTH streams into one document:
    the identifier-joined normalization (adjacency evidence: "vecstring")
    plus the punctuation-split one ("vec string" as separate tokens)."""
    from cqs_tpu_torch.utils.text import normalize_for_fts

    return (normalize_for_fts(signature) + " "
            + normalize_for_fts(_SIG_PUNCT.sub(" ", signature)))


class SignatureIndex:
    """Scored signature-predicate leg for structural / type-filtered queries.

    The strict FTS AND over ``sig_norm`` (the r3 design) went dark on most of
    the v4 structural pool: measured over its 324 R@5 misses, 203 queries
    AND-matched ZERO signatures (one NL predicate word like "slice" or
    "anonymous" that never tokenizes into a signature kills the whole leg),
    53 fell below the 2-token floor ("functions with a CommandContext
    parameter" is one precious token), and 17 exceeded the selectivity cap.

    This replaces the boolean AND with idf-weighted SLOT COVERAGE over every
    code signature: each content word of the query is a slot of acceptable
    signature tokens (identifier-joined form + type synonyms + singular), a
    slot with zero corpus df is DROPPED instead of zeroing the leg, and rows
    rank by (weighted coverage, then signature brevity — the short exact
    ``async def f(x) -> str`` the query describes beats a 40-token signature
    that matches incidentally). Scoring is a few posting-slice unions over
    the ``_Table`` CSR — sub-ms at 35k signatures.

    Reference analog: the structural matchers in
    ``/root/reference/src/structural.rs`` (``matches_async`` / return-type /
    param patterns) — generalized to one scored retrieval leg instead of
    per-pattern booleans.
    """

    def __init__(self, ids: list[str], sig_docs: list[str]):
        self.ids = ids
        self.table = _Table(sig_docs)

    @classmethod
    def from_store(cls, store) -> "SignatureIndex":
        """Logical (non-window) CODE chunks with a signature — the same
        competitor set the default code-only search ranks."""
        from cqs_tpu_torch.parser.types import NON_CODE_TYPES

        non_code = {getattr(t, "value", t) for t in NON_CODE_TYPES}
        ids: list[str] = []
        docs: list[str] = []
        for cid, ctype, sig in store._read_db().execute(
                "SELECT id, chunk_type, signature FROM chunks "
                "WHERE parent_id IS NULL AND signature != ''"):
            if ctype in non_code:
                continue
            ids.append(cid)
            docs.append(sig_doc(sig))
        return cls(ids, docs)

    def query(self, slots: list[list[str]], limit: int = 100,
              min_cover: float = 0.6) -> tuple[list[tuple[str, float]], int, int]:
        """Rank signatures by slot coverage.

        ``slots``: one list of alternative tokens per query predicate word.
        Returns ``(rows, full_matches, dropped_slots)`` where rows are
        ``(chunk_id, coverage)`` sorted by (coverage desc, sig length asc),
        coverage >= ``min_cover`` only; ``full_matches`` counts rows matching
        EVERY live slot (the strict-AND head a selective boost may trust) and
        ``dropped_slots`` how many predicate words were unmatchable corpus-wide
        (a dropped slot means "full" is weaker than the query's own AND)."""
        t = self.table
        n = t.n_rows
        if n == 0 or not slots:
            return [], 0, 0
        acc = np.zeros(n, np.float32)
        full = np.ones(n, bool)
        total_idf = 0.0
        dropped = 0
        live = 0
        for alts in slots:
            rows_u: list[np.ndarray] = []
            for m in alts:
                tid = t.term_id(m)
                if tid >= 0:
                    a, b_ = t.indptr[tid], t.indptr[tid + 1]
                    rows_u.append(t.post_rows[a:b_])
            if not rows_u:
                dropped += 1
                continue
            live += 1
            # postings rows are unique per term; the multi-alt union dedups
            rows = rows_u[0] if len(rows_u) == 1 else np.unique(
                np.concatenate(rows_u))
            idf = max(float(np.log((n + 1.0) / (len(rows) + 1.0))), 1e-3)
            total_idf += idf
            hit = np.zeros(n, bool)
            hit[rows] = True
            acc[hit] += np.float32(idf)
            full &= hit
        if live == 0 or total_idf <= 0.0:
            return [], 0, dropped
        cover = acc / np.float32(total_idf)
        ok = np.nonzero(cover >= min_cover)[0]
        if not len(ok):
            return [], 0, dropped
        n_full = int(full.sum())
        # (coverage desc, signature length asc, row asc) — deterministic
        order = np.lexsort((ok, t.dl[ok], -cover[ok]))
        sel = ok[order][:limit]
        return ([(self.ids[i], float(cover[i])) for i in sel], n_full, dropped)
