"""The hybrid query program: dense + sketch candidate scans, exact sparse
rescore, min-max + alpha fusion, dedup and the final top-pool.

Port of ``cqs_tpu/search/program.py``. The reference compiles one XLA
program per query batch; PyTorch runs the same steps eagerly on the tensors'
device. Whenever the padded row count holds at least two scan tiles
(:func:`_scan_tile`) the port runs the reference's TPU branch on every
device: the two fused scans go through :func:`~cqs_tpu_torch.ops.topk.scan_topk`
(the CUDA kernels on the card, their plain twins on the CPU). Below two tiles
it runs the reference's exact branch, materialising [B, N] scores with an f32
``matmul``, as the TPU does for small corpora.

f32 products are taken with TF32 off (``torch.backends.cuda.matmul.allow_tf32
= False`` is set where this module is imported): the bf16 rows and queries
then multiply exactly and only the summation order differs from the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from cqs_tpu_torch.ops.fusion import NEG, fuse_alpha, minmax_normalize, stable_topk
from cqs_tpu_torch.ops.sparse import query_sketch
from cqs_tpu_torch.ops.topk import scan_topk

# f32 products must stay f32 (TF32 keeps ~3 decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False

# Scan geometry: indexes pad to index_pad_multiple (2048 by default), which
# the scan tiles over; indexes built under a 1024 multiple use 1024-row tiles.
_FUSED_TILE = 2048
_FUSED_TILE_FALLBACK = 1024


def _scan_tile(n: int) -> int | None:
    """Largest scan tile dividing the padded row count with at least two
    tiles (None = exact branch)."""
    for t in (_FUSED_TILE, _FUSED_TILE_FALLBACK):
        if n % t == 0 and n // t >= 2:
            return t
    return None


def scan_geometry(n: int, pool: int, tile_n: int | None = None,
                  extraction: str = "loop") -> tuple[int, str]:
    """(per-tile k, extraction actually run) for a scan of ``n`` rows. The
    per-tile k is sized so the union of tiles covers twice the pool
    (``ptk = clamp(ceil(2 * pool / tiles), 4, 64)``); "grouped" turns into
    "loop" past ptk 16, where group collisions would lose too many rows.
    The one place both facts live (the reference keeps a hand-written copy
    in ``effective_extraction``)."""
    tile_n = tile_n or _FUSED_TILE
    num_tiles = max(1, n // tile_n)
    ptk = max(4, min(64, -(-2 * pool // num_tiles)))
    if extraction == "grouped" and ptk > 16:
        extraction = "loop"
    return ptk, extraction


def _fused_candidates(index_arr: torch.Tensor, q: torch.Tensor,
                      valid_mask: torch.Tensor, pool: int,
                      tile_n: int | None = None, extraction: str = "loop"):
    """Candidate (scores, rows) [B, pool] from the fused scan + per-tile
    top-k; the [B, N] scores never reach device memory. The values are the
    exact dot products of the selected rows."""
    tile_n = tile_n or _FUSED_TILE
    ptk, extraction = scan_geometry(index_arr.shape[0], pool, tile_n, extraction)
    return scan_topk(index_arr, q, pool, mask=valid_mask, tile_n=tile_n,
                     per_tile_k=ptk, extraction=extraction)


def _query_sketch(q_ids: torch.Tensor, q_w: torch.Tensor, S: int) -> torch.Tensor:
    """[B, Qt] query terms -> [B, S] signed count-sketch (f32)."""
    return query_sketch(q_ids, q_w, S)


def _scan_candidates(matrix, sketch, valid_mask, q_mat, q_sk, pool: int,
                     tile: int, extraction: str):
    """The reference's TPU branch: (candidate rows [B, C], exact dense
    scores [B, C]). The dense half reuses the scan's values; only the sketch
    half gathers its rows and takes the f32 dot."""
    dv, dc = _fused_candidates(matrix, q_mat, valid_mask, pool, tile_n=tile,
                               extraction=extraction)
    if q_sk is None:
        return dc, dv
    _, sc = _fused_candidates(sketch, q_sk, valid_mask, pool, tile_n=tile,
                              extraction=extraction)
    rows = torch.cat([dc, sc], dim=1)
    # never a bf16 matmul: its output would round to bf16
    d_sketch_half = torch.bmm(matrix[sc.long()].float(),
                              q_mat.float().unsqueeze(2)).squeeze(2)
    return rows, torch.cat([dv, d_sketch_half], dim=1)


def _exact_candidates(matrix, sketch, valid_mask, q_mat, q_sk, pool: int):
    """The reference's exact branch (small corpora): [B, N] f32 scores,
    stable top-pool per leg. Returns (rows [B, C], dense scores [B, C])."""
    d = q_mat.float() @ matrix.float().T
    invalid = valid_mask[None, :] <= 0
    d = d.masked_fill(invalid, NEG)
    _, dc = stable_topk(d, pool)
    if q_sk is None:
        rows = dc
    else:
        s_est = (q_sk.float() @ sketch.float().T).masked_fill(invalid, NEG)
        _, sc = stable_topk(s_est, pool)
        rows = torch.cat([dc, sc], dim=1)
    return rows.to(torch.int32), d.gather(1, rows)


def _hybrid_impl(matrix, doc_ids, doc_w, sketch, valid_mask, q_dense, q_ids, q_w,
                 alphas, pool: int, vocab_size: int = 0,
                 sketch_candidates: bool = True, extraction: str = "loop"):
    """Batched hybrid query (solo is B=1 of this, so solo and batched results
    are equal by construction). ``sketch_candidates=False`` drops the sketch
    candidate leg; the exact sparse rescore and fusion still run."""
    q_mat = q_dense.to(matrix.dtype)
    q_sk = (_query_sketch(q_ids, q_w, sketch.shape[1]).to(sketch.dtype)
            if sketch_candidates else None)
    tile = _scan_tile(matrix.shape[0])
    if tile is not None:
        rows, d_c = _scan_candidates(matrix, sketch, valid_mask, q_mat, q_sk, pool,
                                     tile, extraction)
    else:
        rows, d_c = _exact_candidates(matrix, sketch, valid_mask, q_mat, q_sk, pool)
    return _exact_rescore_fuse(doc_ids, doc_w, valid_mask, q_ids, q_w, alphas,
                               rows.to(torch.int32), d_c, pool, vocab_size)


def _exact_rescore_fuse(doc_ids, doc_w, valid_mask, q_ids, q_w, alphas,
                        rows, d_c, pool: int, vocab_size: int = 0):
    """Shared tail: exact sparse rescore on the candidate union, min-max,
    alpha fusion, dedup (first occurrence wins) and the final top-pool.
    ``rows`` [B, C] candidate rows, ``d_c`` [B, C] exact dense scores.
    ``doc_w=None`` means packed terms: ``doc_ids`` is [N, 2T] int32 with the
    ids in [:, :T] and the f32 weights' bits in [:, T:] (:func:`pack_terms`).
    The rescore is the gather form: query terms scatter into a [B, V] vocab
    vector, gathered at the candidates' term ids."""
    b, c = rows.shape
    r = rows.long()
    if doc_w is None:
        t2 = doc_ids.shape[1]
        both = doc_ids[r]                                        # [B, C, 2T]
        ids_c = both[..., : t2 // 2]
        w_c = both[..., t2 // 2:].contiguous().view(torch.float32)
    else:
        ids_c = doc_ids[r]
        w_c = doc_w[r].to(torch.float32)
    qv = torch.zeros(b * vocab_size, dtype=torch.float32, device=rows.device)
    flat = (torch.arange(b, device=rows.device)[:, None] * vocab_size
            + q_ids.long()).reshape(-1)
    qv.index_put_((flat,), q_w.to(torch.float32).reshape(-1), accumulate=True)
    qv_at = qv.view(b, vocab_size).gather(1, ids_c.reshape(b, -1).long())
    s_exact = (qv_at.view(ids_c.shape) * w_c).sum(dim=-1)        # [B, C]
    row_valid = valid_mask[r] > 0
    neg = torch.full_like(s_exact, NEG)
    s_exact = torch.where(row_valid & (s_exact > 0.0), s_exact, neg)
    d_c = torch.where(row_valid, d_c, neg)

    s_norm = minmax_normalize(s_exact)
    fused = fuse_alpha(d_c, s_norm, alphas[:, None])

    # dedup in sorted row order: a stable sort on rows keeps the candidate
    # position ascending within equal rows, so the first occurrence wins
    sr, perm = torch.sort(rows, dim=1, stable=True)
    sf, sd, ss = fused.gather(1, perm), d_c.gather(1, perm), s_exact.gather(1, perm)
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=rows.device),
                     sr[:, 1:] == sr[:, :-1]], dim=1)
    sf = sf.masked_fill(dup, NEG)

    vals, sel = stable_topk(sf, pool)
    return vals, sr.gather(1, sel), sd.gather(1, sel), ss.gather(1, sel)


def hybrid_query(matrix, doc_ids, doc_w, sketch, valid_mask, q_dense, q_ids, q_w,
                 alpha, pool: int, vocab_size: int,
                 sketch_candidates: bool = True, extraction: str = "loop"):
    """Single-query hybrid retrieval: q_dense [D], q_ids/q_w [Qt], scalar
    alpha. Returns (fused [pool], rows [pool], dense leg [pool], sparse leg
    [pool]) on the arrays' device."""
    alphas = torch.as_tensor(alpha, dtype=torch.float32, device=matrix.device).reshape(1)
    vals, rows, d_at, s_at = _hybrid_impl(
        matrix, doc_ids, doc_w, sketch, valid_mask, q_dense[None], q_ids[None],
        q_w[None], alphas, pool, vocab_size,
        sketch_candidates=sketch_candidates, extraction=extraction)
    return vals[0], rows[0], d_at[0], s_at[0]


def hybrid_query_batch(matrix, doc_ids, doc_w, sketch, valid_mask, q_dense, q_ids,
                       q_w, alphas, pool: int, vocab_size: int,
                       sketch_candidates: bool = True, extraction: str = "loop"):
    """Batched variant (daemon micro-batching): q_dense [B, D], q_ids/q_w
    [B, Qt], alphas [B]. Unfiltered."""
    return _hybrid_impl(matrix, doc_ids, doc_w, sketch, valid_mask, q_dense, q_ids,
                        q_w, alphas, pool, vocab_size,
                        sketch_candidates=sketch_candidates, extraction=extraction)


def dense_query(matrix, valid_mask, q_dense, pool: int):
    """Dense-only program (sparse leg off): exact [N] scores, stable
    top-pool. Returns (vals [pool], rows [pool] int32)."""
    d = (matrix.float() @ q_dense.to(matrix.dtype).float())
    d = d.masked_fill(valid_mask <= 0, NEG)
    vals, rows = stable_topk(d, pool)
    return vals, rows.to(torch.int32)


def pack_terms(doc_ids: torch.Tensor, doc_w: torch.Tensor) -> torch.Tensor:
    """[N, T] int32 ids + [N, T] f32 weights -> one [N, 2T] int32 tensor
    (weights' bits) so the rescore gathers one row per candidate."""
    return torch.cat([doc_ids.to(torch.int32),
                      doc_w.to(torch.float32).contiguous().view(torch.int32)], dim=1)


def trim_query_terms(q_ids, q_w, buckets=(8, 16, 32, 64, 128, 256, 512, 1024)):
    """Trim [B, Qt] query term arrays (host numpy) to the smallest bucket
    covering the batch's largest nonzero count. Real terms sit at the front
    and padding has weight 0, and every consumer is weight-linear, so this
    changes no result."""
    q_w = np.asarray(q_w)
    qt = q_w.shape[1]
    nnz = int((q_w > 0).sum(axis=1).max()) if q_w.size else 1
    for b in buckets:
        if nnz <= b:
            return np.asarray(q_ids)[:, :min(b, qt)], q_w[:, :min(b, qt)]
    return np.asarray(q_ids), q_w
