"""Sparse scoring and count-sketch ops.

Port of ``cqs_tpu/ops/sparse.py`` and of the query sketch in
``cqs_tpu/search/program.py:156-163``, as torch ops on the inputs' device.

Exact scoring: every document keeps a fixed-width top-T (term id, weight)
row; a query expands to a dense [V] vocab vector (:func:`query_to_dense`)
and a document's score is ``sum_t qv[ids[i, t]] * w[i, t]``, one gather, a
product and a row sum (:func:`sparse_scores`, :func:`sparse_scores_batch`,
:func:`sparse_topk`: ``SpladeIndex.search``).

Count-sketch: every document's row folds into a signed count-sketch row:
bucket ``t mod S``, sign ``+1`` when ``t // S`` is even, ``-1`` when odd.
The query folds the same way, so a sketch dot estimates the sparse dot
product and the candidate scan is a dense [N, S] scan.
"""

from __future__ import annotations

import numpy as np
import torch

from cqs_tpu_torch.ops.fusion import NEG, stable_topk


def query_to_dense(token_ids: torch.Tensor, weights: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """(ids [T], weights [T]) -> dense [V] f32 on the ids' device, by
    scatter-add (a repeated id sums its weights in term order). Zero-weight
    padding adds 0 to its slot."""
    qv = torch.zeros(vocab_size, dtype=torch.float32, device=token_ids.device)
    qv.index_put_((token_ids.long(),), weights.to(torch.float32), accumulate=True)
    return qv


def sparse_scores(qv: torch.Tensor, doc_ids: torch.Tensor, doc_w: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Score all documents against one dense query vector: qv [V], doc_ids
    [N, T], doc_w [N, T] -> [N] f32, NEG where ``mask`` is 0."""
    scores = (qv[doc_ids.long()] * doc_w.to(torch.float32)).sum(dim=1)
    if mask is not None:
        scores = torch.where(mask > 0, scores, torch.full_like(scores, NEG))
    return scores


def sparse_scores_batch(qvs: torch.Tensor, doc_ids: torch.Tensor, doc_w: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        tile_n: int = 65536) -> torch.Tensor:
    """Batched: qvs [B, V] -> [B, N] f32. Tiled over N so the [B, tile, T]
    gather stays bounded."""
    n = doc_ids.shape[0]
    tiles = [(qvs[:, doc_ids[lo:lo + tile_n].long()]
              * doc_w[lo:lo + tile_n].to(torch.float32)[None]).sum(dim=-1)
             for lo in range(0, n, tile_n)]
    scores = tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=1)
    if mask is not None:
        scores = torch.where(mask[None, :] > 0, scores, torch.full_like(scores, NEG))
    return scores


def sparse_topk(qv: torch.Tensor, doc_ids: torch.Tensor, doc_w: torch.Tensor, k: int,
                mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of :func:`sparse_scores`: (values [k], rows [k] int32),
    ties to the lower row, as ``lax.top_k``."""
    vals, rows = stable_topk(sparse_scores(qv, doc_ids, doc_w, mask), k)
    return vals, rows.to(torch.int32)


def sketch_bucket_sign(token_ids, sketch_dim: int):
    """(bucket, sign) of term ids (numpy arrays or tensors)."""
    bucket = token_ids % sketch_dim
    sign = 1.0 - 2.0 * ((token_ids // sketch_dim) % 2)
    return bucket, sign


def build_doc_sketch(doc_ids: np.ndarray, doc_w: np.ndarray, sketch_dim: int) -> np.ndarray:
    """Host-side sketch build: [N, T] sparse terms -> [N, S] f32 (zero-weight
    padding contributes nothing). A flat f64 bincount per row tile, tiled so
    the scratch stays near 512 MB at any N — the reference's own build
    (``cqs_tpu/ops/sparse.py:112``), so both packages store equal sketches."""
    n, _ = doc_ids.shape
    out = np.empty((n, sketch_dim), dtype=np.float32)
    tile = max(1, (64 << 20) // (sketch_dim * 8))
    row_base = np.arange(tile, dtype=np.int64)[:, None] * sketch_dim
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        ids_t = doc_ids[lo:hi]
        bucket = (ids_t % sketch_dim).astype(np.int64)
        sign = 1.0 - 2.0 * ((ids_t // sketch_dim) % 2)
        flat_idx = (row_base[: hi - lo] + bucket).reshape(-1)
        flat_w = (sign * doc_w[lo:hi]).reshape(-1).astype(np.float64)
        counts = np.bincount(flat_idx, weights=flat_w, minlength=(hi - lo) * sketch_dim)
        out[lo:hi] = counts.reshape(hi - lo, sketch_dim).astype(np.float32)
    return out


def query_sketch(q_ids: torch.Tensor, q_w: torch.Tensor, sketch_dim: int) -> torch.Tensor:
    """[B, Qt] query terms -> [B, S] f32 signed count-sketch on the terms'
    device. Colliding terms add in term order, as the reference's
    scatter-add does: ``index_put_`` with ``accumulate=True`` sums duplicate
    indices in their order on the CPU and through a stable sort on CUDA, so
    the f32 sums are deterministic and equal the reference's."""
    b, qt = q_ids.shape
    bucket, sign = sketch_bucket_sign(q_ids.to(torch.int64), sketch_dim)
    flat = (torch.arange(b, device=q_ids.device)[:, None] * sketch_dim + bucket).reshape(-1)
    vals = (sign.to(torch.float32) * q_w.to(torch.float32)).reshape(-1)
    out = torch.zeros(b * sketch_dim, dtype=torch.float32, device=q_ids.device)
    out.index_put_((flat,), vals, accumulate=True)
    return out.view(b, sketch_dim)


def build_doc_sketch_device(doc_ids: torch.Tensor, doc_w: torch.Tensor,
                            sketch_dim: int, tile: int = 8192) -> torch.Tensor:
    """Device-side sketch build: [N, T] -> [N, S] bf16 on the terms' device,
    for term tensors that already live there (a synthetic corpus), without a
    host round trip. Row tiles of ``tile`` rows, each summed in f32 by one
    scatter-add into a [tile, S] buffer, then rounded to bf16."""
    n, t = doc_ids.shape
    out = torch.empty((n, sketch_dim), dtype=torch.bfloat16, device=doc_ids.device)
    for lo in range(0, n, tile):
        ids_t = doc_ids[lo:lo + tile].to(torch.int64)
        rows = ids_t.shape[0]
        bucket, sign = sketch_bucket_sign(ids_t, sketch_dim)
        flat = (torch.arange(rows, device=ids_t.device)[:, None] * sketch_dim
                + bucket).reshape(-1)
        vals = (sign.to(torch.float32) * doc_w[lo:lo + tile].to(torch.float32)).reshape(-1)
        acc = torch.zeros(rows * sketch_dim, dtype=torch.float32, device=ids_t.device)
        acc.index_put_((flat,), vals, accumulate=True)
        out[lo:lo + rows] = acc.view(rows, sketch_dim).to(torch.bfloat16)
    return out


def sketch_query(q_ids: torch.Tensor, q_w: torch.Tensor, sketch_dim: int) -> torch.Tensor:
    """One query's terms [Qt] -> its [S] f32 sketch (:func:`query_sketch` of
    a batch of one)."""
    return query_sketch(q_ids[None], q_w[None], sketch_dim)[0]
