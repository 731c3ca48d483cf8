"""Count-sketch ops for the sparse candidate leg.

Port of the sketch half of ``cqs_tpu/ops/sparse.py`` and of the query sketch
in ``cqs_tpu/search/program.py:156-163``. Every document's fixed-width
(term id, weight) row folds into a signed count-sketch row: bucket
``t mod S``, sign ``+1`` when ``t // S`` is even, ``-1`` when odd. The query
folds the same way, so a sketch dot estimates the sparse dot product and the
candidate scan is a dense [N, S] scan.
"""

from __future__ import annotations

import numpy as np
import torch


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
