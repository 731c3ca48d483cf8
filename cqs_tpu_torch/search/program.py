"""The hybrid query programs: dense + sketch candidate scans, exact sparse
rescore, min-max + alpha fusion, dedup and the final top-pool.

Port of ``cqs_tpu/search/program.py``. The reference compiles one XLA
program per query batch; PyTorch runs the same steps eagerly on the tensors'
device. Whenever the padded row count holds at least two scan tiles
(:func:`_scan_tile`) the port runs the reference's TPU branch on every
device: the two fused scans go through :func:`~cqs_tpu_torch.ops.topk.scan_topk`
(the CUDA kernels on the card, their plain twins on the CPU). Below two tiles
it runs the reference's exact branch, materialising [B, N] scores with an f32
``matmul``, as the TPU does for small corpora.

The int8 programs (:func:`hybrid_query_batch_q8`, :func:`hybrid_query_batch_sk8`
and the screened B=1 program :func:`hybrid_query_screened`) always scan, as
the reference does; their int8 scans go through the int8 kernels.

:func:`hybrid_query_host` and :func:`dense_query_host` are the reference's
numpy mirror of the programs, which a CPU engine serves through: the legs of
the exact branch (each leg's global top-pool) on host arrays, with the
native ``hostscan`` scans where that library builds.

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


def _gather_dot(matrix: torch.Tensor, rows: torch.Tensor, q_mat: torch.Tensor) -> torch.Tensor:
    """[B, C] exact dense scores of the candidate rows: gather [B, C, D] and
    take the f32 dot with the matrix-dtype query (never a bf16 matmul: its
    output would round to bf16)."""
    return torch.bmm(matrix[rows.long()].float(), q_mat.float().unsqueeze(2)).squeeze(2)


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
    return rows, torch.cat([dv, _gather_dot(matrix, sc, q_mat)], dim=1)


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
    r = rows.long()
    if doc_w is None:
        t2 = doc_ids.shape[1]
        both = doc_ids[r]                                        # [B, C, 2T]
        ids_c = both[..., : t2 // 2]
        w_c = both[..., t2 // 2:].contiguous().view(torch.float32)
    else:
        ids_c = doc_ids[r]
        w_c = doc_w[r].to(torch.float32)
    return _rescore_fuse_gathered(ids_c, w_c, valid_mask[r] > 0, q_ids, q_w, alphas,
                                  rows, d_c, pool, vocab_size)


def _rescore_fuse_gathered(ids_c, w_c, row_valid, q_ids, q_w, alphas, rows, d_c,
                           pool: int, vocab_size: int):
    """:func:`_exact_rescore_fuse` on the candidates' gathered terms:
    ``ids_c`` / ``w_c`` [B, C, T] and ``row_valid`` [B, C] bool (the sharded
    program gathers them from the rows' home shards)."""
    b = rows.shape[0]
    qv = torch.zeros(b * vocab_size, dtype=torch.float32, device=rows.device)
    flat = (torch.arange(b, device=rows.device)[:, None] * vocab_size
            + q_ids.long()).reshape(-1)
    qv.index_put_((flat,), q_w.to(torch.float32).reshape(-1), accumulate=True)
    qv_at = qv.view(b, vocab_size).gather(1, ids_c.reshape(b, -1).long())
    s_exact = (qv_at.view(ids_c.shape) * w_c).sum(dim=-1)        # [B, C]
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


# -- int8 programs -------------------------------------------------------------

def quantize_unit(x: torch.Tensor) -> torch.Tensor:
    """int8 copy of unit-norm rows or queries: round(x * 127) clipped to
    [-127, 127] (``program.py:370``, ``dense.py:104``). ``torch.round``
    rounds half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() * 127.0), -127, 127).to(torch.int8)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """127 / max(x, 1e-6) in f32 as a true division (``127.0 / tensor``
    would take a reciprocal and multiply, one rounding more)."""
    x = torch.maximum(x, torch.tensor(1e-6, dtype=torch.float32, device=x.device))
    return torch.full_like(x, 127.0) / x


def _quantize_query_sketch(q_sk: torch.Tensor) -> torch.Tensor:
    """[B, S] f32 query sketch -> int8 with a per-query scale
    ``127 / max(max|q_sk|, 1e-6)``, multiplied in (``program.py:378-380``)."""
    scale = _div127(q_sk.abs().amax(dim=1, keepdim=True))
    return torch.clamp(torch.round(q_sk * scale), -127, 127).to(torch.int8)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation) of the flattened f32
    ``x``, as the reference computes it: position q * (n - 1), its floor and
    ceiling and the weights w and 1 - w in f32, then low * (1 - w) + high * w,
    which XLA on the CPU contracts, inside ``quantize_sketch``'s jitted
    program, into one fused multiply-add, fma(low, 1 - w, high * w). The fma
    is taken in float64, where the product is exact, and rounded once to
    f32. Sort-based, so it takes any size (``torch.quantile`` refuses
    more than 2^24 elements, which a sample of a capacity just over 1M rows
    exceeds). Returns a 0-d f32 tensor on ``x``'s device."""
    a = torch.sort(x.reshape(-1).float()).values
    n = a.numel()
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - low)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    lo_v = np.float32(a[int(np.clip(low, 0, n - 1))].item())
    hi_v = np.float32(a[int(np.clip(high, 0, n - 1))].item())
    val = np.float32(np.float64(lo_v) * np.float64(w_lo) + np.float64(hi_v * w_hi))
    return torch.tensor(val, dtype=torch.float32, device=a.device)


def quantize_sketch(sketch: torch.Tensor) -> torch.Tensor:
    """[N, S] bf16 count-sketch -> int8 copy for the int8 sketch scan
    (``program.py:465``): one global scale from the 0.9999 quantile of |value|
    over a strided <= 16k-row sample, clipping the heavy tail (clipped buckets
    saturate high, so the rows they dominate stay selected). Quantized in
    row chunks so the f32 widening stays ~0.5 GB at 1M x 1024."""
    n = sketch.shape[0]
    stride = max(1, n // 16384)
    scale = _div127(quantile_linear(sketch[::stride].float().abs(), 0.9999))
    chunk = 131072
    return torch.cat([torch.clamp(torch.round(sketch[i:i + chunk].float() * scale),
                                  -127, 127).to(torch.int8)
                      for i in range(0, n, chunk)])


def _require_tile(n: int, program: str) -> int:
    tile = _scan_tile(n)
    if tile is None:
        raise ValueError(f"{program} needs at least two scan tiles of 1024 or 2048 "
                         f"rows, got {n} rows")
    return tile


def hybrid_query_batch_q8(matrix, dense_i8, doc_ids, doc_w, sketch_i8, valid_mask,
                          q_dense, q_ids, q_w, alphas, pool: int, vocab_size: int,
                          extraction: str = "grouped"):
    """Quantized-candidate batched query (``program.py:338``, knob
    ``scan_q8=1``): both candidate scans stream int8 copies (``dense_i8`` of
    the unit-norm rows, ``sketch_i8`` from :func:`quantize_sketch`) against
    int8 queries, so their values are rescaled and not reused: every dense
    score of the union comes from a row gather and the f32 dot. The dense
    query quantizes from the f32 ``q_dense``, not its bf16 cast. Solo
    serving is B=1 of this, so solo == batched by construction."""
    tile = _require_tile(dense_i8.shape[0], "hybrid_query_batch_q8")
    q_mat = q_dense.to(matrix.dtype)
    _, dc = _fused_candidates(dense_i8, quantize_unit(q_dense), valid_mask, pool,
                              tile_n=tile, extraction=extraction)
    q_sk_i8 = _quantize_query_sketch(_query_sketch(q_ids, q_w, sketch_i8.shape[1]))
    _, sc = _fused_candidates(sketch_i8, q_sk_i8, valid_mask, pool, tile_n=tile,
                              extraction=extraction)
    rows = torch.cat([dc, sc], dim=1)
    return _exact_rescore_fuse(doc_ids, doc_w, valid_mask, q_ids, q_w, alphas, rows,
                               _gather_dot(matrix, rows, q_mat), pool, vocab_size)


def hybrid_query_batch_sk8(matrix, doc_ids, doc_w, sketch_i8, valid_mask, q_dense,
                           q_ids, q_w, alphas, pool: int, vocab_size: int,
                           extraction: str = "grouped"):
    """Sketch-leg-quantized batched query (``program.py:393``, knob
    ``scan_q8=2``): the dense scan stays bf16 and its values are reused as
    the dense half's scores; only the sketch scan, whose values are never
    reused, streams int8, at twice the tile when that tile still divides the
    rows at least twice."""
    n = matrix.shape[0]
    tile = _require_tile(n, "hybrid_query_batch_sk8")
    q_mat = q_dense.to(matrix.dtype)
    dv, dc = _fused_candidates(matrix, q_mat, valid_mask, pool, tile_n=tile,
                               extraction=extraction)
    q_sk_i8 = _quantize_query_sketch(_query_sketch(q_ids, q_w, sketch_i8.shape[1]))
    sk_tile = 2 * tile if (n % (2 * tile) == 0 and n // (2 * tile) >= 2) else tile
    _, sc = _fused_candidates(sketch_i8, q_sk_i8, valid_mask, pool, tile_n=sk_tile,
                              extraction=extraction)
    rows = torch.cat([dc, sc], dim=1)
    d_c = torch.cat([dv, _gather_dot(matrix, sc, q_mat)], dim=1)
    return _exact_rescore_fuse(doc_ids, doc_w, valid_mask, q_ids, q_w, alphas, rows, d_c,
                               pool, vocab_size)


# -- the screened B=1 program -------------------------------------------------

def _screen_tile(n: int, row_bytes: int, pool: int) -> int:
    """Scan tile for the narrow screen arrays (``program.py:92``): the
    largest of 16384..2048 rows that divides N, holds at most 4 MB of rows
    and keeps the per-tile k (~2 * pool * tile / N) at most 16; else 1024."""
    for t in (16384, 8192, 4096, 2048):
        if (n % t == 0 and t * row_bytes <= (4 << 20)
                and -(-2 * pool * t // max(n, 1)) <= 16):
            return t
    return _FUSED_TILE_FALLBACK


def fold_sketch(sketch: torch.Tensor, mini_dim: int) -> torch.Tensor:
    """Fold a [_, S] count-sketch to [_, mini_dim] (mini_dim | S): buckets
    k, m+k, 2m+k, ... sum (in f32) into bucket k, itself a coarser
    count-sketch of the same signed stream (``program.py:501``)."""
    n, s = sketch.shape
    if s % mini_dim:
        raise ValueError(f"sketch width {s} is not a multiple of {mini_dim}")
    return sketch.reshape(n, s // mini_dim, mini_dim).float().sum(dim=1).to(sketch.dtype)


def hybrid_query_screened(matrix, screen, doc_ids, doc_w, sketch_mini, valid_mask,
                          q_dense, q_screen, q_ids, q_w, alphas, pool: int,
                          screen_k: int, vocab_size: int, sketch_fold: int = 8,
                          sparse_mult: int = 4):
    """Two-pass screened query, the B=1 program (``program.py:517``, knob
    ``screen_enable``). Pass 1 scans narrow arrays: the dense screen (int8
    mode: the int8 rows against the int8 query, whose top-pool is the dense
    candidate set; proj mode: a bf16 [N, screen_dim] projection whose
    top-``screen_k`` rows are rescored exactly and cut to the pool) and the
    folded [N, S/fold] mini-sketch, oversampled ``sparse_mult`` times. Pass
    2 is the shared exact tail over the union. ``q_screen`` [B, Sd] is
    ``DenseIndex.project_query`` of the query."""
    b = q_dense.shape[0]
    n = screen.shape[0]
    q_mat = q_dense.to(matrix.dtype)
    if screen.dtype == torch.int8:
        _, dc = _fused_candidates(screen, quantize_unit(q_screen), valid_mask, pool,
                                  tile_n=_screen_tile(n, screen.shape[1], pool))
        dv = _gather_dot(matrix, dc, q_mat)
    else:
        _, sc_rows = _fused_candidates(screen, q_screen.to(screen.dtype), valid_mask,
                                       screen_k,
                                       tile_n=_screen_tile(n, screen.shape[1] * 2, screen_k))
        dv, dsel = stable_topk(_gather_dot(matrix, sc_rows, q_mat), pool)
        dc = sc_rows.gather(1, dsel)
    s_mini = sketch_mini.shape[1]
    q_mini = _query_sketch(q_ids, q_w, s_mini * sketch_fold).reshape(
        b, sketch_fold, s_mini).sum(dim=1).to(sketch_mini.dtype)
    k_sp = pool * sparse_mult
    _, sk_rows = _fused_candidates(sketch_mini, q_mini, valid_mask, k_sp,
                                   tile_n=_screen_tile(n, s_mini * 2, k_sp))
    rows = torch.cat([dc, sk_rows], dim=1)
    d_c = torch.cat([dv, _gather_dot(matrix, sk_rows, q_mat)], dim=1)
    return _exact_rescore_fuse(doc_ids, doc_w, valid_mask, q_ids, q_w, alphas, rows, d_c,
                               pool, vocab_size)


# -- the host mirror (CPU serving) --------------------------------------------
#
# numpy ports of ``program.py:618-830``, line for line: on a CPU engine the
# engine and the batcher serve through these instead of the device programs
# (``SearchEngine.host_mirror``), as the reference does on a CPU backend. A
# CUDA engine never reaches them.

def bf16_round(x):
    """Round a host f32 array through bf16 (the device matrices' storage
    dtype) so host BLAS products equal the device program's bf16 x bf16 ->
    f32 products exactly (a bf16 product has <= 16 mantissa bits: f32-exact).
    Rounds to nearest even, as the reference's ``ml_dtypes`` cast does."""
    x = np.require(x, np.float32, ["C", "W"])          # torch wants writable memory
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _np_topk_rows(scores, k: int):
    """numpy analog of ``lax.top_k`` row selection: descending value, ties
    broken by lower row index. [B, N] -> [B, k] int32 indices."""
    n = scores.shape[1]
    if k >= n:
        sel = np.broadcast_to(np.arange(n, dtype=np.int64), scores.shape).copy()
    else:
        sel = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        sel.sort(axis=1)                      # ascending index among selected
    vals = np.take_along_axis(scores, sel, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")   # ties keep low index
    return np.take_along_axis(sel, order, axis=1)[:, :k].astype(np.int32)


def sparse_scores_csr(indptr, post_rows, post_w, q_ids, q_w, n):
    """Exact sparse scores for ONE query over all n rows via the CSR
    inverted index (``SpladeIndex.host_csr``): walk each query term's
    posting list and accumulate qw * w (f32 products, f64 sums in posting
    order). Returns [n] f32."""
    segs_r, segs_v = [], []
    for t, qw in zip(q_ids.tolist(), q_w.tolist()):
        if qw <= 0.0:
            continue                      # fixed-width padding terms
        a, b = indptr[t], indptr[t + 1]
        if a == b:
            continue
        segs_r.append(post_rows[a:b])
        segs_v.append(post_w[a:b] * np.float32(qw))
    if not segs_r:
        return np.zeros(n, np.float32)
    idx = np.concatenate(segs_r)
    val = np.concatenate(segs_v)
    return np.bincount(idx, weights=val, minlength=n).astype(np.float32)


def hybrid_query_host(matrix, doc_ids, doc_w, sketch, valid_mask,
                      q_dense, q_ids, q_w, alphas, pool: int, vocab_size: int,
                      sketch_candidates: bool = True, csr=None,
                      mat_bf16=None, mat_i8=None):
    """numpy/BLAS mirror of the hybrid program's exact branch for CPU
    serving: the same legs, computed on the host (inputs bf16-rounded as the
    device program's arithmetic; candidate and top-k ties as ``lax.top_k``).

    ``csr`` (the engine's default, knob ``host_sparse_csr``): a
    ``SpladeIndex.host_csr()`` inverted index. The sparse leg then walks
    exact posting lists instead of the [N, S] sketch product, so its
    candidates are exact, not sketch estimates. Downstream (union, s > 0
    validity, min-max, fusion, duplicate mask) is unchanged. ``mat_bf16``
    (``DenseIndex.host_bf16``) runs the dense scan through the native bf16
    kernel; ``mat_i8`` (``DenseIndex.host_i8``, knob ``scan_q8``) makes it
    an int8 selection scan with an exact f32 rescore on the union.

    All array args are host numpy arrays (f32 matrices pre-rounded from the
    bf16 rows); shapes as in :func:`hybrid_query_batch`. Returns numpy
    (fused [B, pool], rows [B, pool], dense [B, pool], sparse [B, pool]).
    """
    from cqs_tpu_torch import native

    NEGF = np.float32(NEG)
    B = q_dense.shape[0]
    n = matrix.shape[0]
    q_mat = q_dense.astype(np.float32)
    invalid = valid_mask <= 0
    d = None
    if mat_i8 is not None and mat_i8.shape[0] == n:
        # q8 dense leg: int8 selection scan (half the bf16 scan's bytes) and
        # an exact f32 rescore on the candidate union below; ``d`` stays None
        q_i8 = np.clip(np.round(q_mat * 127.0), -127, 127).astype(np.int8)
        d_sel = native.i8_matmul_masked(
            mat_i8, q_i8, (~invalid).astype(np.uint8), NEGF)
        if d_sel is None:                   # no native lib: numpy fallback
            d_sel = q_i8.astype(np.float32) @ mat_i8.astype(np.float32).T
            d_sel[:, invalid] = NEGF
        dc = _np_topk_rows(d_sel, pool)
    else:
        if mat_bf16 is not None and mat_bf16.shape[0] == n:
            # native scan over the bf16 storage rows: half the bytes of the
            # f32 widening, one matrix pass for the whole batch, masking
            # folded in; BLAS when the library is unavailable
            d = native.bf16_matmul_masked(
                mat_bf16, q_mat, (~invalid).astype(np.uint8), NEGF)
        if d is None:
            d = q_mat @ matrix.T                            # [B, N] BLAS
            d[:, invalid] = NEGF
        dc = _np_topk_rows(d, pool)
    s_all = None
    if csr is not None:
        indptr, post_rows, post_w = csr
        rows_b = []
        for b in range(B):
            s = native.csr_accumulate(indptr, post_rows, post_w,
                                      np.asarray(q_ids[b]),
                                      np.asarray(q_w[b], np.float32), n)
            if s is None:                   # no native lib: numpy walk
                s = sparse_scores_csr(indptr, post_rows, post_w,
                                      q_ids[b], q_w[b], n)
            rows_b.append(s)
        s_all = np.stack(rows_b)                            # [B, N] exact
    if csr is not None and sketch_candidates:
        s_sel = np.where(invalid[None, :] | (s_all <= 0.0), NEGF, s_all)
        sc = _np_topk_rows(s_sel, pool)
        rows = np.concatenate([dc, sc], axis=1).astype(np.int32)   # [B, 2p]
    elif sketch_candidates:
        S = sketch.shape[1]
        bucket = q_ids % S
        sign = (1.0 - 2.0 * ((q_ids // S) % 2)).astype(np.float32)
        q_sk = np.zeros((B, S), np.float32)
        np.add.at(q_sk, (np.arange(B)[:, None], bucket),
                  sign * q_w.astype(np.float32))
        s_est = bf16_round(q_sk) @ sketch.T
        s_est[:, invalid] = NEGF
        sc = _np_topk_rows(s_est, pool)
        rows = np.concatenate([dc, sc], axis=1).astype(np.int32)   # [B, 2p]
    else:
        rows = dc.astype(np.int32)
    if d is not None:
        d_c = np.take_along_axis(d, rows, axis=1)
    else:
        # q8 leg: exact f32 dense scores on the union rows only (a [2p, D]
        # gather and matvec per query), the products of the full-scan path
        d_c = np.stack([matrix[rows[b]] @ q_mat[b] for b in range(B)])
        d_c[np.take(invalid, rows)] = NEGF

    if s_all is not None:
        s_exact = np.take_along_axis(s_all, rows, axis=1)   # already exact
    else:
        # exact sparse rescore: scatter query terms into a [B, V] vocab
        # vector, gather at the candidates' term ids
        ids_c = doc_ids[rows]                               # [B, P, T]
        w_c = doc_w[rows].astype(np.float32)
        qv = np.zeros((B, vocab_size), np.float32)
        np.add.at(qv, (np.arange(B)[:, None], q_ids), q_w.astype(np.float32))
        P, T = ids_c.shape[1], ids_c.shape[2]
        qv_at = np.take_along_axis(qv, ids_c.reshape(B, P * T), axis=1).reshape(B, P, T)
        s_exact = (qv_at * w_c).sum(axis=-1)                # [B, P]
    row_valid = valid_mask[rows] > 0
    s_exact = np.where(row_valid & (s_exact > 0.0), s_exact, NEGF)
    d_c = np.where(row_valid, d_c, NEGF)

    # min-max normalize the sparse leg over valid entries; invalid lanes
    # clamp to mn first so the full-array arithmetic stays finite
    s_val = s_exact > -1e30
    any_val = s_val.any(axis=1, keepdims=True)
    mx = np.where(s_val, s_exact, NEGF).max(axis=1, keepdims=True)
    mn = np.where(any_val, np.where(s_val, s_exact, -NEGF).min(axis=1, keepdims=True), 0.0)
    rng = np.where(any_val, np.maximum(mx - mn, np.float32(1e-12)), 1.0)
    s_norm = np.where(s_val, (np.where(s_val, s_exact, mn) - mn) / rng, NEGF)

    # alpha fusion with union-of-candidates validity (fuse_alpha)
    a = alphas.astype(np.float32)[:, None]
    d_valid = d_c > NEGF / 2
    s_valid = s_norm > NEGF / 2
    dv = np.where(d_valid, d_c, 0.0)
    sv = np.where(s_valid, s_norm, 0.0)
    fused = np.where(a > 0.0, a * dv + (1.0 - a) * sv, dv + 0.1 * sv)
    fused = np.where(d_valid | s_valid, fused, NEGF).astype(np.float32)

    if sketch_candidates:
        # NEG out duplicate rows, keeping the first occurrence
        srt = np.argsort(rows, axis=1, kind="stable")
        sr = np.take_along_axis(rows, srt, axis=1)
        dup_sorted = np.concatenate(
            [np.zeros((B, 1), bool), sr[:, 1:] == sr[:, :-1]], axis=1)
        dup = np.zeros_like(dup_sorted)
        np.put_along_axis(dup, srt, dup_sorted, axis=1)
        fused = np.where(dup, NEGF, fused)

    sel_order = np.argsort(-fused, axis=1, kind="stable")[:, :pool]
    vals = np.take_along_axis(fused, sel_order, axis=1)
    out_rows = np.take_along_axis(rows, sel_order, axis=1)
    d_at = np.take_along_axis(d_c, sel_order, axis=1)
    s_at = np.take_along_axis(s_exact, sel_order, axis=1)
    return vals, out_rows, d_at, s_at


def dense_query_host(matrix, valid_mask, q_dense, pool: int):
    """numpy/BLAS mirror of :func:`dense_query` (CPU serving).
    ``matrix``/``valid_mask`` from ``DenseIndex.host_view()``; ``q_dense``
    raw f32 [D] (bf16-rounded here). Returns (vals [pool], rows [pool])."""
    d = (bf16_round(q_dense)[None] @ matrix.T)[0]
    d[valid_mask <= 0] = np.float32(NEG)
    rows = _np_topk_rows(d[None], pool)[0]
    return d[rows], rows
