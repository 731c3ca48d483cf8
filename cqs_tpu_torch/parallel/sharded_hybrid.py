"""Multi-device hybrid retrieval: the full dense + sparse query over a
row-sharded index mesh.

Port of ``cqs_tpu/parallel/sharded_hybrid.py``. The matrix, sketch and
doc-term tensors are cut into equal row blocks, one per mesh device; the
query (dense vector + sparse terms) is copied to each. One program,
:func:`sharded_search_legs`, over the N row blocks:

  per-shard dense scan + per-shard sketch scan, each shard's exact top-pool
  per leg on its device (``ops/topk.py::shard_topk``: the split kernels
  ``LOOP_SPLIT`` / ``LOOP_SPLIT_I8`` on the card at pool <= 512, the
  reference's full score vector and one stable top-k on the CPU)
  -> the [N, pool] candidates copied to the mesh's first device and merged
  into the exact global top-pool per leg (``lax.top_k``'s order)
  -> the union's terms (and, in mode 1, exact dense scores) gathered from
  the rows' home shards
  -> exact sparse rescore + fusion + dedup + final top-pool on that device.

Only candidates travel between devices, never score vectors, and nothing
reaches the host before the final [pool] outputs.

Empty slots. Where a leg has fewer valid rows than ``pool`` (a tiny shard, a
code-only ``aux_mask``), the reference's ``lax.top_k`` fills the leg with
masked rows in index order, which the epilogue then scores as invalid. Here a
slot whose scan value is NEG carries row -1 through the epilogue (invalid,
and never a duplicate of a real candidate), and the outputs report such rows
as row 0. So every slot whose fused score is above NEG/2 equals the
reference's, and every returned row indexes the reference's padded layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.ops.sparse import build_doc_sketch, query_sketch
from cqs_tpu_torch.parallel.mesh import Mesh, merge_shard_topk, place_rows, shard_candidates
from cqs_tpu_torch.search.program import (
    _gather_dot, _quantize_query_sketch, _rescore_fuse_gathered, quantize_unit,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Shard(NamedTuple):
    """One row block on its device. ``lo`` is its first global row and
    ``rows`` its row count; the scan tensors (``scan_d``, ``scan_s``,
    ``mask``) hold :func:`~cqs_tpu_torch.ops.topk.shard_scan_rows` rows, the
    padding masked; ``matrix`` is the bf16 dense block (exact dense scores,
    padded like the scans), ``doc_ids`` / ``doc_w`` [rows, T] its terms."""
    lo: int
    rows: int
    matrix: torch.Tensor
    scan_d: torch.Tensor
    scan_s: torch.Tensor
    doc_ids: torch.Tensor
    doc_w: torch.Tensor
    mask: torch.Tensor


def _from_home(shards, rows: torch.Tensor, fn, first: torch.device) -> torch.Tensor:
    """``fn(shard, local rows)`` evaluated for the candidate ``rows`` [B, C]
    on their home shards, assembled on ``first``: each shard answers for
    every row at its clamped local index (no host sync to split the union),
    and a row keeps its home shard's answer."""
    out = None
    for sh in shards:
        local = (rows - sh.lo).clamp(0, sh.rows - 1).to(sh.matrix.device)
        got = fn(sh, local).to(first)
        here = (rows >= sh.lo) & (rows < sh.lo + sh.rows)
        here = here.view(*here.shape, *([1] * (got.dim() - here.dim())))
        out = got if out is None else torch.where(here, got, out)
    return out


def sharded_search_legs(shards, q_dense: torch.Tensor, q_ids: torch.Tensor,
                        q_w: torch.Tensor, alpha: float, pool: int, q8: int,
                        vocab_size: int):
    """One hybrid query over N row blocks (the reference's jitted program,
    ``sharded_hybrid.py:302-368``). ``q_dense`` [D] f32, ``q_ids`` / ``q_w``
    [Qt] on the first shard's device; ``q8`` the placement's mode (0: bf16
    scans; 1: int8 dense and sketch scans; 2: bf16 dense, int8 sketch).
    Returns (fused, rows, dense leg, sparse leg), each [1, pool], on the first
    shard's device (module docstring for the empty slots)."""
    first = shards[0].matrix.device
    n_s = shards[0].rows
    qs = query_sketch(q_ids[None], q_w[None], shards[0].scan_s.shape[1])      # [1, S]
    q_mat = q_dense[None].to(torch.bfloat16)
    # mode 1: int8 dense candidate scan (selection only; exact dense scores
    # are re-derived on the union); modes 0 and 2: the bf16 scan's values
    # are the dense scores
    qd = quantize_unit(q_dense[None]) if q8 == 1 else q_mat
    # modes 1 and 2: the int8 sketch scan, the query sketch quantized with a
    # per-query scale (keeps the rows' order)
    qsk = _quantize_query_sketch(qs) if q8 else qs
    k_s = min(pool, n_s)
    legs = []
    for field, q in (("scan_d", qd), ("scan_s", qsk)):
        parts = [shard_candidates(getattr(sh, field), q.to(sh.matrix.device), k_s, sh.mask,
                                  sh.lo) for sh in shards]
        legs.append(merge_shard_topk(parts, pool, first))
    (dv, dc), (_, sc) = legs
    rows = torch.cat([dc, sc], dim=1)                                          # [1, 2 pool]

    ids_c = _from_home(shards, rows, lambda sh, local: sh.doc_ids[local], first)  # [1, C, T]
    w_c = _from_home(shards, rows, lambda sh, local: sh.doc_w[local], first)

    def dense_dot(sh, local):
        return _gather_dot(sh.matrix, local, q_mat.to(sh.matrix.device))

    if q8 == 1:
        d_c = _from_home(shards, rows, dense_dot, first)
    else:
        d_c = torch.cat([dv, _from_home(shards, sc, dense_dot, first)], dim=1)
    alphas = torch.tensor([alpha], dtype=torch.float32, device=first)
    vals, out_rows, d_at, s_at = _rescore_fuse_gathered(
        ids_c, w_c, rows >= 0, q_ids[None], q_w[None], alphas, rows, d_c, pool, vocab_size)
    return vals, out_rows.clamp(min=0), d_at, s_at


class ShardedHybridIndex:
    """Row-sharded hybrid (dense + SPLADE) index over a 1-D mesh. The
    placed tensors (``matrix``, ``doc_ids``, ``doc_w``, ``sketch``,
    ``sketch_i8``, ``dense_i8``, ``mask``) are tuples of per-shard tensors,
    one on each mesh device."""

    def __init__(self, ids: list[str], matrix: np.ndarray,
                 doc_ids: np.ndarray, doc_w: np.ndarray, vocab_size: int,
                 mesh: Mesh, sketch_dim: int = 1024, q8: int | None = None):
        self.mesh = mesh
        self.ids = list(ids)
        self.vocab_size = vocab_size
        n_shards = mesh.size
        n, d = matrix.shape
        T = doc_ids.shape[1]
        pad = _round_up(max(n, 1), n_shards * 8) - n

        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        full = np.concatenate([matrix / np.maximum(norms, 1e-12),
                               np.zeros((pad, d), np.float32)])
        ids_p = np.concatenate([doc_ids, np.zeros((pad, T), np.int32)])
        w_p = np.concatenate([doc_w, np.zeros((pad, T), np.float32)])
        sketch = build_doc_sketch(ids_p.astype(np.int32), w_p, sketch_dim)
        mask = np.zeros((n + pad,), np.int32)
        mask[:n] = 1

        self.padded = n + pad
        self.rows_per_shard = self.padded // n_shards
        self.matrix = place_rows(torch.from_numpy(full), mesh.devices, torch.bfloat16)
        self.doc_ids = place_rows(torch.from_numpy(ids_p.astype(np.int32)), mesh.devices,
                                  scan=False)
        self.doc_w = place_rows(torch.from_numpy(w_p.astype(np.float32)), mesh.devices,
                                scan=False)
        # mode mirrors the scan_q8 knob: 0 = bf16 scans, 1 = full q8 (both
        # matrices int8), 2 = sketch-only int8 (dense stays bf16, its scan
        # values reused)
        self.q8 = int(default_limits.scan_q8) if q8 is None else int(q8)
        if self.q8:
            self._place_q8(full, sketch)
        else:
            self.sketch = place_rows(torch.from_numpy(sketch), mesh.devices, torch.bfloat16)
            self.sketch_i8 = self.dense_i8 = None
        self.mask = place_rows(torch.from_numpy(mask), mesh.devices)
        self.sketch_dim = sketch_dim
        self._aux_mask_cache = None

    def _place_q8(self, full_f32: np.ndarray, sketch_f32: np.ndarray) -> None:
        """q8 placement: int8 copies of both scan matrices (mode 2: of the
        sketch only), quantized on the host with numpy as the reference does;
        the bf16 sketch never reaches the devices (the exact term rescore
        reads ``doc_ids`` / ``doc_w``)."""
        if self.q8 == 2:
            self.dense_i8 = None
        else:
            d_i8 = np.clip(np.round(full_f32 * 127.0), -127, 127).astype(np.int8)
            self.dense_i8 = place_rows(torch.from_numpy(d_i8), self.mesh.devices)
        # the clip-scale rule of program.quantize_sketch (sampled 99.99th
        # |value| percentile), computed with numpy on a strided row sample
        n = sketch_f32.shape[0]
        sample = np.abs(sketch_f32[::max(1, n // 16384)].astype(np.float32))
        hi = float(np.quantile(sample.reshape(-1), 0.9999)) if sample.size else 1.0
        scale = 127.0 / max(hi, 1e-6)
        sk_i8 = np.clip(np.round(sketch_f32.astype(np.float32) * scale),
                        -127, 127).astype(np.int8)
        self.sketch_i8 = place_rows(torch.from_numpy(sk_i8), self.mesh.devices)
        self.sketch = None

    @classmethod
    def from_row_blocks(cls, ids: list, vocab_size: int, mesh: Mesh,
                        block_fn, n: int, d: int, T: int,
                        sketch_dim: int = 1024, q8: int | None = None
                        ) -> "ShardedHybridIndex":
        """Shard-at-a-time constructor, the large-corpus build path: each
        shard's tensors are built from one ``block_fn(lo, hi)`` call, which
        returns ``(matrix_f32, doc_ids_i32, doc_w_f32)`` for global rows [lo,
        hi) and is never asked past ``n`` (padding zero-fills here). The
        matrix need not be normalized. Host peak: one shard's block. With an
        int8 sketch (``q8`` 1 or 2) the global scale comes first from the
        reference's strided sample (128 reads of up to 128 rows), so every
        shard quantizes on the same scale. Unlike the reference, it calls
        ``block_fn`` once per shard and works on a 1-device mesh."""
        n_shards = mesh.size
        padded = _round_up(max(n, 1), n_shards * 8)
        n_s = padded // n_shards
        mode = int(default_limits.scan_q8) if q8 is None else int(q8)

        sk_scale = None
        if mode:
            n_samples = 128
            rows_per = max(1, 16384 // n_samples)
            step = max(rows_per, n // n_samples)
            samples = []
            for lo in range(0, n, step):
                hi = min(lo + rows_per, n)
                _, ids_b, w_b = block_fn(lo, hi)
                samples.append(np.abs(build_doc_sketch(
                    ids_b.astype(np.int32), w_b.astype(np.float32), sketch_dim)))
            flat = np.concatenate([s.reshape(-1) for s in samples])
            hi_q = float(np.quantile(flat, 0.9999)) if flat.size else 1.0
            sk_scale = 127.0 / max(hi_q, 1e-6)

        self = cls.__new__(cls)
        self.mesh = mesh
        self.ids = list(ids)
        self.vocab_size = vocab_size
        self.sketch_dim = sketch_dim
        self.q8 = mode
        self.padded = padded
        self.rows_per_shard = n_s
        self._aux_mask_cache = None
        placed: dict[str, list] = {k: [] for k in (
            "matrix", "doc_ids", "doc_w", "sketch", "sketch_i8", "dense_i8", "mask")}

        def put(key, a, dev, dtype=None, scan=True):
            placed[key].append(place_rows(torch.from_numpy(a), [dev], dtype, scan)[0])

        for i, dev in enumerate(mesh.devices):
            lo = i * n_s
            take = max(0, min(lo + n_s, n) - lo)
            m = np.zeros((n_s, d), np.float32)
            ids_b = np.zeros((n_s, T), np.int32)
            w_b = np.zeros((n_s, T), np.float32)
            if take:
                m[:take], ids_b[:take], w_b[:take] = block_fn(lo, lo + take)
            norms = np.linalg.norm(m, axis=1, keepdims=True)
            m /= np.maximum(norms, 1e-12)
            sk = build_doc_sketch(ids_b, w_b, sketch_dim)
            put("matrix", m, dev, torch.bfloat16)
            put("doc_ids", ids_b, dev, scan=False)
            put("doc_w", w_b, dev, scan=False)
            if mode:
                put("sketch_i8", np.clip(np.round(sk * sk_scale), -127, 127).astype(np.int8), dev)
                if mode == 1:
                    put("dense_i8", np.clip(np.round(m * 127.0), -127, 127).astype(np.int8), dev)
            else:
                put("sketch", sk, dev, torch.bfloat16)
            put("mask", (np.arange(lo, lo + n_s) < n).astype(np.int32), dev)
            del m, ids_b, w_b, sk
        for k, v in placed.items():
            setattr(self, k, tuple(v) if v else None)
        return self

    @classmethod
    def from_indexes(cls, dense, sparse, mesh: Mesh) -> "ShardedHybridIndex":
        """Shard an engine's live ``DenseIndex`` + ``SpladeIndex`` over the
        mesh without recomputing anything: the padded device tensors are cut
        into row blocks on the mesh's devices (views where a block stays on
        its index's device), so row numbering is unchanged and hydration maps
        through the dense index's own ids. Preconditions: identical id order
        (digest) and a capacity divisible by the shard count."""
        n_shards = mesh.size
        cap = dense.capacity
        if cap % n_shards:
            raise ValueError(f"index capacity {cap} not divisible by {n_shards} shards")
        if sparse.ids_digest != dense.ids_digest or sparse.capacity != cap:
            raise ValueError("dense/sparse indexes are not row-aligned")
        self = cls.__new__(cls)
        self.mesh = mesh
        self.ids = dense.ids               # shared reference (row -> id)
        self.vocab_size = sparse.vocab_size
        self.sketch_dim = sparse.sketch_dim
        self.padded = cap
        self.rows_per_shard = cap // n_shards
        self._aux_mask_cache = None

        devs = mesh.devices
        self.matrix = place_rows(dense.matrix, devs)
        self.doc_ids = place_rows(sparse.doc_ids, devs, scan=False)
        self.doc_w = place_rows(sparse.doc_w, devs, scan=False)
        self.q8 = (int(default_limits.scan_q8)
                   if cap >= default_limits.scan_q8_min_rows else 0)
        if self.q8:
            # the single-device int8 copies, cut into blocks; mode 2 scans the
            # bf16 dense blocks directly (no int8 dense copy)
            self.dense_i8 = place_rows(dense.dense_i8(), devs) if self.q8 != 2 else None
            self.sketch_i8 = place_rows(sparse.sketch_i8(), devs)
            self.sketch = None
        else:
            self.sketch = place_rows(sparse.sketch, devs)
            self.sketch_i8 = self.dense_i8 = None
        # dense validity only (matches the engine's single-device hybrid
        # path: rows with no sparse terms zero-fill and score 0)
        self.mask = place_rows(dense.mask, devs)
        return self

    @property
    def count(self) -> int:
        return len(self.ids)

    def shards(self, masks: tuple[torch.Tensor, ...] | None = None) -> list[Shard]:
        """The row blocks :func:`sharded_search_legs` scans (``masks``
        replaces the index's validity masks)."""
        scan_d = self.dense_i8 if self.q8 == 1 else self.matrix
        scan_s = self.sketch_i8 if self.q8 else self.sketch
        masks = masks or self.mask
        return [Shard(i * self.rows_per_shard, self.rows_per_shard, *parts)
                for i, parts in enumerate(zip(self.matrix, scan_d, scan_s, self.doc_ids,
                                              self.doc_w, masks))]

    def search(self, q_dense: np.ndarray, q_ids: np.ndarray, q_w: np.ndarray,
               alpha: float, pool: int = 100) -> tuple[np.ndarray, np.ndarray]:
        vals, rows, _, _ = self.search_legs(q_dense, q_ids, q_w, alpha, pool)
        return vals, rows

    def search_legs(self, q_dense: np.ndarray, q_ids: np.ndarray, q_w: np.ndarray,
                    alpha: float, pool: int = 100,
                    aux_mask: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``aux_mask``: optional extra [count] validity filter (the engine's
        default code-only mask) ANDed with the index mask; placed on the
        shards and cached by identity, so repeat queries pay no
        re-placement. Returns host (fused, rows, dense leg, sparse leg), each
        [pool]."""
        if not 1 <= pool <= self.padded:
            raise ValueError(f"pool {pool} outside [1, {self.padded}] rows")
        masks = None
        if aux_mask is not None:
            cached = self._aux_mask_cache
            if cached is None or cached[0] is not aux_mask:
                m = np.zeros(self.padded, np.int32)
                m[: len(aux_mask)] = aux_mask
                combined = tuple(a * b for a, b in zip(
                    self.mask, place_rows(torch.from_numpy(m), self.mesh.devices)))
                cached = (aux_mask, combined)
                self._aux_mask_cache = cached
            masks = cached[1]
        first = self.mesh.devices[0]
        out = sharded_search_legs(
            self.shards(masks),
            torch.from_numpy(np.array(q_dense, np.float32)).to(first),
            torch.from_numpy(np.array(q_ids, np.int32)).to(first),
            torch.from_numpy(np.array(q_w, np.float32)).to(first),
            float(alpha), pool, self.q8, self.vocab_size)
        return tuple(x[0].cpu().numpy() for x in out)
