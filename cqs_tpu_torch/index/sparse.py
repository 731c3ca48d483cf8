"""Device-resident sparse index: fixed-width term tensors plus a count-sketch.

Port of ``cqs_tpu/index/sparse.py``. Each document keeps its top-T
``(ids [N_pad, T] int32, w [N_pad, T] f32)`` terms, a bf16 ``sketch
[N_pad, S]`` for the candidate scan and an int32 ``mask``, on an explicit
device. :meth:`SpladeIndex.packed_terms` joins ids and weight bits into one
[N_pad, 2T] int32 tensor for the rescore gather. npz/stamp/checksum formats
are the reference's. :meth:`SpladeIndex.sketch_i8` (int8 sketch of the q8
and sk8 programs) and :meth:`SpladeIndex.sketch_mini` (folded sketch of the
screened program) are derived on the device and never persisted.
:meth:`SpladeIndex.search` is the exact sparse-only top-k.
:meth:`SpladeIndex.host_view` and :meth:`SpladeIndex.host_csr` are the
numpy views of the CPU serving mirror (``search/program.py::
hybrid_query_host``), cached on the identity of the tensors they mirror, so
a mutation (which rebinds them) drops them.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.index.stamp import Stamp, StampMismatch, checksum
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.ops.sparse import build_doc_sketch, query_to_dense, sparse_topk


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SpladeIndex:
    def __init__(self, ids: list[str], doc_ids: np.ndarray, doc_w: np.ndarray,
                 vocab_size: int, stamp: Stamp, *, device: str | torch.device,
                 pad_multiple: int | None = None, sketch_dim: int | None = None):
        if not len(ids) == doc_ids.shape[0] == doc_w.shape[0]:
            raise ValueError("ids, doc_ids and doc_w row counts differ")
        self.device = resolve_device(device)
        self.ids = list(ids)
        self.vocab_size = vocab_size
        self.stamp = stamp
        self.T = int(doc_ids.shape[1]) if doc_ids.size else default_limits.splade_doc_terms
        self.sketch_dim = sketch_dim or default_limits.splade_sketch_dim
        self._pad_multiple = pad_multiple or default_limits.index_pad_multiple
        self._host_ids = np.asarray(doc_ids, dtype=np.int32).reshape(len(ids), self.T)
        self._host_w = np.asarray(doc_w, dtype=np.float32).reshape(len(ids), self.T)
        self._lock = threading.Lock()
        self._ids_digest: str | None = None
        self._packed: tuple[torch.Tensor, torch.Tensor] | None = None
        self._i8_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        self._mini_cache: tuple[torch.Tensor, int, torch.Tensor] | None = None
        self._host_view: tuple | None = None
        self._host_csr: tuple | None = None
        self._upload()

    def _upload(self) -> None:
        n = len(self.ids)
        n_pad = max(self._pad_multiple, _round_up(max(n, 1), self._pad_multiple))
        ids_p = np.zeros((n_pad, self.T), dtype=np.int32)
        w_p = np.zeros((n_pad, self.T), dtype=np.float32)
        sketch_p = np.zeros((n_pad, self.sketch_dim), dtype=np.float32)
        if n:
            ids_p[:n] = self._host_ids
            w_p[:n] = self._host_w
            sketch_p[:n] = build_doc_sketch(self._host_ids, self._host_w, self.sketch_dim)
        mask = np.zeros((n_pad,), dtype=np.int32)
        mask[:n] = 1
        for i, cid in enumerate(self.ids):
            if not cid:
                mask[i] = 0      # tombstones stay masked across save/load
        dev = self.device
        self.doc_ids = torch.from_numpy(ids_p).to(dev)
        self.doc_w = torch.from_numpy(w_p).to(dev)
        # bf16 sketch: candidate selection tolerates the rounding and the
        # scan reads half the bytes
        self.sketch = torch.from_numpy(sketch_p).to(dev, torch.bfloat16)
        self.mask = torch.from_numpy(mask).to(dev)

    def packed_terms(self) -> torch.Tensor:
        """[N_pad, 2T] int32 (ids | f32 weight bits), cached on the identity
        of ``doc_ids`` (mutations rebind it)."""
        from cqs_tpu_torch.search.program import pack_terms

        c = self._packed
        if c is not None and c[0] is self.doc_ids:
            return c[1]
        packed = pack_terms(self.doc_ids, self.doc_w)
        self._packed = (self.doc_ids, packed)
        return packed

    def sketch_i8(self) -> torch.Tensor:
        """[N_pad, S] int8 copy of the sketch (``program.quantize_sketch``),
        cached on the identity of ``sketch`` (appends rebind it)."""
        from cqs_tpu_torch.search.program import quantize_sketch

        c = self._i8_cache
        if c is not None and c[0] is self.sketch:
            return c[1]
        q8 = quantize_sketch(self.sketch)
        self._i8_cache = (self.sketch, q8)
        return q8

    def sketch_mini(self, mini_dim: int) -> torch.Tensor:
        """[N_pad, mini_dim] folded sketch (``program.fold_sketch``), cached
        on the identity of ``sketch`` and the width."""
        from cqs_tpu_torch.search.program import fold_sketch

        c = self._mini_cache
        if c is not None and c[0] is self.sketch and c[1] == mini_dim:
            return c[2]
        mini = fold_sketch(self.sketch, mini_dim)
        self._mini_cache = (self.sketch, mini_dim, mini)
        return mini

    @property
    def count(self) -> int:
        return len(self.ids)

    @property
    def capacity(self) -> int:
        return int(self.doc_ids.shape[0])

    def host_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cached padded (doc_ids i32, doc_w f32, sketch f32) numpy views for
        the CPU serving mirror. The sketch is the exact f32 widening of the
        bf16 sketch, so host candidate scores match the device program's to
        bf16 product precision. Dropped when the tensors are rebound."""
        c = self._host_view
        if c is None or c[0] is not self.doc_ids or c[1] is not self.sketch:
            c = (self.doc_ids, self.sketch, self.doc_ids.cpu().numpy(),
                 self.doc_w.to(torch.float32).cpu().numpy(),
                 self.sketch.to(torch.float32).cpu().numpy())
            self._host_view = c
        return c[2], c[3], c[4]

    def host_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cached CSR inverted index (indptr [V+1] i64, rows [nnz] i32,
        weights [nnz] f32) over the padded row numbering, for the CPU
        serving mirror's exact posting walk: the postings ``term -> (row,
        w)`` of the sparse index's own design, whose candidates are exact
        where the sketch's are estimates. Tombstones are left to the
        caller's validity mask. Dropped when ``doc_ids`` is rebound."""
        c = self._host_csr
        if c is None or c[0] is not self.doc_ids:
            ids = self._host_ids.ravel()
            w = self._host_w.ravel()
            nz = w > 0.0
            ids, w = ids[nz], w[nz]
            rows = np.repeat(np.arange(len(self.ids), dtype=np.int32), self.T)[nz]
            order = np.argsort(ids, kind="stable")
            indptr = np.zeros(self.vocab_size + 1, np.int64)
            np.cumsum(np.bincount(ids, minlength=self.vocab_size), out=indptr[1:])
            c = (self.doc_ids, indptr, rows[order], w[order].astype(np.float32))
            self._host_csr = c
        return c[1], c[2], c[3]

    def search(self, q_ids: np.ndarray, q_w: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One query's sparse terms -> (scores [k], rows [k]), an exact
        top-k on the index's device; a row is -1 where its score is masked
        or not positive (a document sharing no query term is no match)."""
        dev = self.device
        qv = query_to_dense(torch.from_numpy(np.asarray(q_ids, dtype=np.int32)).to(dev),
                            torch.from_numpy(np.asarray(q_w, dtype=np.float32)).to(dev),
                            self.vocab_size)
        mask = self.mask
        if filter_mask is not None:
            fm = np.zeros((self.capacity,), dtype=np.int32)
            fm[: len(filter_mask)] = np.asarray(filter_mask, dtype=np.int32)[: self.capacity]
            mask = mask * torch.from_numpy(fm).to(dev)
        k_eff = min(k, self.capacity)
        vals, rows = sparse_topk(qv, self.doc_ids, self.doc_w, k_eff, mask)
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        rows = np.where(vals > -1e30, rows, -1)
        rows = np.where(vals > 0.0, rows, -1)
        return vals, rows

    @property
    def ids_digest(self) -> str:
        """Digest of the id list, computed under the mutation lock: a reader
        on another thread never caches the digest of a half-mutated list."""
        with self._lock:
            if self._ids_digest is None:
                self._ids_digest = hashlib.blake2b(
                    "|".join(self.ids).encode(), digest_size=16).hexdigest()
            return self._ids_digest

    def append(self, new_ids: list[str], doc_ids: np.ndarray, doc_w: np.ndarray) -> None:
        """Insert into padding headroom (slice copy into new tensors, then
        rebind) or re-upload with fresh padding."""
        if not new_ids:
            return
        with self._lock:
            self._ids_digest = None
            n0 = self.count
            doc_ids = np.asarray(doc_ids, dtype=np.int32).reshape(len(new_ids), self.T)
            doc_w = np.asarray(doc_w, dtype=np.float32).reshape(len(new_ids), self.T)
            self._host_ids = np.concatenate([self._host_ids, doc_ids]) if self._host_ids.size else doc_ids
            self._host_w = np.concatenate([self._host_w, doc_w]) if self._host_w.size else doc_w
            self.ids.extend(new_ids)
            n1 = len(self.ids)
            if n1 <= self.capacity:
                dev = self.device
                ids_t, w_t, sk_t, mask_t = (self.doc_ids.clone(), self.doc_w.clone(),
                                            self.sketch.clone(), self.mask.clone())
                ids_t[n0:n1] = torch.from_numpy(doc_ids).to(dev)
                w_t[n0:n1] = torch.from_numpy(doc_w).to(dev)
                sk = build_doc_sketch(doc_ids, doc_w, self.sketch_dim)
                sk_t[n0:n1] = torch.from_numpy(sk).to(dev, sk_t.dtype)
                mask_t[n0:n1] = 1
                self.doc_ids, self.doc_w, self.sketch, self.mask = ids_t, w_t, sk_t, mask_t
            else:
                self._upload()

    def remove(self, doomed: set[str]) -> int:
        rows = [i for i, cid in enumerate(self.ids) if cid in doomed]
        with self._lock:
            self._ids_digest = None
            if rows:
                mask = self.mask.clone()
                mask[torch.tensor(rows, device=self.device)] = 0
                self.mask = mask
            for r in rows:
                self.ids[r] = ""
        return len(rows)

    # -- persistence (byte-compatible with cqs_tpu) -------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        ck = checksum(np.ascontiguousarray(self._host_ids),
                      np.ascontiguousarray(self._host_w), "|".join(self.ids).encode())
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp, doc_ids=self._host_ids, doc_w=self._host_w,
            ids=np.array(self.ids), vocab=np.array(self.vocab_size),
            stamp=np.array(self.stamp.to_json()), checksum=np.array(ck))
        tmp.rename(path)

    @classmethod
    def load(cls, path: str | Path, expect: Stamp | None = None, *,
             device: str | torch.device) -> "SpladeIndex":
        path = Path(path)
        with np.load(path, allow_pickle=False) as z:
            stamp = Stamp.from_json(str(z["stamp"]))
            ids = [str(x) for x in z["ids"]]
            doc_ids = z["doc_ids"]
            doc_w = z["doc_w"]
            vocab = int(z["vocab"])
            ck = str(z["checksum"])
        if checksum(np.ascontiguousarray(doc_ids), np.ascontiguousarray(doc_w),
                    "|".join(ids).encode()) != ck:
            raise StampMismatch(f"checksum mismatch in {path}")
        if expect is not None and stamp != expect:
            raise StampMismatch(f"stamp mismatch in {path}")
        return cls(ids, doc_ids, doc_w, vocab, stamp, device=device)
