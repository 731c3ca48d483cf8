"""Device-resident dense index: a padded, row-normalized [N_pad, D] matrix
scanned by the fused scan kernel.

Port of ``cqs_tpu/index/dense.py``. Storage is a bf16 ``matrix`` (the
``index_dtype`` knob) and an int32 ``mask`` on an explicit device; rows pad
to ``index_pad_multiple`` for append headroom. Mutations build new tensors
and rebind them, so a reader holding the old tensors (and the caches keyed
on tensor identity) never sees a half-applied update. The npz, stamp and
checksum formats are the reference's, so either package loads the other's
files. Not ported yet: the int8/projection screens (``_build_screen``,
``project_query``) and ``dense_i8``.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

import numpy as np
import torch

from cqs_tpu.config import limits as default_limits
from cqs_tpu.index.stamp import Stamp, StampMismatch, checksum
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.ops.topk import scan_topk, topk_plain


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _normalize_rows(m: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    return (m / np.maximum(norms, 1e-12)).astype(np.float32)


def storage_dtype(name: str | None = None) -> torch.dtype:
    """The ``index_dtype`` knob as a torch dtype (bf16 unless "float32")."""
    name = name or default_limits.index_dtype
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class DenseIndex:
    """Exact-scan dense index over content-addressed chunk ids."""

    def __init__(self, ids: list[str], matrix: np.ndarray, stamp: Stamp, *,
                 device: str | torch.device, pad_multiple: int | None = None,
                 device_dtype: str | None = None):
        if len(ids) != matrix.shape[0]:
            raise ValueError(f"{len(ids)} ids for {matrix.shape[0]} rows")
        self.device = resolve_device(device)
        self.ids: list[str] = list(ids)
        self.stamp = stamp
        self.dim = int(matrix.shape[1]) if matrix.size else stamp.dim
        self._pad_multiple = pad_multiple or default_limits.index_pad_multiple
        self._dtype = storage_dtype(device_dtype)
        self._lock = threading.Lock()
        self._host = (_normalize_rows(matrix) if matrix.size
                      else np.zeros((0, self.dim), np.float32))
        self._ids_digest: str | None = None
        self._row_map: dict[str, int] | None = None
        self._upload()

    # -- device state ------------------------------------------------------

    def _upload(self) -> None:
        n = len(self.ids)
        n_pad = max(self._pad_multiple, _round_up(max(n, 1), self._pad_multiple))
        padded = np.zeros((n_pad, self.dim), dtype=np.float32)
        padded[:n] = self._host
        mask = np.zeros((n_pad,), dtype=np.int32)
        mask[:n] = 1
        # tombstoned rows (id cleared by remove()) stay masked across
        # save/load: persisted through the empty id
        for i, cid in enumerate(self.ids):
            if not cid:
                mask[i] = 0
        matrix = torch.from_numpy(padded).to(device=self.device, dtype=self._dtype)
        self.matrix, self.mask = matrix, torch.from_numpy(mask).to(self.device)

    @property
    def count(self) -> int:
        return len(self.ids)

    @property
    def capacity(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def ids_digest(self) -> str:
        """Digest of the id list: equal digests mean row-aligned indexes."""
        if self._ids_digest is None:
            self._ids_digest = hashlib.blake2b(
                "|".join(self.ids).encode(), digest_size=16).hexdigest()
        return self._ids_digest

    @property
    def row_of(self) -> dict[str, int]:
        """id -> row for this index's numbering (cached)."""
        if self._row_map is None:
            self._row_map = {cid: i for i, cid in enumerate(self.ids) if cid}
        return self._row_map

    def _invalidate_id_caches(self) -> None:
        self._ids_digest = None
        self._row_map = None

    # -- search ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """queries [B, D] (or [D]) -> (scores [B, k], rows [B, k]); row -1
        marks an invalid slot. Runs the loop scan kernel (exact per-tile
        top-k) when the capacity tiles and k <= 128, else the exact plain
        scan."""
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        q = q.to(self.device)
        k_eff = min(k, self.capacity)
        mask = self.mask
        if filter_mask is not None:
            fm = np.zeros((self.capacity,), dtype=np.int32)
            fm[: len(filter_mask)] = np.asarray(filter_mask, dtype=np.int32)[: self.capacity]
            mask = mask * torch.from_numpy(fm).to(self.device)
        tile = default_limits.scan_tile_n
        if self.capacity % tile == 0 and k_eff <= 128:
            vals, rows = scan_topk(self.matrix, q, k_eff, mask, tile_n=tile)
        else:
            vals, rows = topk_plain(self.matrix, q, k_eff, mask)
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        return vals, np.where(vals > -1e30, rows, -1)

    # -- mutation ----------------------------------------------------------

    def append(self, new_ids: list[str], vecs: np.ndarray) -> None:
        """Incremental insert: into padding headroom by slice copy into a new
        tensor (then rebind), or a full re-upload with fresh padding."""
        if not new_ids:
            return
        vecs = _normalize_rows(np.atleast_2d(np.asarray(vecs, dtype=np.float32)))
        with self._lock:
            self._invalidate_id_caches()
            n0 = self.count
            self._host = np.concatenate([self._host, vecs]) if self._host.size else vecs
            self.ids.extend(new_ids)
            n1 = len(self.ids)
            if n1 <= self.capacity:
                matrix = self.matrix.clone()
                matrix[n0:n1] = torch.from_numpy(vecs).to(self.device, self._dtype)
                mask = self.mask.clone()
                mask[n0:n1] = 1
                self.matrix, self.mask = matrix, mask
            else:
                self._upload()
            self.stamp = Stamp(
                model_fingerprint=self.stamp.model_fingerprint, dim=self.stamp.dim,
                chunk_count=n1, generation=self.stamp.generation, kind=self.stamp.kind)

    def remove(self, doomed: set[str]) -> int:
        """Tombstone rows by chunk id (space reclaimed on rebuild)."""
        rows = [i for i, cid in enumerate(self.ids) if cid in doomed]
        if not rows:
            return 0
        with self._lock:
            self._invalidate_id_caches()
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
        mat = self._host.astype(np.float16)
        ck = checksum(np.ascontiguousarray(mat), "|".join(self.ids).encode())
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, matrix=mat, ids=np.array(self.ids),
                            stamp=np.array(self.stamp.to_json()), checksum=np.array(ck))
        tmp.rename(path)

    @classmethod
    def load(cls, path: str | Path, expect: Stamp | None = None, *,
             device: str | torch.device) -> "DenseIndex":
        path = Path(path)
        with np.load(path, allow_pickle=False) as z:
            stamp = Stamp.from_json(str(z["stamp"]))
            ids = [str(x) for x in z["ids"]]
            mat = z["matrix"].astype(np.float32)
            ck = str(z["checksum"])
        if checksum(np.ascontiguousarray(mat.astype(np.float16)), "|".join(ids).encode()) != ck:
            raise StampMismatch(f"checksum mismatch in {path}")
        if expect is not None and stamp != expect:
            raise StampMismatch(f"stamp mismatch in {path}: {stamp} != {expect}")
        return cls(ids, mat, stamp, device=device)
