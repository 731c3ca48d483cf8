"""Tiered dense index: graph ANN base + brute-force delta.

Port of ``cqs_tpu/index/tiered.py``: new inserts land in an exact-scan
:class:`DenseIndex` (the delta tier, on the same device as the graph), so
indexing stays incremental; the graph tier is rebuilt once the delta reaches
``max(1024, base * rebuild_frac)`` rows. Removals tombstone in whichever tier
holds the row; search merges both tiers by ``(-score, id)``. The files are
the reference's (``.base.npz`` beside ``.delta.npz``), so either package
loads the other's.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.index.dense import DenseIndex
from cqs_tpu_torch.index.graph import GraphIndex
from cqs_tpu_torch.index.stamp import Stamp, StampMismatch


class TieredIndex:
    """Graph base + exact-scan delta with threshold-triggered rebuild."""

    def __init__(self, base: GraphIndex | None, delta: DenseIndex,
                 stamp: Stamp, rebuild_frac: float | None = None, *,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.base = base
        self.delta = delta
        self.stamp = stamp
        self.rebuild_frac = (rebuild_frac if rebuild_frac is not None
                             else default_limits.tiered_rebuild_frac)
        self._removed_base: set[str] = set()
        self._lock = threading.RLock()

    @classmethod
    def build(cls, ids: list[str], matrix: np.ndarray, stamp: Stamp,
              degree: int | None = None, rebuild_frac: float | None = None, *,
              device: str | torch.device) -> "TieredIndex":
        base = (GraphIndex.build(ids, matrix, stamp, degree=degree, device=device)
                if len(ids) else None)
        dim = matrix.shape[1] if matrix.size else stamp.dim
        delta = DenseIndex([], np.zeros((0, dim), np.float32), stamp, device=device)
        return cls(base, delta, stamp, rebuild_frac, device=device)

    @property
    def count(self) -> int:
        base_n = self.base.count if self.base is not None else 0
        return base_n - len(self._removed_base) + self.delta.count

    @property
    def delta_count(self) -> int:
        return self.delta.count

    # -- mutation ----------------------------------------------------------

    def insert(self, new_ids: list[str], vecs: np.ndarray) -> bool:
        """Append to the brute tier; returns True if this insert triggered a
        base rebuild (delta folded in)."""
        if not new_ids:
            return False
        with self._lock:
            self.delta.append(new_ids, vecs)
            base_n = self.base.count if self.base is not None else 0
            threshold = max(1024, int(base_n * self.rebuild_frac))
            if self.delta.count >= threshold:
                self._rebuild()
                return True
            return False

    def remove(self, doomed: set[str]) -> int:
        with self._lock:
            removed = self.delta.remove(doomed)
            if self.base is not None:
                hit = doomed.intersection(self.base.ids)
                if hit:
                    self.base.remove(hit)
                    self._removed_base |= hit
                    removed += len(hit)
            return removed

    def _rebuild(self) -> None:
        """Fold base + delta into a fresh graph tier (tombstones reclaimed)."""
        ids: list[str] = []
        mats: list[np.ndarray] = []
        if self.base is not None:
            keep = [i for i, cid in enumerate(self.base.ids)
                    if cid not in self._removed_base]
            if keep:
                ids.extend(self.base.ids[i] for i in keep)
                mats.append(self.base._host[keep])
        live = self.delta.live_rows()
        if live[0]:
            ids.extend(live[0])
            mats.append(live[1])
        matrix = np.concatenate(mats) if mats else np.zeros((0, self.delta.dim), np.float32)
        self.stamp = Stamp(model_fingerprint=self.stamp.model_fingerprint,
                           dim=self.stamp.dim, chunk_count=len(ids),
                           generation=self.stamp.generation, kind=self.stamp.kind)
        self.base = (GraphIndex.build(ids, matrix, self.stamp, device=self.device)
                     if ids else None)
        self.delta = DenseIndex([], np.zeros((0, self.delta.dim), np.float32), self.stamp,
                                device=self.device)
        self._removed_base = set()

    # -- search ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, list[list[str]]]:
        """Merged top-k across both tiers -> (scores [B, k], ids [B][k])."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = q.shape[0]
        cand_v: list[list[tuple[float, str]]] = [[] for _ in range(B)]
        if self.base is not None and self.base.count:
            bv, br = self.base.search(q, min(k, self.base.count))
            for b in range(B):
                for v, r in zip(bv[b].tolist(), br[b].tolist()):
                    if v <= -1e30 or not (0 <= r < self.base.count):
                        continue
                    cid = self.base.ids[r]
                    if cid and cid not in self._removed_base:
                        cand_v[b].append((v, cid))
        if self.delta.count:
            dv, dr = self.delta.search(q, min(k, self.delta.count))
            dids = self.delta.rows_to_ids(dr)
            for b in range(B):
                for v, cid in zip(dv[b].tolist(), dids[b]):
                    if v > -1e30 and cid:
                        cand_v[b].append((v, cid))
        out_v = np.full((B, k), -np.inf, np.float32)
        out_ids: list[list[str]] = []
        for b in range(B):
            pairs = sorted(cand_v[b], key=lambda p: (-p[0], p[1]))[:k]
            out_ids.append([cid for _, cid in pairs])
            out_v[b, : len(pairs)] = [v for v, _ in pairs]
        return out_v, out_ids

    # -- persistence -------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """Persist both tiers side by side (base may be absent)."""
        path = Path(path)
        if self.base is not None:
            self.base.save(path.with_suffix(".base.npz"))
        self.delta.save(path.with_suffix(".delta.npz"))

    @classmethod
    def load(cls, path: str | Path, expect: Stamp | None = None, *,
             device: str | torch.device) -> "TieredIndex":
        path = Path(path)
        base = None
        base_path = path.with_suffix(".base.npz")
        if base_path.exists():
            base = GraphIndex.load(base_path, expect=None, device=device)
        delta = DenseIndex.load(path.with_suffix(".delta.npz"), expect=None, device=device)
        stamp = base.stamp if base is not None else delta.stamp
        if expect is not None and stamp.model_fingerprint != expect.model_fingerprint:
            raise StampMismatch(f"tiered stamp mismatch in {path}")
        return cls(base, delta, stamp, device=device)
